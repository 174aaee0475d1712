"""T5-style encoder-decoder (the prompted baseline).

Counterpart of ``retrieval_augmented_mds_tpu/models/t5.py`` (the
reference's ``t5-large`` fine-tune, sotasum/t5_lightning.py:48-232, with
"summarize: "-prefixed sources and `_shift_right` decoder inputs). T5
differs from the BART family everywhere it counts: RMSNorm pre-LN blocks,
no position embeddings (a bucketed relative position bias, one ``[32, nh]``
table per stack, shared by its layers), unscaled attention logits, bias-free
linears, a ReLU FFN, and a d_model^-0.5 rescale before the tied LM head.

The JAX file reaches no Pallas kernel, so its attention is plain PyTorch
here on every device, as it is plain XLA there. The baselines run in f32.
The relative position buckets are computed once per device and direction
on the CPU (`relative_position_bucket` truncates an f32 log, so one log
rounded otherwise would move a bucket at its edge), as a lookup over every
offset up to the distance where they saturate, which `_pos_bias` indexes
on the parameters' device: no call copies from the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import Seq2SeqConfig
from .core import (
    NEG_INF,
    Embedding,
    _merge_heads,
    _split_heads,
    build_module,
    cache_write,
    causal_mask,
    embed,
    make_cache,
)

N_BUCKETS = 32
MAX_DISTANCE = 128


class Linear(nn.Module):
    """A bias-free linear: ``kernel`` [d_in, d_out] only."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d))


class T5Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Linear(d, d) for _ in range(4))


class T5FFN(nn.Module):
    def __init__(self, d: int, d_ffn: int):
        super().__init__()
        self.wi = Linear(d, d_ffn)
        self.wo = Linear(d_ffn, d)


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.attn = T5Attention(cfg.d_model)
        self.attn_ln = RMSNorm(cfg.d_model)
        self.ffn = T5FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = RMSNorm(cfg.d_model)


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.self_attn = T5Attention(cfg.d_model)
        self.self_ln = RMSNorm(cfg.d_model)
        self.cross_attn = T5Attention(cfg.d_model)
        self.cross_ln = RMSNorm(cfg.d_model)
        self.ffn = T5FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = RMSNorm(cfg.d_model)


class T5(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.shared_emb = Embedding(cfg.vocab_size, cfg.d_model)
        self.enc_rel_bias = nn.Parameter(torch.empty(N_BUCKETS, cfg.n_heads))
        self.dec_rel_bias = nn.Parameter(torch.empty(N_BUCKETS, cfg.n_heads))
        self.enc_final_ln = RMSNorm(cfg.d_model)
        self.dec_final_ln = RMSNorm(cfg.d_model)
        self.encoder = nn.ModuleList(T5EncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(T5DecoderLayer(cfg) for _ in range(cfg.dec_layers))


@torch.no_grad()
def init_t5(cfg: Seq2SeqConfig, generator: torch.Generator, device=None) -> T5:
    """The reference init: kernels and the token table ~ N(0, 0.02^2), RMS
    scales 1, and the two relative-bias tables ~ N(0, 0.02^2) (which the
    generic rule would zero for their name)."""
    model = build_module(lambda: T5(cfg), generator, device)
    for table in (model.enc_rel_bias, model.dec_rel_bias):
        table.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    return model


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * p.scale


def _linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.kernel)


def relative_position_bucket(rel: torch.Tensor, bidirectional: bool) -> torch.Tensor:
    """HF T5 bucketing (32 buckets, max distance 128) of integer relative
    positions, as the JAX package computes it: the log bucket is the int32
    truncation of an f32 log(n/8 + 1e-9) / log(16) * 8 (HF adds no 1e-9)."""
    nb = N_BUCKETS
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    if bidirectional:
        nb //= 2
        ret = ret + (rel > 0).to(torch.int32) * nb
        n = rel.abs()
    else:
        n = torch.clamp(-rel, min=0)
    max_exact = nb // 2
    log_range = torch.log(torch.tensor(MAX_DISTANCE / max_exact, dtype=torch.float32,
                                       device=rel.device))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9) / log_range
                         * (nb - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return ret + torch.where(n < max_exact, n, large)


_BUCKETS: dict[tuple[torch.device, bool], torch.Tensor] = {}


def _bucket_lookup(device: torch.device, bidirectional: bool) -> torch.Tensor:
    """Buckets of the offsets -MAX_DISTANCE..MAX_DISTANCE, held on
    ``device``; every offset farther out is in the last bucket of its sign,
    as the offset at MAX_DISTANCE is."""
    key = (device, bidirectional)
    if key not in _BUCKETS:
        rel = torch.arange(-MAX_DISTANCE, MAX_DISTANCE + 1)
        _BUCKETS[key] = relative_position_bucket(rel, bidirectional).long().to(device)
    return _BUCKETS[key]


def _pos_bias(table: torch.Tensor, t_q: int, t_k: int, bidirectional: bool,
              offset: int = 0) -> torch.Tensor:
    """[1, nh, Tq, Tk] bias from a relative-bias table: query i sits at
    position offset + i, key j at j."""
    dev = table.device
    ctx = torch.arange(t_q, device=dev)[:, None] + offset
    mem = torch.arange(t_k, device=dev)[None, :]
    rel = torch.clamp(mem - ctx, -MAX_DISTANCE, MAX_DISTANCE) + MAX_DISTANCE
    # `F.embedding`: its backward sums the Tq x Tk rows into the 32 buckets
    # by sorting them; indexing's backward accumulates them in place
    return F.embedding(_bucket_lookup(dev, bidirectional)[rel], table).permute(2, 0, 1)[None]


def _t5_attention(p: T5Attention, x_q, x_kv, n_heads: int, *, bias=None, mask=None,
                  cache: dict | None = None, kv=None):
    """Unscaled multi-head attention with an additive position bias. With
    ``cache``, x_kv is the new chunk, written into the cache at
    ``cache["pos"]`` (`core.cache_write`, ``pos`` advanced); with ``kv``, the key and
    value heads are reused."""
    q = _split_heads(_linear(p.q, x_q), n_heads)
    if kv is not None:
        k, v = kv
    else:
        k = _split_heads(_linear(p.k, x_kv), n_heads)
        v = _split_heads(_linear(p.v, x_kv), n_heads)
    if cache is not None:
        k, v = cache_write(cache, k, v)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    return _linear(p.o, _merge_heads(out)), cache


def _ffn(p: T5FFN, x: torch.Tensor) -> torch.Tensor:
    return _linear(p.wo, F.relu(_linear(p.wi, x)))


def t5_encode(params: T5, cfg: Seq2SeqConfig, ids, padding_mask) -> torch.Tensor:
    """Encoder states [B, S, H] (after the final RMSNorm)."""
    s = ids.shape[1]
    x = embed(params.shared_emb, ids)
    bias = _pos_bias(params.enc_rel_bias, s, s, bidirectional=True)
    mask = (padding_mask > 0)[:, None, None, :]
    for lp in params.encoder:
        xn = rmsnorm(lp.attn_ln, x)
        a, _ = _t5_attention(lp.attn, xn, xn, cfg.n_heads, bias=bias, mask=mask)
        x = x + a
        x = x + _ffn(lp.ffn, rmsnorm(lp.ffn_ln, x))
    return rmsnorm(params.enc_final_ln, x)


def t5_decode(params: T5, cfg: Seq2SeqConfig, dec_ids, enc_hidden, enc_padding_mask, *,
              caches: list[dict] | None = None, pos_offset: int = 0):
    """Returns (hidden [B, T, H], caches). Without ``caches``: teacher-forced
    over the whole target, query i at position pos_offset + i. With
    ``caches`` (every layer's at the same ``pos``): dec_ids is the new
    chunk, each cache appended in place; a cache holding ``ck``/``cv``
    reuses those cross-attention heads."""
    t = dec_ids.shape[1]
    x = embed(params.shared_emb, dec_ids)
    cross_mask = (enc_padding_mask > 0)[:, None, None, :]
    if caches is not None:
        pos, t_k = caches[0]["pos"], caches[0]["k"].shape[2]
        smask = causal_mask(t, t_k, pos, x.device)
        bias = _pos_bias(params.dec_rel_bias, t, t_k, bidirectional=False, offset=pos)
    else:
        smask = causal_mask(t, t, 0, x.device)
        bias = _pos_bias(params.dec_rel_bias, t, t, bidirectional=False, offset=pos_offset)
    for li, lp in enumerate(params.decoder):
        cache = caches[li] if caches is not None else None
        xn = rmsnorm(lp.self_ln, x)
        a, _ = _t5_attention(lp.self_attn, xn, xn, cfg.n_heads, bias=bias, mask=smask,
                             cache=cache)
        x = x + a
        ckv = (cache["ck"], cache["cv"]) if cache is not None and "ck" in cache else None
        c, _ = _t5_attention(lp.cross_attn, rmsnorm(lp.cross_ln, x), enc_hidden, cfg.n_heads,
                             mask=cross_mask, kv=ckv)
        x = x + c
        x = x + _ffn(lp.ffn, rmsnorm(lp.ffn_ln, x))
    return rmsnorm(params.dec_final_ln, x), caches


def t5_lm_logits(params: T5, hidden: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    """Tied head with the d_model^-0.5 rescale: [B, T, H] → [B, T, V] f32."""
    return torch.matmul(hidden * (cfg.d_model ** -0.5), params.shared_emb.table.T)


def t5_shift_right(ids: torch.Tensor, pad_id: int, start_id: int = 0) -> torch.Tensor:
    """T5 `_shift_right` (reference sotasum/t5_lightning.py:93-101): roll
    right, ``start_id`` first, then -100 → ``pad_id``."""
    shifted = torch.roll(ids, 1, dims=-1)
    shifted[:, 0] = start_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


def init_t5_caches(params: T5, cfg: Seq2SeqConfig, b: int, t_max: int,
                   dtype=torch.float32, enc_hidden: torch.Tensor | None = None) -> list[dict]:
    """Self-attention caches; with ``enc_hidden``, also each layer's
    cross-attention heads, computed once for every decode step."""
    dh = cfg.d_model // cfg.n_heads
    device = params.shared_emb.table.device
    caches = []
    for lp in params.decoder:
        c = make_cache(b, cfg.n_heads, dh, t_max, dtype, device)
        if enc_hidden is not None:
            c["ck"] = _split_heads(_linear(lp.cross_attn.k, enc_hidden), cfg.n_heads)
            c["cv"] = _split_heads(_linear(lp.cross_attn.v, enc_hidden), cfg.n_heads)
        caches.append(c)
    return caches
