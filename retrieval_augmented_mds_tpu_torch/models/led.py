"""LED-style encoder-decoder (the generator backbone).

Counterpart of ``retrieval_augmented_mds_tpu/models/led.py``: a sliding-
window + global attention encoder and a causal decoder with cross-
attention, run teacher-forced for training (through the dense attention
kernels K4/K5) or incrementally over a KV cache for decoding. Embeddings
are shared by the encoder, the decoder and the tied LM head.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.sliding_attention import SlidingAttention, sliding_global_attention
from .config import Seq2SeqConfig
from .core import (
    FFN,
    MHA,
    Embedding,
    LayerNorm,
    attention,
    attention_train,
    build_module,
    causal_mask,
    embed,
    ffn,
    layernorm,
    make_cache,
    maybe_remat,
    precompute_cross_kv,
)


class LEDEncoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.attn = SlidingAttention(cfg.d_model)
        self.attn_ln = LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = LayerNorm(cfg.d_model)


class LEDDecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.self_attn = MHA(cfg.d_model)
        self.self_ln = LayerNorm(cfg.d_model)
        self.cross_attn = MHA(cfg.d_model)
        self.cross_ln = LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = LayerNorm(cfg.d_model)


class LED(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.shared_emb = Embedding(cfg.vocab_size, cfg.d_model)
        self.enc_pos = Embedding(cfg.max_src_len, cfg.d_model)
        self.dec_pos = Embedding(cfg.max_tgt_len, cfg.d_model)
        self.enc_emb_ln = LayerNorm(cfg.d_model)
        self.dec_emb_ln = LayerNorm(cfg.d_model)
        self.encoder = nn.ModuleList(LEDEncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(LEDDecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.final_logits_bias = nn.Parameter(torch.empty(cfg.vocab_size))


def init_led(cfg: Seq2SeqConfig, generator: torch.Generator, device=None) -> LED:
    return build_module(lambda: LED(cfg), generator, device)


def led_encode(
    params: LED,
    cfg: Seq2SeqConfig,
    ids: torch.Tensor,  # [B, S]
    padding_mask: torch.Tensor,  # [B, S]
    global_mask: torch.Tensor | None = None,
    *,
    dtype=torch.float32,
    remat: bool | str = False,
) -> torch.Tensor:
    """Encoder hidden states [B, S, H] (sequence parallelism not ported);
    ``remat`` checkpoints each layer (`core.maybe_remat`)."""
    b, s = ids.shape
    if global_mask is None:
        global_mask = torch.zeros_like(padding_mask)
        global_mask[:, 0] = 1
    global_mask = global_mask * padding_mask
    pos = torch.arange(s, device=ids.device)[None, :]
    x = embed(params.shared_emb, ids, dtype) + embed(params.enc_pos, pos, dtype)
    x = layernorm(params.enc_emb_ln, x)

    def layer_fn(x, lp):
        a = sliding_global_attention(
            lp.attn, x, cfg.n_heads, cfg.window, global_mask, padding_mask,
            cfg.max_globals,
        )
        x = layernorm(lp.attn_ln, x + a)
        return layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))

    layer_fn = maybe_remat(layer_fn, remat)
    for lp in params.encoder:
        x = layer_fn(x, lp)
    return x


def led_decode(
    params: LED,
    cfg: Seq2SeqConfig,
    dec_ids: torch.Tensor,  # [B, T]
    enc_hidden: torch.Tensor,  # [B, S, H]
    enc_padding_mask: torch.Tensor,  # [B, S]
    *,
    caches: list[dict] | None = None,  # per-layer self-attn caches
    pos_offset: int = 0,  # decode position of dec_ids[:, 0]
    dtype=torch.float32,
    remat: bool | str = False,
):
    """Returns (hidden [B, T, H], caches). Without ``caches`` it runs
    teacher-forced over the whole target (the training path: causal
    self-attention and padded cross-attention through `attention_train`)
    and returns caches None, each layer checkpointed under ``remat``. With
    ``caches`` it runs incrementally: dec_ids is the new chunk and each
    layer's cache is appended in place (``remat`` does not apply)."""
    b, t = dec_ids.shape
    pos = torch.arange(t, device=dec_ids.device)[None, :] + pos_offset
    x = embed(params.shared_emb, dec_ids, dtype) + embed(params.dec_pos, pos, dtype)
    x = layernorm(params.dec_emb_ln, x)
    enc = enc_hidden.to(x.dtype)

    if caches is None:
        def layer_fn(x, lp):
            a = attention_train(lp.self_attn, x, x, cfg.n_heads, causal=True)
            x = layernorm(lp.self_ln, x + a)
            c = attention_train(lp.cross_attn, x, enc, cfg.n_heads,
                                key_padding_mask=enc_padding_mask)
            x = layernorm(lp.cross_ln, x + c)
            return layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))

        layer_fn = maybe_remat(layer_fn, remat)
        for lp in params.decoder:
            x = layer_fn(x, lp)
        return x, None

    cross_mask = (enc_padding_mask > 0)[:, None, None, :]
    for lp, cache in zip(params.decoder, caches):
        smask = causal_mask(t, cache["k"].shape[2], cache["pos"], x.device)
        a, _ = attention(lp.self_attn, x, x, cfg.n_heads, mask=smask, cache=cache)
        x = layernorm(lp.self_ln, x + a)
        ckv = (cache["ck"], cache["cv"]) if "ck" in cache else None
        c, _ = attention(lp.cross_attn, x, enc, cfg.n_heads, mask=cross_mask, kv=ckv)
        x = layernorm(lp.cross_ln, x + c)
        x = layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))
    return x, caches


def led_lm_logits(params: LED, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head: [B, T, H] → [B, T, V] (f32)."""
    table = params.shared_emb.table.to(hidden.dtype)
    logits = torch.matmul(hidden.float(), table.float().T)
    return logits + params.final_logits_bias[None, None, :]


def init_decode_caches(
    params: LED, cfg: Seq2SeqConfig, b: int, t_max: int, dtype=torch.float32,
    enc_hidden: torch.Tensor | None = None,
) -> list[dict]:
    """Self-attention KV caches; with ``enc_hidden``, also the per-layer
    cross-attention K/V, computed once and reused every decode step."""
    dh = cfg.d_model // cfg.n_heads
    device = params.shared_emb.table.device
    caches = []
    for lp in params.decoder:
        c = make_cache(b, cfg.n_heads, dh, t_max, dtype, device)
        if enc_hidden is not None:
            c["ck"], c["cv"] = precompute_cross_kv(
                lp.cross_attn, enc_hidden.to(dtype), cfg.n_heads
            )
        caches.append(c)
    return caches


def shift_tokens_right(ids: torch.Tensor, pad_id: int, start_id: int):
    """Teacher-forcing decoder inputs (HF ``shift_tokens_right``)."""
    shifted = torch.roll(ids, 1, dims=-1)
    shifted[:, 0] = start_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)
