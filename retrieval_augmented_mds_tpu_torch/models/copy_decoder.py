"""Memory-guided copy heads: per-token copy-vs-generate gating.

Counterpart of ``retrieval_augmented_mds_tpu/models/copy_decoder.py``.
Head A (`copy_decoder_forward`) is a stack of cross-attention layers over
the retrieved memory whose logits get the learned retrieval-score bias
``beta·memory_bias + beta_bias``; Head B (`copy_token_decoder_forward`)
is one single-head alignment attention with a diverter. Both end in

    p = gen_gate · softmax(lm_logits);  p[copy_seq] += copy_probs
    out = log(p + 1e-7)

The biased cross-attention stays plain PyTorch: its logits bias
``beta·memory_bias`` is differentiable (in ``beta`` and in the retrieval
scores), which no attention kernel here carries.
"""

from __future__ import annotations

import torch
from torch import nn

from .core import (
    FFN,
    MHA,
    NEG_INF,
    Dense,
    LayerNorm,
    _fold_groups,
    _logits,
    _merge_heads,
    _split_heads,
    _unfold_groups,
    dense,
    ffn,
    layernorm,
)

EPS = 1e-7


def mix_copy_probs(
    lm_logits: torch.Tensor,  # [B, T, V] f32
    gen_gate: torch.Tensor,  # [B, T, 1]
    copy_probs: torch.Tensor,  # [B, T, M] (= copy_gate · alignment)
    copy_seq: torch.Tensor,  # [B, M] vocab ids of the memory tokens
) -> torch.Tensor:
    """Log of the gated mixture (sums to ~1 per token)."""
    probs = gen_gate.float() * torch.softmax(lm_logits.float(), dim=-1)
    if copy_seq.shape[0] != probs.shape[0]:
        # beams against un-expanded memory: repeat the (tiny) id rows
        copy_seq = copy_seq.repeat_interleave(probs.shape[0] // copy_seq.shape[0], 0)
    b, t, m = copy_probs.shape
    idx = copy_seq.long()[:, None, :].expand(b, t, m)
    probs = probs.scatter_add(2, idx, copy_probs.float())
    return torch.log(probs + EPS)


# ---------------------------------------------------------------------------
# Head A: cross-attention copy decoder
# ---------------------------------------------------------------------------

class CopyDecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.cross_attn = MHA(d_model)
        self.beta = nn.Parameter(torch.empty(()))
        self.beta_bias = nn.Parameter(torch.empty(()))
        self.cross_ln = LayerNorm(d_model)
        self.ffn = FFN(d_model, d_ffn)
        self.ffn_ln = LayerNorm(d_model)


class CopyDecoder(nn.Module):
    def __init__(self, d_model: int, n_layers: int, d_ffn: int,
                 gates_mode: str = "both"):
        super().__init__()
        if gates_mode not in ("nmt", "onlycopy", "both"):
            raise ValueError(f"gates_mode={gates_mode!r}")
        self.layers = nn.ModuleList(
            CopyDecoderLayer(d_model, d_ffn) for _ in range(n_layers)
        )
        self.align_ln = LayerNorm(d_model)
        self.diverter = Dense(d_model if gates_mode == "onlycopy" else 2 * d_model, 2)


def precompute_copy_kv(params: CopyDecoder, memory: torch.Tensor, n_heads: int):
    """Per-layer memory K/V heads for Head A, computed once per generation."""
    return [
        (_split_heads(dense(lp.cross_attn.k, memory), n_heads),
         _split_heads(dense(lp.cross_attn.v, memory), n_heads))
        for lp in params.layers
    ]


def _biased_cross_attention(
    lp: CopyDecoderLayer,
    x: torch.Tensor,  # [B, T, H]
    memory: torch.Tensor,  # [B, M, H]
    memory_mask: torch.Tensor,  # [B, M] {0,1}
    memory_bias: torch.Tensor,  # [B, M] retrieval scores
    n_heads: int,
    kv=None,
):
    """One cross-attention with score-biased logits → (out, heads-averaged
    weights [B, T, M]); beams fold into the query axis against
    un-expanded memory."""
    dh = lp.cross_attn.q.kernel.shape[1] // n_heads
    b_mem = memory_mask.shape[0]
    t = x.shape[1]
    q = _split_heads(dense(lp.cross_attn.q, x), n_heads)
    if kv is not None:
        k, v = kv[0].to(q.dtype), kv[1].to(q.dtype)
    else:
        k = _split_heads(dense(lp.cross_attn.k, memory), n_heads)
        v = _split_heads(dense(lp.cross_attn.v, memory), n_heads)
    g = 1
    if q.shape[0] != b_mem:
        g = q.shape[0] // b_mem
        q = _fold_groups(q, g)
    logits = _logits(q, k, dh)
    logits = logits + (lp.beta * memory_bias.float() + lp.beta_bias)[:, None, None, :]
    logits = logits.masked_fill(~(memory_mask > 0)[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w.to(x.dtype), v)
    if g > 1:
        out = _unfold_groups(out, g)
    out = dense(lp.cross_attn.o, _merge_heads(out))
    align = w.mean(dim=1)  # [b, g·T, M]
    if g > 1:
        align = align.reshape(b_mem * g, t, align.shape[-1])
    return out, align


def copy_decoder_forward(
    params: CopyDecoder,
    decoder_hidden: torch.Tensor,  # [B, T, H]
    memory: torch.Tensor,  # [B, M, H]
    memory_mask: torch.Tensor,  # [B, M]
    memory_bias: torch.Tensor,  # [B, M]
    *,
    n_heads: int = 1,
    gates_mode: str = "both",
    skip_residual: bool = False,
    copy_kv=None,
):
    """Returns (gen_gate [B,T,1], copy_gate [B,T,1], copy_probs [B,T,M])."""
    x = decoder_hidden
    attn_out = align = None
    for li, lp in enumerate(params.layers):
        attn_out, align = _biased_cross_attention(
            lp, x, memory, memory_mask, memory_bias, n_heads,
            kv=None if copy_kv is None else copy_kv[li],
        )
        x = layernorm(lp.cross_ln, x + attn_out)
        f = ffn(lp.ffn, x)
        x = layernorm(lp.ffn_ln, f if skip_residual else x + f)

    if gates_mode == "nmt":
        gates_in = torch.cat([x, layernorm(params.align_ln, attn_out)], dim=-1)
    elif gates_mode == "onlycopy":
        gates_in = x
    else:  # "both"
        gates_in = torch.cat([x, decoder_hidden], dim=-1)
    gates = torch.softmax(dense(params.diverter, gates_in).float(), dim=-1)
    gen_gate, copy_gate = gates[..., :1], gates[..., 1:]
    return gen_gate, copy_gate, copy_gate * align.float()


# ---------------------------------------------------------------------------
# Head B: CopyTokenDecoder
# ---------------------------------------------------------------------------

class CopyTokenDecoder(nn.Module):
    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.align = MHA(d_model)
        self.align_ln = LayerNorm(d_model)
        self.ffn = FFN(d_model, d_ffn)
        self.ffn_ln = LayerNorm(d_model)
        self.diverter = Dense(2 * d_model, 2)


def copy_token_decoder_forward(
    params: CopyTokenDecoder,
    decoder_hidden: torch.Tensor,  # [B, T, H]
    memory: torch.Tensor,  # [B, M, H]
    memory_mask: torch.Tensor,  # [B, M]
    memory_bias: torch.Tensor,  # [B, M]
    copy_seq: torch.Tensor,  # [B, M] vocab ids
    emb_table: torch.Tensor,  # [V, H] tied target embedding
) -> torch.Tensor:
    """Full Head-B path → log-probs [B, T, V]."""
    h = decoder_hidden.shape[-1]
    b_mem = memory_mask.shape[0]
    t = decoder_hidden.shape[1]
    q = _split_heads(dense(params.align.q, decoder_hidden), 1)
    k = _split_heads(dense(params.align.k, memory), 1)
    v = _split_heads(dense(params.align.v, memory), 1)
    g = 1
    if q.shape[0] != b_mem:
        g = q.shape[0] // b_mem
        q = _fold_groups(q, g)
    logits = _logits(q, k, h)
    logits = logits + memory_bias.float()[:, None, None, :]
    logits = logits.masked_fill(~(memory_mask > 0)[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)  # [B, 1, g·T, M]
    out = torch.matmul(w.to(memory.dtype), v)
    if g > 1:
        out = _unfold_groups(out, g)
    attn = dense(params.align.o, _merge_heads(out))
    align = w[:, 0]
    if g > 1:
        align = align.reshape(b_mem * g, t, align.shape[-1])

    outs = layernorm(params.align_ln, decoder_hidden + attn)
    outs = layernorm(params.ffn_ln, ffn(params.ffn, outs))
    gates_in = torch.cat([outs, layernorm(params.align_ln, attn)], dim=-1)
    gates = torch.softmax(dense(params.diverter, gates_in).float(), dim=-1)
    gen_gate, copy_gate = gates[..., :1], gates[..., 1:]
    vocab_logits = torch.matmul(outs.float(), emb_table.to(outs.dtype).float().T)
    return mix_copy_probs(vocab_logits, gen_gate, copy_gate * align.float(), copy_seq)
