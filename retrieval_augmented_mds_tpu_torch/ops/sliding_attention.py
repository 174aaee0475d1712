"""Sliding-window + global-token attention (Longformer / LED encoder).

Counterpart of ``retrieval_augmented_mds_tpu/ops/sliding_attention.py``:
local-query rows attend their band plus the gathered global tokens in one
softmax (`flash_sliding.sliding_local_rows`: the CUDA kernel on the card);
global-token rows run a separate dense attention over the whole sequence
with their own q/k/v projections and overwrite their rows (HF Longformer
semantics); padded rows come out zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.core import (
    NEG_INF,
    Dense,
    _merge_heads,
    _split_heads,
    build_module,
    dense,
)


class SlidingAttention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        for name in ("q", "k", "v", "qg", "kg", "vg", "o"):
            setattr(self, name, Dense(d_model, d_model))


def sliding_attention_init(d_model: int, generator: torch.Generator,
                           device=None) -> SlidingAttention:
    return build_module(lambda: SlidingAttention(d_model), generator, device)


def _gather_globals(global_mask: torch.Tensor, max_globals: int):
    """[B, T] {0,1} → (g_idx [B, G] int64, g_valid [B, G] bool): the first
    G global positions of each row in position order (stable sort)."""
    order = torch.argsort(-global_mask.to(torch.int32), dim=-1, stable=True)
    g_idx = order[:, :max_globals]
    g_valid = torch.gather(global_mask, 1, g_idx) > 0
    return g_idx, g_valid


def _window_kv(x: torch.Tensor, nb: int, w: int) -> torch.Tensor:
    """[B, nh, T, d] → [B, nh, nb, 3w, d]: each block with its neighbours
    (zero rows outside [0, T))."""
    b, nh, t, d = x.shape
    xp = F.pad(x, (0, 0, w, w))
    blocks = [xp[:, :, i * w: i * w + t].reshape(b, nh, nb, w, d) for i in range(3)]
    return torch.cat(blocks, dim=3)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, nh, T, d], idx [B, G] → x[b, :, idx[b]] as [B, nh, G, d]."""
    b, nh, _, d = x.shape
    return torch.gather(x, 2, idx[:, None, :, None].expand(b, nh, idx.shape[1], d))


def sliding_global_attention(
    p: SlidingAttention,
    x: torch.Tensor,  # [B, T, H]
    n_heads: int,
    window: int,
    global_mask: torch.Tensor,  # [B, T] {0,1}: 1 = global token
    padding_mask: torch.Tensor,  # [B, T] {0,1}: 1 = real token
    max_globals: int = 64,
) -> torch.Tensor:
    from .flash_sliding import _scale, sliding_local_rows

    b, t, h = x.shape
    w = window
    if t % w:
        raise ValueError(f"T={t} must be a multiple of window={w} (pad inputs)")
    dh = h // n_heads
    scale = _scale(dh)

    q = _split_heads(dense(p.q, x), n_heads)  # [B, nh, T, dh]
    k = _split_heads(dense(p.k, x), n_heads)
    v = _split_heads(dense(p.v, x), n_heads)

    # local-query rows: band ∪ global-key columns, one softmax. Global-key
    # columns use the REGULAR k/v of the global tokens, and global tokens
    # are masked out of the band.
    g_idx, g_valid = _gather_globals(global_mask, max_globals)
    kg = _take_rows(k, g_idx)
    vg = _take_rows(v, g_idx)
    key_ok = (padding_mask > 0) & (global_mask == 0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
    key_bias = torch.where(key_ok, zero, neg)
    g_bias = torch.where(g_valid, zero, neg)
    out = sliding_local_rows(q, k, v, key_bias, kg, vg, g_bias, w)

    # global queries attend the full sequence with the *_global projections
    kg_full = _split_heads(dense(p.kg, x), n_heads)
    vg_full = _split_heads(dense(p.vg, x), n_heads)
    qg = _take_rows(_split_heads(dense(p.qg, x), n_heads), g_idx)
    full_log = torch.matmul(qg.float(), kg_full.float().transpose(-1, -2)) * scale
    full_log = full_log.masked_fill(~(padding_mask > 0)[:, None, None, :], NEG_INF)
    full_p = torch.softmax(full_log, dim=-1).to(x.dtype)
    out_g = torch.matmul(full_p, vg_full)  # [B, nh, G, dh]

    # overwrite the global rows of the local output
    cur = _take_rows(out, g_idx)
    mixed = torch.where(g_valid[:, None, :, None], out_g, cur)
    out = out.scatter(
        2, g_idx[:, None, :, None].expand(b, n_heads, g_idx.shape[1], dh), mixed
    )
    out = out.masked_fill(~(padding_mask > 0)[:, None, :, None], 0.0)
    return dense(p.o, _merge_heads(out))
