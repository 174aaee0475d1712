"""Sequence-sharded sliding-window + global attention, with its gradient.

Counterpart of ``retrieval_augmented_mds_tpu/ops/seq_attention.py``: the
same semantics as `sliding_attention.sliding_global_attention`, with the
tokens split over the mesh's ``shard`` axis. Each shard rank s holds the
[B, T/S, H] block of tokens [s·T/S, (s+1)·T/S):

  * it projects its own q, k and v with the replicated weights;
  * the band reaches w tokens past the block's edges, so the block is
    extended by its neighbours' w-row K/V edges (zeros, and a -1e9 bias,
    past the sequence's ends) and by w dummy query rows on each side, and
    the local rows run through `flash_sliding.sliding_local_rows` (kernel
    K2 on the card) unchanged; the dummy rows' outputs are dropped. The
    JAX package trades the edges with two ``ppermute``s; here every rank's
    edges are all-gathered over the ``shard`` group and each rank takes
    its neighbours' (gloo has no point-to-point on CUDA tensors; at S <= 4
    this moves at most 3x the bytes);
  * the global tokens' regular K/V rows and their global-q rows are
    collected with one all-reduce SUM, each owner contributing its rows
    and every other rank zeros;
  * the global-query rows attend the whole sequence as a flash softmax
    across ranks: each rank's (max, sum, weighted value) over its keys,
    combined with an all-reduce MAX of the maxima and a SUM of the
    rescaled sums and values;
  * the padding and global masks are whole on every rank, which slices its
    own part.

Padded rows come out zero, fully masked rows uniform over their 3w + G
columns, as on one device.

Under autograd every exchange above carries its gradient back
(`parallel.collectives`: the transpose of each collective): the halo
edges' gradients return to the neighbours that own them, the globals'
rows' to their owners, the flash-softmax sums' to every rank that added
to them; the maxima carry none (a stop-gradient shift, as the JAX
package's). Each rank's extended block runs the backward of
`sliding_local_rows` (kernel K3 on the card), its w dummy query rows on
each side with a zero cotangent. A rank's output is its own block (its
part of the sum the loss takes), so each rank's parameter gradients are
its block's share, summed over ``shard`` by the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.core import NEG_INF, _merge_heads, _split_heads, dense
from .sliding_attention import _gather_globals, _take_rows


def sliding_global_attention_seqsharded(
    p,
    xl: torch.Tensor,  # [B, T/S, H] this shard rank's block
    n_heads: int,
    window: int,
    global_mask: torch.Tensor,  # [B, T] {0,1}, whole
    padding_mask: torch.Tensor,  # [B, T] {0,1}, whole
    max_globals: int,
    mesh,
) -> torch.Tensor:
    """This rank's block of the attention output [B, T/S, H]."""
    from ..parallel.collectives import all_reduce, gather_stack
    from .flash_sliding import _scale, sliding_local_rows

    b, tl, h = xl.shape
    n_s, s = mesh.shard, mesh.s
    t = global_mask.shape[1]
    w = window
    if t != tl * n_s or tl % w:
        raise ValueError(f"T={t} must split into {n_s} blocks of a multiple of "
                         f"window={w}, got blocks of {tl}")
    dh = h // n_heads
    off = s * tl
    dev = xl.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    q = _split_heads(dense(p.q, xl), n_heads)  # [B, nh, Tl, dh]
    k = _split_heads(dense(p.k, xl), n_heads)
    v = _split_heads(dense(p.v, xl), n_heads)

    g_idx, g_valid = _gather_globals(global_mask, max_globals)  # [B, G]
    key_ok = (padding_mask > 0) & (global_mask == 0)
    key_bias_full = torch.where(key_ok, zero, neg)
    g_bias = torch.where(g_valid, zero, neg)

    # K/V halos: every rank's first and last w rows, gathered over shard
    edges = gather_stack(torch.stack([k[:, :, :w], k[:, :, -w:], v[:, :, :w],
                                      v[:, :, -w:]]), mesh.shard_group)
    none = torch.zeros_like(k[:, :, :w])
    k_lo, v_lo = (edges[s - 1, 1], edges[s - 1, 3]) if s > 0 else (none, none)
    k_hi, v_hi = (edges[s + 1, 0], edges[s + 1, 2]) if s < n_s - 1 else (none, none)
    k_ext = torch.cat([k_lo, k, k_hi], dim=2).contiguous()  # [B, nh, Tl+2w, dh]
    v_ext = torch.cat([v_lo, v, v_hi], dim=2).contiguous()
    key_bias_ext = F.pad(key_bias_full, (w, w), value=NEG_INF)[:, off:off + tl + 2 * w]

    # the global tokens' rows: regular K/V and global q, from their owners
    pos = g_idx - off
    own = (pos >= 0) & (pos < tl) & g_valid
    safe = pos.clamp(0, tl - 1)
    own_f = own[:, None, :, None].to(k.dtype)
    qgf = _split_heads(dense(p.qg, xl), n_heads)
    kg, vg, qg = all_reduce(torch.stack([_take_rows(x, safe) * own_f
                                         for x in (k, v, qgf)]), mesh.shard_group)

    # local rows over the extended block; the w dummy rows on each side
    # keep the band aligned with k_ext
    q_ext = F.pad(q, (0, 0, w, w))
    out = sliding_local_rows(q_ext, k_ext, v_ext, key_bias_ext.contiguous(),
                             kg.contiguous(), vg.contiguous(), g_bias, w)[:, :, w:w + tl]

    # global rows: a flash softmax over every rank's keys
    kgf = _split_heads(dense(p.kg, xl), n_heads)
    vgf = _split_heads(dense(p.vg, xl), n_heads)
    pad_bias = torch.where(padding_mask[:, off:off + tl] > 0, zero, neg)  # [B, Tl]
    logit = (torch.matmul(qg.float(), kgf.float().transpose(-1, -2)) * _scale(dh)
             + pad_bias[:, None, None, :])  # [B, nh, G, Tl]
    m_l = logit.amax(dim=-1).detach()  # a shift only: no gradient (stop_gradient)
    p_l = torch.exp(logit - m_l[..., None])
    m_g = all_reduce(m_l, mesh.shard_group, op="max")
    corr = torch.exp(m_l - m_g)
    so = all_reduce(torch.cat([(p_l.sum(-1) * corr)[..., None],
                               torch.matmul(p_l, vgf.float()) * corr[..., None]], dim=-1),
                    mesh.shard_group)
    out_g = (so[..., 1:] / so[..., :1].clamp(min=1e-30)).to(out.dtype)  # [B, nh, G, dh]

    # overwrite the global rows this rank owns; the others go to a spare
    # row past the block, which is dropped
    dest = torch.where(own, safe, torch.full_like(safe, tl))
    out = F.pad(out, (0, 0, 0, 1)).scatter(
        2, dest[:, None, :, None].expand(b, n_heads, dest.shape[1], dh), out_g)[:, :, :tl]
    out = out.masked_fill(~(padding_mask[:, off:off + tl] > 0)[:, None, :, None], 0.0)
    return dense(p.o, _merge_heads(out))
