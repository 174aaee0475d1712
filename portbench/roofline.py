"""The table of peaks and the bounds of the port's attention kernels.

Peaks of one NVIDIA H100 SXM (the data sheet, dense, at 700 W): 3.35 TB/s
of HBM, 989 TFLOP/s in bf16, 494.7 TFLOP/s in TF32. f32 is held to f32
accuracy on split TF32 (three TF32 products for one f32 product), so its
peak is 494.7 / 3 TFLOP/s and no f32-exact implementation can read over
100%.

A launch's bound is the larger of the bytes its inputs need (each read
once, each output written once) over the HBM rate, and the operations its
masks need (the window's and the padding's real pairs) over the peak of
its precision. The counting functions are copies of ``chip_smoke.py``'s
`roofline`, `_sliding_pairs`, `_sliding_reads`, `_dense_pairs` and
`_dense_reads`, written as functions of the masks, so that they count the
same work whatever implements it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12
PEAK = {"bfloat16": PEAK_BF16, "float32": PEAK_TF32 / 3}
NEG_INF = -1e9

# the kernels' function names in a device trace, by the wrapper that
# launches them (the wrapper's ``.launches`` counts its calls)
KERNELS = {
    "flash_sliding_attention": ("sliding_mma_fwd_kernel",),
    "flash_sliding_backward": ("sliding_mma_dq_kernel", "sliding_mma_dkv_kernel",
                               "sliding_mma_dkvg_kernel", "sum_splits_kernel"),
    "flash_dense_attention": ("mma_fwd_kernel",),
    "flash_dense_backward": ("mma_dq_kernel", "mma_dkv_kernel"),
}


def bound_s(n_bytes: float, n_ops: float, precision: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK[precision])


def elem(precision: str) -> int:
    return 2 if precision == "bfloat16" else 4


def sliding_masks(pad: torch.Tensor, global_mask: torch.Tensor, max_globals: int):
    """The kernel's masks as the port's `sliding_global_attention` makes
    them from the padding and global masks [B, T] → (key_bias [B, T],
    g_bias [B, G], the valid global rows [B, T] bool)."""
    real = pad > 0
    is_g = (global_mask * pad) > 0
    g = min(max_globals, pad.shape[1])
    valid = torch.zeros_like(real)
    order = torch.argsort((~is_g).to(torch.int8), dim=1, stable=True)[:, :g]
    g_ok = torch.gather(is_g, 1, order)
    valid.scatter_(1, order, g_ok)
    key_bias = torch.where(real & ~is_g, 0.0, NEG_INF)
    g_bias = torch.where(g_ok, 0.0, NEG_INF)
    return key_bias.float(), g_bias.float(), valid


def sliding_pairs(key_bias, g_bias, w, nh, rows=None) -> float:
    """Visible (query, key) pairs of the sliding rows: for every row (of
    ``rows`` [B, T] bool, all by default), the unmasked keys within w of it
    plus the valid globals, times the heads."""
    b, t = key_bias.shape
    rows = torch.ones((b, t), dtype=torch.bool, device=key_bias.device) if rows is None \
        else rows
    ok = F.pad((key_bias == 0).long().cumsum(1), (1, 0))
    i = torch.arange(t, device=key_bias.device)
    hi, lo = torch.clamp(i + w + 1, max=t), torch.clamp(i - w, min=0)
    window = ((ok[:, hi] - ok[:, lo]) * rows).sum()
    return float(nh * (window + (rows.sum(1) * (g_bias == 0).sum(1)).sum()))


def sliding_reads(key_bias, g_bias, w, live) -> tuple[int, int, int]:
    """(query rows, open keys, window keys) per head that the sliding rows
    of ``live`` [B, T] bool must read: the live rows' queries; the keys open
    to a live row; and the other keys in the window of a live row with no
    open column, over which such a row is uniform."""
    b, t = key_bias.shape
    i = torch.arange(t, device=key_bias.device)
    hi, lo = torch.clamp(i + w + 1, max=t), torch.clamp(i - w, min=0)

    def near(x):
        c = F.pad(x.long().cumsum(1), (1, 0))
        return (c[:, hi] - c[:, lo]) > 0

    open_ = key_bias == 0
    blind = live & ~(near(open_) | (g_bias == 0).any(1, keepdim=True))
    blocks = blind.view(b, t // w, w).any(2).long()
    blocks = blocks + F.pad(blocks[:, 1:], (0, 1)) + F.pad(blocks[:, :-1], (1, 0))
    keys = open_ & near(live)
    window = (blocks > 0).repeat_interleave(w, 1) & ~keys
    return int(live.sum()), int(keys.sum()), int(window.sum())


def dense_pairs(key_ok: torch.Tensor, t: int, nh: int, causal: bool) -> float:
    """Visible (query, key) pairs of a dense attention over keys
    ``key_ok`` [B, S] bool: keys inside the source, and not after the
    query when causal."""
    if not causal:
        return float(nh * t * key_ok.sum())
    s = key_ok.shape[1]
    j = torch.arange(s, device=key_ok.device)
    vis = key_ok[:, None, :] & (j[None, None, :] <= torch.arange(t, device=key_ok.device)
                                [None, :, None])
    return float(nh * vis.sum())


def dense_reads(key_ok: torch.Tensor) -> tuple[int, int]:
    """(open keys, keys of sources with no open key)."""
    return int(key_ok.sum()), int((~key_ok.any(1)).sum()) * key_ok.shape[1]


def k2_bound(key_bias, g_bias, w, nh, dh, precision) -> float:
    """K2 (`flash_sliding_attention`): out, m and l written."""
    b, t = key_bias.shape
    g = g_bias.shape[1]
    e = elem(precision)
    flops = 4 * dh * sliding_pairs(key_bias, g_bias, w, nh)
    rows, keys, window = sliding_reads(key_bias, g_bias, w, torch.ones_like(key_bias,
                                                                            dtype=torch.bool))
    n_bytes = (nh * dh * e * (rows + 2 * keys + window) + 4 * (b * t + b * g)
               + 2 * b * nh * g * dh * e + b * nh * t * dh * e + 2 * 4 * b * nh * t)
    return bound_s(n_bytes, flops, precision)


def k3_bound(key_bias, g_bias, w, nh, dh, live, precision) -> float:
    """K3 (`flash_sliding_backward`): rows with a zero cotangent (``live``
    false) add nothing; dq, dk, dv, dkg and dvg written."""
    b, t = key_bias.shape
    g = g_bias.shape[1]
    e = elem(precision)
    flops = 10 * dh * sliding_pairs(key_bias, g_bias, w, nh, live)
    rows, keys, window = sliding_reads(key_bias, g_bias, w, live)
    n_bytes = (nh * dh * e * (rows + 2 * (keys + window)) + rows * nh * 3 * 4
               + 4 * (b * t + b * g) + 2 * b * nh * g * dh * e       # masks, kg, vg
               + b * nh * t * dh * e                                  # dO
               + 3 * b * nh * t * dh * e + 2 * b * nh * g * dh * e)   # dq dk dv dkg dvg
    return bound_s(n_bytes, flops, precision)


def k4_bound(key_ok, t, nh, dh, causal, precision) -> float:
    """K4 (`flash_dense_attention`): out, m and l written."""
    b, s = key_ok.shape
    e = elem(precision)
    open_keys, blind = dense_reads(key_ok)
    n_bytes = (b * nh * t * dh * e + 4 * b * s + b * nh * t * dh * e + 2 * 4 * b * nh * t
               + nh * dh * e * (2 * open_keys + blind))
    return bound_s(n_bytes, 4 * dh * dense_pairs(key_ok, t, nh, causal), precision)


def k5_bound(key_ok, t, nh, dh, causal, precision) -> float:
    """K5 (`flash_dense_backward`): q, the mask, dO, m, l and delta read;
    dq, dk and dv written."""
    b, s = key_ok.shape
    e = elem(precision)
    open_keys, blind = dense_reads(key_ok)
    n_bytes = (2 * b * nh * t * dh * e + 4 * b * s + 3 * 4 * b * nh * t
               + b * nh * (t + 2 * s) * dh * e + nh * dh * e * 2 * (open_keys + blind))
    return bound_s(n_bytes, 10 * dh * dense_pairs(key_ok, t, nh, causal), precision)


def kernel_name(trace_name: str) -> str:
    """A kernel's function name from its demangled name in the trace:
    ``void (anonymous namespace)::sliding_mma_fwd_kernel<__nv_bfloat16, 64>
    (...)`` → ``sliding_mma_fwd_kernel``."""
    name = trace_name.replace("(anonymous namespace)::", "")
    depth, head = 0, []
    for ch in name:  # the text before the argument list, template arguments dropped
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            head.append(ch)
    return "".join(head).split()[-1].split("::")[-1] if "".join(head).split() else name
