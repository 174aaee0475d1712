"""Backward of the local-query rows of sliding-window + global attention.

Counterpart of ``retrieval_augmented_mds_tpu/ops/flash_sliding_bwd.py``.
From the forward's row max ``m`` and denominator ``l`` ([B*nh, 1, T] f32,
`flash_sliding.local_rows_plain` / `flash_sliding_attention` with
``return_stats``) and delta = rowsum(dO * out), both versions recompute
the probabilities and return (dq, dk, dv) [B, nh, T, dh] and the
gradients of the gathered global keys and values (dkg, dvg)
[B, nh, G, dh]. m and l stay separate, not folded into a log-sum-exp:
for a fully masked row m = -1e9 and the fold would lose log l to f32
rounding, turning the forward's uniform row into p = 1.

The columns are those of the forward composite: band keys carry
q·k/sqrt(dh) + key_bias and pass gradients to q and k; window columns out
of the band, or outside [0, T), carry exactly -1e9 and pass none to q or k
(a fully masked row still reaches dv of its window keys); the global
columns pass gradients to all of q, kg and vg. This is the VJP of the
reference composite `_local_rows_xla`.

`sliding_backward_plain` is what CPU tensors take; `flash_sliding_backward`
is kernel K3 (``csrc/flash_sliding_bwd.cu``) for CUDA tensors, three
passes that each own their outputs (dq; dk, dv; dkg, dvg, whose splits of
the query rows are summed in a fixed order), so two runs give the same
bits. They run on the tensor cores, bf16 as bf16 MMAs and f32 (the
retriever's encoders) as split-TF32 MMAs that keep f32 accuracy, and
skip what adds exactly nothing: a 64-row tile whose dO is all zero (the
model's padded rows and its valid global rows, whose outputs the encoder
zeroes or overwrites; the test is on dO itself, a NaN counts and -0.0
does not) gets dq = 0 and is skipped by the other two passes; and a band
key tile that the key bias masks whole is skipped for rows that each
have an open column (only a fully masked row, uniform over its window,
still reaches it).
"""

from __future__ import annotations

import ctypes

import torch

from .flash_sliding import _DTYPE_CODE, GRANULE, MAX_GLOBALS, NEG_INF, _scale


def _window_fold(xw: torch.Tensor, t: int, w: int) -> torch.Tensor:
    """Adjoint of `sliding_attention._window_kv`: [B, nh, nb, 3w, d] →
    [B, nh, T, d], summing each position's three window slots."""
    b, nh, nb, _, d = xw.shape
    xp = xw.new_zeros((b, nh, t + 2 * w, d))
    for i in range(3):
        xp[:, :, i * w: i * w + t] += xw[:, :, :, i * w:(i + 1) * w].reshape(b, nh, t, d)
    return xp[:, :, w: w + t]


def sliding_backward_plain(q, k, v, key_bias, kg, vg, g_bias, do, m, l, delta, window):
    """Plain PyTorch version: (dq, dk, dv, dkg, dvg) in the inputs' dtypes."""
    from .sliding_attention import _window_kv

    b, nh, t, dh = q.shape
    w = window
    nb = t // w
    scale = _scale(dh)
    dev = q.device

    qs = q.float() * scale
    qb = qs.reshape(b, nh, nb, w, dh)
    kw = _window_kv(k.float(), nb, w)
    vw = _window_kv(v.float(), nb, w)
    delta_k = (torch.arange(3 * w, device=dev)[None, :] - w
               - torch.arange(w, device=dev)[:, None])
    k_pos = ((torch.arange(nb, device=dev)[:, None] - 1) * w
             + torch.arange(3 * w, device=dev)[None, :])
    ok = ((delta_k.abs() <= w)[None, None, None]
          & ((k_pos >= 0) & (k_pos < t))[None, None, :, None, :])
    kb_w = _window_kv(key_bias[:, None, :, None].float(), nb, w)[..., 0]
    band = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kw)
    band = torch.where(ok, band + kb_w[:, :, :, None, :],
                       torch.tensor(NEG_INF, device=dev))
    glog = torch.einsum("bhqd,bhgd->bhqg", qs, kg.float()) + g_bias.float()[:, None, None, :]

    blk = lambda x: x.reshape(b, nh, nb, w, 1)  # noqa: E731
    row = lambda x: x.reshape(b, nh, t, 1)  # noqa: E731
    pb = torch.exp(band - blk(m)) / blk(l)
    pg = torch.exp(glog - row(m)) / row(l)
    dof = do.float()
    dob = dof.reshape(b, nh, nb, w, dh)
    dsb = pb * (torch.einsum("bhnqd,bhnkd->bhnqk", dob, vw) - blk(delta))
    dsb = torch.where(ok, dsb, torch.zeros((), device=dev))
    dsg = pg * (torch.einsum("bhqd,bhgd->bhqg", dof, vg.float()) - row(delta))

    dq = (torch.einsum("bhnqk,bhnkd->bhnqd", dsb, kw).reshape(b, nh, t, dh)
          + torch.einsum("bhqg,bhgd->bhqd", dsg, kg.float())) * scale
    dk = _window_fold(torch.einsum("bhnqk,bhnqd->bhnkd", dsb, qb), t, w)
    dv = _window_fold(torch.einsum("bhnqk,bhnqd->bhnkd", pb, dob), t, w)
    dkg = torch.einsum("bhqg,bhqd->bhgd", dsg, qs)
    dvg = torch.einsum("bhqg,bhqd->bhgd", pg, dof)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkg.to(kg.dtype),
            dvg.to(vg.dtype))


def flash_sliding_backward(q, k, v, key_bias, kg, vg, g_bias, do, m, l, delta, *,
                           window):
    """Kernel K3. Same arguments and results as `sliding_backward_plain`;
    needs dh in {32, 64, 128}, 1 <= G <= 128, T a multiple of the window
    and the window a multiple of 32, in f32 and bf16 alike."""
    from .cuda_build import check, load

    b, nh, t, dh = q.shape
    g = kg.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_sliding_backward needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} is not f32/bf16")
    for name, x in (("k", k), ("v", v), ("dO", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype})")
    for name, x in (("kg", kg), ("vg", vg)):
        if x.shape != (b, nh, g, dh) or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name} must be {q.dtype} [{b}, {nh}, {g}, {dh}]")
    if key_bias.shape != (b, t) or g_bias.shape != (b, g):
        raise ValueError("key_bias must be [B, T] and g_bias [B, G]")
    if key_bias.dtype != torch.float32 or g_bias.dtype != torch.float32:
        raise TypeError("key_bias and g_bias must be f32")
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        if x.shape != (b * nh, 1, t) or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name} must be f32 [{b * nh}, 1, {t}] on {dev}")
    if not 1 <= g <= MAX_GLOBALS:
        raise ValueError(f"G={g} must lie in [1, {MAX_GLOBALS}]")
    if dh not in (32, 64, 128):
        raise ValueError(f"head dim {dh} not in (32, 64, 128)")
    if t % window or window % GRANULE:
        raise ValueError(f"T={t} must be a multiple of window={window}, and the "
                         f"window a multiple of {GRANULE}")

    q, k, v, kg, vg, do = (x.contiguous() for x in (q, k, v, kg, vg, do))
    key_bias, g_bias, m, l, delta = (x.contiguous() for x in (key_bias, g_bias, m, l, delta))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dkg = torch.empty(kg.shape, dtype=torch.float32, device=dev)
    dvg = torch.empty(vg.shape, dtype=torch.float32, device=dev)
    # one flag per 64-row tile: does its dO hold a nonzero
    live = torch.empty((b * nh, -(-t // 64)), dtype=torch.int32, device=dev)
    lib = load("flash_sliding_bwd")
    lib.sliding_bwd_splits.restype = ctypes.c_int
    lib.sliding_bwd_splits.argtypes = [ctypes.c_int] * 4
    # the dkg/dvg partials of each split of the query rows, when pass 3
    # splits them
    splits = lib.sliding_bwd_splits(dh, b * nh, t, g)
    part = torch.empty((splits, 2, b * nh, g, dh) if splits > 1 else (0,),
                       dtype=torch.float32, device=dev)
    fn = lib.sliding_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), kg.data_ptr(),
        vg.data_ptr(), g_bias.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dkg.data_ptr(),
        dvg.data_ptr(), live.data_ptr(), part.data_ptr(), splits, _DTYPE_CODE[q.dtype], b,
        nh, t, dh, window, g, _scale(dh),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "flash_sliding_backward")
    flash_sliding_backward.launches += 1
    return dq, dk, dv, dkg.to(kg.dtype), dvg.to(vg.dtype)


flash_sliding_backward.launches = 0
