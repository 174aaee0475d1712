"""Dense attention rows with a [B, S] key bias, optionally causal: the
decoder's self- and cross-attention at training time.

Counterpart of ``retrieval_augmented_mds_tpu/ops/flash_dense.py``. Each
query row attends, in one softmax, to all S keys, scored
q·k/sqrt(dh) + key_bias (0 or -1e9), with keys after the row set to -1e9
when causal. A fully masked row (an all-padding source) comes out uniform
over its S keys, as the reference composite `_dense_xla` makes it.

`dense_rows` is the differentiable entry point (`DenseRows`). Up to
``MAX_S`` = 4096 keys, as the JAX package's single-pass kernels, its
forward saves the row max ``m`` and denominator ``l`` ([B*nh, 1, T] f32)
and its backward recomputes the probabilities from them with
delta = rowsum(dO * out): `flash_dense_attention` (K4) and
`flash_dense_backward` (K5). Above it, as the JAX package's blocked
kernels, the forward saves ``out`` and one log-sum-exp per row, and the
backward starts from them: `flash_dense_blocked` (K6) and
`flash_dense_blocked_backward` (K7). The only such call on a path is the
decoder's cross-attention over a source longer than 4096 tokens (the LED
takes 16384).

A fully masked row's LSE rounds to -1e9 in f32 (log S vanishes under the
ULP of 1e9), so exp(s - lse) would give each of its keys 1, not 1/S: the
JAX package's blocked backward does so. The port's blocked backward reads
such a row (lse <= -1e8) as the uniform row the composite's VJP gives.

Routing is by device: CPU tensors take the plain versions
(`dense_rows_plain`/`dense_backward_plain`,
`dense_rows_blocked_plain`/`dense_blocked_backward_plain`); CUDA tensors
the kernels in ``csrc/flash_dense_fwd.cu`` (K4, K6) and
``csrc/flash_dense_bwd.cu`` (K5, K7), which take any T and S; no
fallback. All four run on the tensor cores in both dtypes, one template
over the operand policy of ``csrc/attn_mma.cuh`` (bf16 MMAs, or in f32
split TF32: three TF32 MMAs per product, which keep f32 accuracy), and
skip the 64-key tiles that the bias masks whole for a block of rows that
each have an open key (exactly: such a tile adds nothing to their sums; a
block with a fully masked row walks every tile, as its uniform row
needs); K4 and K6 share one forward kernel, which writes m and l or the
LSE.
``key_bias`` gets a zero gradient.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_sliding import _DTYPE_CODE, NEG_INF, _scale, device_route, row_delta

# above this many keys the JAX package takes its blocked kernels
MAX_S = 4096
# a row whose LSE is at most this saw only -1e9 logits (csrc/attn_mma.cuh)
LSE_DEGENERATE = -1e8


def _logits(q, k, key_bias, causal):
    """Masked f32 logits [B, nh, T, S] and the causal keep-mask (or None)."""
    t, s = q.shape[2], k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * _scale(q.shape[-1]),
                          k.float()) + key_bias.float()[:, None, None, :]
    ok = None
    if causal:
        ok = (torch.arange(s, device=q.device)[None, :]
              <= torch.arange(t, device=q.device)[:, None])[None, None]
        logits = torch.where(ok, logits, torch.tensor(NEG_INF, device=q.device))
    return logits, ok


def dense_rows_plain(q, k, v, key_bias, causal: bool, return_stats: bool = False):
    """Plain PyTorch version (the reference's `_dense_xla`). q [B, nh, T, dh],
    k/v [B, nh, S, dh], key_bias [B, S]; with ``return_stats`` also m, l."""
    b, nh, t, _ = q.shape
    logits, _ = _logits(q, k, key_bias, causal)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", (e / l).to(v.dtype), v).to(q.dtype)
    if return_stats:
        return out, m.reshape(b * nh, 1, t), l.reshape(b * nh, 1, t)
    return out


def dense_backward_plain(q, k, v, key_bias, do, m, l, delta, causal: bool):
    """Plain backward from the forward's m, l and delta = rowsum(dO * out):
    (dq, dk, dv) in the inputs' dtypes. Causal-masked columns pass no
    gradient to q or k; the key bias is part of the logit."""
    b, nh, t, dh = q.shape
    scale = _scale(dh)
    logits, ok = _logits(q, k, key_bias, causal)
    stat = lambda x: x.reshape(b, nh, t, 1)  # noqa: E731
    p = torch.exp(logits - stat(m)) / stat(l)
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - stat(delta))
    if ok is not None:
        ds = torch.where(ok, ds, torch.zeros((), device=q.device))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dense_rows_blocked_plain(q, k, v, key_bias, causal: bool):
    """Plain version of the long-S forward: (out, lse [B*nh, 1, T] f32),
    lse = m + log l as the JAX package's `flash_dense_blocked` emits it."""
    out, m, l = dense_rows_plain(q, k, v, key_bias, causal, return_stats=True)
    return out, m + torch.log(l)


def _stats_from_lse(lse, s: int):
    """The (m, l) with exp(logit - m) / l = exp(logit - lse): (lse, 1) on a
    row with an open key; (-1e9, S) on a fully masked row, whose S logits
    are all exactly -1e9 (the uniform row; csrc/attn_mma.cuh `LseStats`)."""
    degenerate = lse <= LSE_DEGENERATE
    m = torch.where(degenerate, torch.full_like(lse, NEG_INF), lse)
    l = torch.where(degenerate, torch.full_like(lse, float(s)), torch.ones_like(lse))
    return m, l


def dense_blocked_backward_plain(q, k, v, key_bias, out, lse, g, causal: bool):
    """Plain version of the long-S backward from the forward's out and lse,
    with delta = rowsum(g * out) as the JAX package computes it:
    (dq, dk, dv) in the inputs' dtypes."""
    m, l = _stats_from_lse(lse, k.shape[2])
    return dense_backward_plain(q, k, v, key_bias, g, m, l, row_delta(g, out), causal)


def _check_inputs(name, q, k, v, key_bias):
    b, nh, t, dh = q.shape
    s = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} is not f32/bf16")
    for nm, x in (("k", k), ("v", v)):
        if x.shape != (b, nh, s, dh) or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{nm} must be {q.dtype} [{b}, {nh}, S, {dh}] on {dev}")
    if key_bias.shape != (b, s) or key_bias.dtype != torch.float32:
        raise ValueError(f"key_bias must be f32 [{b}, {s}]")
    if dh not in (32, 64, 128):
        raise ValueError(f"head dim {dh} not in (32, 64, 128)")
    if min(t, s) < 1:
        raise ValueError("T and S must be at least 1")


def flash_dense_attention(q, k, v, key_bias, *, causal: bool):
    """Kernel K4: (out, m, l), as `dense_rows_plain(..., return_stats=True)`."""
    from .cuda_build import check, load

    _check_inputs("flash_dense_attention", q, k, v, key_bias)
    b, nh, t, dh = q.shape
    s = k.shape[2]
    dev = q.device
    q, k, v, key_bias = (x.contiguous() for x in (q, k, v, key_bias))
    out = torch.empty_like(q)
    m = torch.empty((b * nh, 1, t), dtype=torch.float32, device=dev)
    l = torch.empty((b * nh, 1, t), dtype=torch.float32, device=dev)
    fn = load("flash_dense_fwd").dense_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), m.data_ptr(), l.data_ptr(), _DTYPE_CODE[q.dtype], b, nh,
             t, s, dh, int(causal), _scale(dh), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_dense_attention")
    flash_dense_attention.launches += 1
    return out, m, l


flash_dense_attention.launches = 0


def flash_dense_backward(q, k, v, key_bias, do, m, l, delta, *, causal: bool):
    """Kernel K5: (dq, dk, dv), as `dense_backward_plain`."""
    from .cuda_build import check, load

    _check_inputs("flash_dense_backward", q, k, v, key_bias)
    b, nh, t, dh = q.shape
    s = k.shape[2]
    dev = q.device
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)}")
    for nm, x in (("m", m), ("l", l), ("delta", delta)):
        if x.shape != (b * nh, 1, t) or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{nm} must be f32 [{b * nh}, 1, {t}] on {dev}")
    q, k, v, key_bias, do, m, l, delta = (
        x.contiguous() for x in (q, k, v, key_bias, do, m, l, delta))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = load("flash_dense_bwd").dense_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), do.data_ptr(),
             m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), _DTYPE_CODE[q.dtype], b, nh, t, s, dh, int(causal),
             _scale(dh), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_dense_backward")
    flash_dense_backward.launches += 1
    return dq, dk, dv


flash_dense_backward.launches = 0


def flash_dense_blocked(q, k, v, key_bias, *, causal: bool):
    """Kernel K6: (out, lse), as `dense_rows_blocked_plain`."""
    from .cuda_build import check, load

    _check_inputs("flash_dense_blocked", q, k, v, key_bias)
    b, nh, t, dh = q.shape
    s = k.shape[2]
    dev = q.device
    q, k, v, key_bias = (x.contiguous() for x in (q, k, v, key_bias))
    out = torch.empty_like(q)
    lse = torch.empty((b * nh, 1, t), dtype=torch.float32, device=dev)
    fn = load("flash_dense_fwd").dense_blocked_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], b, nh, t, s, dh, int(causal), _scale(dh),
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_dense_blocked")
    flash_dense_blocked.launches += 1
    return out, lse


flash_dense_blocked.launches = 0


def flash_dense_blocked_backward(q, k, v, key_bias, out, lse, g, *, causal: bool):
    """Kernel K7: (dq, dk, dv), as `dense_blocked_backward_plain`; delta =
    rowsum(g * out) is computed here, as the JAX package does outside its
    kernels."""
    from .cuda_build import check, load

    _check_inputs("flash_dense_blocked_backward", q, k, v, key_bias)
    b, nh, t, dh = q.shape
    s = k.shape[2]
    dev = q.device
    for nm, x in (("out", out), ("g", g)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{nm} must be {q.dtype} {tuple(q.shape)} on {dev}")
    if lse.shape != (b * nh, 1, t) or lse.dtype != torch.float32 or lse.device != dev:
        raise ValueError(f"lse must be f32 [{b * nh}, 1, {t}] on {dev}")
    delta = row_delta(g, out)
    q, k, v, key_bias, g, lse = (x.contiguous() for x in (q, k, v, key_bias, g, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = load("flash_dense_bwd").dense_blocked_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _DTYPE_CODE[q.dtype], b, nh, t, s, dh, int(causal), _scale(dh),
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_dense_blocked_backward")
    flash_dense_blocked_backward.launches += 1
    return dq, dk, dv


flash_dense_blocked_backward.launches = 0


class DenseRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal):
        ctx.causal = causal
        ctx.blocked = k.shape[2] > MAX_S
        if ctx.blocked:  # the backward starts from out and one LSE per row
            if device_route(q):
                out, lse = flash_dense_blocked(q, k, v, key_bias, causal=causal)
            else:
                out, lse = dense_rows_blocked_plain(q, k, v, key_bias, causal)
            ctx.save_for_backward(q, k, v, key_bias, out, lse)
            return out
        if device_route(q):
            out, m, l = flash_dense_attention(q, k, v, key_bias, causal=causal)
        else:
            out, m, l = dense_rows_plain(q, k, v, key_bias, causal, return_stats=True)
        ctx.save_for_backward(q, k, v, key_bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.blocked:
            q, k, v, key_bias, out, lse = ctx.saved_tensors
            if device_route(q):
                dq, dk, dv = flash_dense_blocked_backward(q, k, v, key_bias, out, lse, do,
                                                          causal=ctx.causal)
            else:
                dq, dk, dv = dense_blocked_backward_plain(q, k, v, key_bias, out, lse, do,
                                                          ctx.causal)
        else:
            q, k, v, key_bias, out, m, l = ctx.saved_tensors
            delta = row_delta(do, out)
            if device_route(q):
                dq, dk, dv = flash_dense_backward(q, k, v, key_bias, do, m, l, delta,
                                                  causal=ctx.causal)
            else:
                dq, dk, dv = dense_backward_plain(q, k, v, key_bias, do, m, l, delta,
                                                  ctx.causal)
        # key_bias is a padding mask: zero gradient on every path
        return dq, dk, dv, torch.zeros_like(key_bias), None


def dense_rows(q, k, v, key_bias, causal: bool):
    """Differentiable dense attention rows [B, nh, T, dh]."""
    return DenseRows.apply(q, k, v, key_bias, causal)
