"""Local-query rows of sliding-window + global attention (forward).

Counterpart of ``retrieval_augmented_mds_tpu/ops/flash_sliding.py``. Each
query row attends, in one softmax, to the keys of its band |k - q| <= w
(plus an additive key bias: 0 or -1e9) and to up to 128 gathered
global-token keys (plus g_bias). Besides the output, both versions can
return the softmax row max ``m`` and denominator ``l`` as [B*nh, 1, T]
f32, the residuals a fused backward consumes.

`sliding_local_rows` is the differentiable entry point (`SlidingRows`):
its forward saves out, m and l; its backward computes
delta = rowsum(dO * out) and calls the backward of
``flash_sliding_bwd.py`` (kernel K3 on the card). Routing is by device: a
CPU tensor goes to `local_rows_plain` and the plain backward, a CUDA
tensor to the kernels in ``csrc/flash_sliding_fwd.cu`` (K2, through the
custom op ``ramds::flash_sliding_fwd``, which an export traces through
its fake) and ``csrc/flash_sliding_bwd.cu`` (K3); no fallback. Both run on the tensor
cores, bf16 as bf16 MMAs and f32 (the retriever's encoders) as split-TF32
MMAs that keep f32 accuracy, and skip the band key tiles that
``key_bias`` masks whole for a block of rows that each have an open
column (K2 decides it from the inputs: the batch has a valid global, or a
key open to every row of the block). The masks ``key_bias`` and
``g_bias`` get zero gradients.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e9
MAX_GLOBALS = 128
# the kernels' window granule: a 64-row block spans at most two w-blocks
GRANULE = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(dh: int) -> float:
    # 1 / sqrt(dh) rounded as the reference rounds it (f32 sqrt, f32 divide)
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def local_rows_plain(q, k, v, key_bias, kg, vg, g_bias, window,
                     return_stats: bool = False):
    """Plain PyTorch version (the reference's XLA composite): each w-block
    of queries scores the 3w keys of blocks n-1, n, n+1; columns out of the
    band or outside [0, T) get -1e9, so a fully masked row is uniform over
    its 3w + G columns. q/k/v [B, nh, T, dh]; key_bias [B, T];
    kg/vg [B, nh, G, dh]; g_bias [B, G]."""
    from .sliding_attention import _window_kv

    b, nh, t, dh = q.shape
    w = window
    nb = t // w
    scale = _scale(dh)
    dev = q.device

    qb = q.float().reshape(b, nh, nb, w, dh) * scale
    kw = _window_kv(k.float(), nb, w)
    vw = _window_kv(v, nb, w)
    band = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kw)
    delta = (torch.arange(3 * w, device=dev)[None, :] - w
             - torch.arange(w, device=dev)[:, None])
    band_ok = (delta.abs() <= w)[None, None, None]
    k_pos = ((torch.arange(nb, device=dev)[:, None] - 1) * w
             + torch.arange(3 * w, device=dev)[None, :])
    pos_ok = ((k_pos >= 0) & (k_pos < t))[None, None, :, None, :]
    kb_w = _window_kv(key_bias[:, None, :, None].float(), nb, w)[..., 0]
    band = torch.where(band_ok & pos_ok, band + kb_w[:, :, :, None, :],
                       torch.tensor(NEG_INF, dtype=torch.float32, device=dev))

    glog = torch.einsum("bhqd,bhgd->bhqg", q.float() * scale, kg.float())
    glog = glog + g_bias.float()[:, None, None, :]
    logits = torch.cat([band, glog.reshape(b, nh, nb, w, -1)], dim=-1)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True)
    probs = e / l
    pb, pg = probs[..., : 3 * w], probs[..., 3 * w:]
    out = torch.einsum("bhnqk,bhnkd->bhnqd", pb.to(vw.dtype), vw)
    out = out.reshape(b, nh, t, dh) + torch.einsum(
        "bhqg,bhgd->bhqd", pg.reshape(b, nh, t, -1).to(vg.dtype), vg
    )
    out = out.to(q.dtype)
    if return_stats:
        return out, m.reshape(b * nh, 1, t), l.reshape(b * nh, 1, t)
    return out


def flash_sliding_attention(q, k, v, key_bias, kg, vg, g_bias, *, window,
                            return_stats: bool = False):
    """Kernel K2, through the custom op ``ramds::flash_sliding_fwd``. Same
    arguments and results as `local_rows_plain`; needs dh in {32, 64, 128},
    1 <= G <= 128, T a multiple of the window and the window a multiple of
    32 (as K3 takes it), in f32 and bf16 alike."""
    b, nh, t, dh = q.shape
    g = kg.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_sliding_attention needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} is not f32/bf16")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype})")
    for name, x in (("kg", kg), ("vg", vg)):
        if x.shape != (b, nh, g, dh) or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name} must be {q.dtype} [{b}, {nh}, {g}, {dh}]")
    if key_bias.shape != (b, t) or g_bias.shape != (b, g):
        raise ValueError("key_bias must be [B, T] and g_bias [B, G]")
    if key_bias.dtype != torch.float32 or g_bias.dtype != torch.float32:
        raise TypeError("key_bias and g_bias must be f32")
    if not 1 <= g <= MAX_GLOBALS:
        raise ValueError(f"G={g} must lie in [1, {MAX_GLOBALS}]")
    if dh not in (32, 64, 128):
        raise ValueError(f"head dim {dh} not in (32, 64, 128)")
    if t % window or window % GRANULE:
        raise ValueError(f"T={t} must be a multiple of window={window}, and the "
                         f"window a multiple of {GRANULE}")
    out, m, l = _sliding_fwd_op(q, k, v, key_bias, kg, vg, g_bias, window)
    if return_stats:
        return out, m, l
    return out


def sliding_fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_bias: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                       g_bias: torch.Tensor, window: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's launch on arguments `flash_sliding_attention` checked → (out, m,
    l), on the current stream, counted; the implementation of the custom
    op ``ramds::flash_sliding_fwd``, and a direct ctypes call when called
    by itself."""
    from .cuda_build import check, load

    b, nh, t, dh = q.shape
    g = kg.shape[2]
    dev = q.device
    q, k, v, kg, vg = (x.contiguous() for x in (q, k, v, kg, vg))
    key_bias, g_bias = key_bias.contiguous(), g_bias.contiguous()
    out = torch.empty_like(q)
    m = torch.empty((b * nh, 1, t), dtype=torch.float32, device=dev)
    l = torch.empty((b * nh, 1, t), dtype=torch.float32, device=dev)
    fn = load("flash_sliding_fwd").sliding_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        kg.data_ptr(), vg.data_ptr(), g_bias.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), _DTYPE_CODE[q.dtype], b, nh, t, dh,
        window, g, _scale(dh), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "flash_sliding_attention")
    flash_sliding_attention.launches += 1
    return out, m, l


_sliding_fwd_op = torch.library.custom_op("ramds::flash_sliding_fwd", sliding_fwd_launch,
                                          mutates_args=(), device_types="cuda")


@_sliding_fwd_op.register_fake
def _(q, k, v, key_bias, kg, vg, g_bias, window):
    b, nh, t, _ = q.shape
    stats = q.new_empty((b * nh, 1, t), dtype=torch.float32)
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device), stats,
            torch.empty_like(stats))


flash_sliding_attention.launches = 0


def device_route(x: torch.Tensor) -> bool:
    """True for the kernels (CUDA tensors), False for the plain versions
    (CPU tensors); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    return True


def row_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) as [B*nh, 1, T] f32: FlashAttention-2's
    identity for each row's sum_k p * dp."""
    b, nh, t, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(b * nh, 1, t)


class SlidingRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_bias, kg, vg, g_bias, window):
        if device_route(q):
            out, m, l = flash_sliding_attention(q, k, v, key_bias, kg, vg, g_bias,
                                                window=window, return_stats=True)
        else:
            out, m, l = local_rows_plain(q, k, v, key_bias, kg, vg, g_bias, window,
                                         return_stats=True)
        ctx.window = window
        ctx.save_for_backward(q, k, v, key_bias, kg, vg, g_bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        from .flash_sliding_bwd import flash_sliding_backward, sliding_backward_plain

        q, k, v, key_bias, kg, vg, g_bias, out, m, l = ctx.saved_tensors
        args = (q, k, v, key_bias, kg, vg, g_bias, do, m, l, row_delta(do, out))
        if device_route(q):
            dq, dk, dv, dkg, dvg = flash_sliding_backward(*args, window=ctx.window)
        else:
            dq, dk, dv, dkg, dvg = sliding_backward_plain(*args, ctx.window)
        # the masks carry no gradient on any path
        return (dq, dk, dv, torch.zeros_like(key_bias), dkg, dvg,
                torch.zeros_like(g_bias), None)


def sliding_local_rows(q, k, v, key_bias, kg, vg, g_bias, window):
    """Differentiable local-query rows [B, nh, T, dh]."""
    return SlidingRows.apply(q, k, v, key_bias, kg, vg, g_bias, window)
