"""Attention rows of one cached decoder step: the self-attention over the
KV cache and the cross-attention over the encoder's precomputed K/V heads.

No TPU kernel has this function: the JAX package's cached decoder step is
XLA einsums (``retrieval_augmented_mds_tpu/models/core.py`` ``attention``).
`models.core.attention` sends a cached call on the card here when its
mask holds one value per key (`core.decode_key_mask`). q [g·B, nh, T, dh]
holds the g beams of each of the B items of k/v [B, nh, S, dh] (g = 1 for
the self-attention, whose cache is per beam), and ``key_mask`` [B or 1, S]
(bool) says which keys every row of an item sees. Each row attends, in one softmax, to the S
keys, scored q·k/sqrt(dh) where the mask holds and exactly -1e9 where it
does not, so a row with no open key is uniform over the S keys.

`flash_decode_plain` is the plain version, with the arithmetic of
`core.attention`'s plain path: f32 logits of the operands' exact products,
an f32 softmax, its weights rounded to the operands' dtype for the product
with v. A CPU call never comes here: `core.attention` runs that path
itself. A CUDA tensor takes `flash_decode_attention`: the kernel in
``csrc/flash_decode.cu``, through the custom op ``ramds::flash_decode``
(which an export traces through its fake), in bf16 or f32 (split TF32),
reading k and v in place through their strides; no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_sliding import _DTYPE_CODE, NEG_INF, _scale

HEAD_DIMS = (32, 64, 128)


def flash_decode_plain(q, k, v, key_mask):
    """Plain version: out [g·B, nh, T, dh] in q's dtype."""
    bq, nh, t, dh = q.shape
    b, s = k.shape[0], k.shape[2]
    g = bq // b
    # the beams fold into the query axis: [B, nh, g·T, dh] against un-expanded k/v
    qf = q.reshape(b, g, nh, t, dh).permute(0, 2, 1, 3, 4).reshape(b, nh, g * t, dh)
    logits = torch.matmul(qf.float(), k.float().transpose(-1, -2)) / dh ** 0.5
    logits = logits.masked_fill(~key_mask.reshape(-1, 1, 1, s), NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w, v.to(q.dtype))
    return out.reshape(b, nh, g, t, dh).permute(0, 2, 1, 3, 4).reshape(bq, nh, t, dh)


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: its last dim contiguous and every other
    stride, and the pointer, a multiple of 16 bytes. The decoder's q, k and
    v already are (heads split from a [B, T, H] projection, or the cache);
    anything else is copied."""
    per = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % per == 0 for st in x.stride()[:-1]))
    return x if ok else x.contiguous()


def decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on arguments `flash_decode_attention` checked →
    out [g·B, T, nh, dh] (heads merged), on the current stream, counted; the
    implementation of the custom op ``ramds::flash_decode``."""
    from .cuda_build import check, load

    bq, nh, t, dh = q.shape
    b, s = k.shape[0], k.shape[2]
    dev = q.device
    q, k, v = (_kernel_view(x) for x in (q, k, v))
    if key_mask.stride(-1) != 1:
        key_mask = key_mask.contiguous()
    mask_b = key_mask.stride(0) if key_mask.shape[0] > 1 else 0
    out = torch.empty((bq, t, nh, dh), dtype=q.dtype, device=dev)
    strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v)]
    fn = load("flash_decode").flash_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), strides[0], k.data_ptr(), strides[1], v.data_ptr(), strides[2],
             key_mask.data_ptr(), mask_b, out.data_ptr(), _DTYPE_CODE[q.dtype], dh, b, nh,
             bq // b, t, s, _scale(dh), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


_decode_op = torch.library.custom_op("ramds::flash_decode", decode_launch, mutates_args=(),
                                     device_types="cuda")


@_decode_op.register_fake
def _(q, k, v, key_mask):
    bq, nh, t, dh = q.shape
    return q.new_empty((bq, t, nh, dh))


def flash_decode_attention(q, k, v, key_mask):
    """The kernel, through the custom op: the same arguments and result as
    `flash_decode_plain`, the result a view of a [g·B, T, nh, dh] tensor
    (the heads' merge into [g·B, T, nh·dh] is then free)."""
    bq, nh, t, dh = q.shape
    b, s = k.shape[0], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_attention needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} is not f32/bf16")
    for name, x in (("k", k), ("v", v)):
        if x.shape != (b, nh, s, dh) or x.dtype != q.dtype or x.device != dev:
            raise ValueError(f"{name} must be {q.dtype} [{b}, {nh}, S, {dh}] on {dev}")
    if bq % b or min(t, s) < 1:
        raise ValueError(f"q batch {bq} must be a multiple of {b}, and T, S at least 1")
    if key_mask.dtype != torch.bool or key_mask.shape not in ((1, s), (b, s)):
        raise ValueError(f"key_mask must be bool [1 or {b}, {s}]")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    return _decode_op(q, k, v, key_mask).permute(0, 2, 1, 3)


flash_decode_attention.launches = 0

