"""The whole model's 8-bit AdamW update in one pass over the superleaf.

Counterpart of ``retrieval_augmented_mds_tpu/ops/adam8bit_update.py``:
dequantise the int8 first and uint8 (log2-affine) second moments of each
128-element block, take one AdamW step with the clip scale, requantise
per block under the ``nvalid`` mask, and return the update
``-lr * step`` beside the new state. Inputs and outputs are in the
superleaf layout of ``train/adam8bit.py``:

  g2 [NB, 128] f32 gradients;  mq int8 / nq uint8 [NB, 128] codes;
  ms / nlo / nhi [NB, 1] f32 block scales;  nv [NB, 1] int32 valid counts;
  p2 [NB, 128] f32 parameters, read only when wd != 0 (else None);
  scal [1, 4] f32 = (bias correction 1, bias correction 2, lr, clip scale).

→ (upd [NB, 128] f32, mq2, ms2, nq2, nlo2, nhi2).

`adam8bit_superleaf_update` routes by device: CPU tensors take
`adam8bit_superleaf_update_plain` (the JAX package's XLA composite, the
same expressions in the same association order); CUDA tensors take kernel
K9 (``csrc/adam8bit_update.cu``), or the call raises; no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..train.adam8bit import (
    _LOG_RANGE,
    _LOG_TINY,
    _TINY,
    BLOCK,
    dequantize_mu,
    dequantize_nu,
    quantize_mu,
    quantize_nu,
)


def adam8bit_superleaf_update_plain(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, *,
                                    b1: float, b2: float, eps: float, wd: float,
                                    out: torch.Tensor | None = None):
    """Plain PyTorch version; ``out`` as in `adam8bit_superleaf_update`."""
    bc1, bc2, lr, clip = (scal[:, i:i + 1] for i in range(4))
    mask = torch.arange(BLOCK, device=g2.device)[None, :] < nv
    g = g2 * clip
    mu = b1 * dequantize_mu(mq, ms) + (1.0 - b1) * g
    nu = b2 * dequantize_nu(nq, nlo, nhi) + (1.0 - b2) * g * g
    step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    if wd:
        step = step + wd * p2
    upd = -lr * step
    if out is not None:
        upd = out.copy_(upd)
    mq2, ms2 = quantize_mu(mu, mask)
    nq2, nlo2, nhi2 = quantize_nu(nu, mask)
    return upd, mq2, ms2, nq2, nlo2, nhi2


def _check(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, wd, out) -> None:
    nb = g2.shape[0]
    dev = g2.device
    want = [("g2", g2, torch.float32, (nb, BLOCK)), ("mu_q", mq, torch.int8, (nb, BLOCK)),
            ("mu_scale", ms, torch.float32, (nb, 1)), ("nu_q", nq, torch.uint8, (nb, BLOCK)),
            ("nu_lo", nlo, torch.float32, (nb, 1)), ("nu_hi", nhi, torch.float32, (nb, 1)),
            ("nvalid", nv, torch.int32, (nb, 1)), ("scal", scal, torch.float32, (1, 4))]
    if wd:
        want.append(("p2", p2, torch.float32, (nb, BLOCK)))
    if out is not None:
        want.append(("out", out, torch.float32, (nb, BLOCK)))
    for name, x, dtype, shape in want:
        if x is None or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{None if x is None else (x.dtype, tuple(x.shape))}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if x.shape[-1] == BLOCK and x.data_ptr() % (4 * x.element_size()):
            raise ValueError(f"{name} must be aligned to 4 elements (vector loads)")
    if nb < 1:
        raise ValueError("the superleaf needs at least one block")


def adam8bit_superleaf_update(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, *,
                              b1: float, b2: float, eps: float, wd: float,
                              out: torch.Tensor | None = None):
    """One 8-bit AdamW step over the superleaf (see the module docstring).
    ``out``, when given, is the [NB, 128] f32 tensor the update is written
    into; it may be ``g2`` itself (every gradient element is read before
    its update is written). Raises on a dtype, shape, device or layout
    that the kernel does not take, on either device. CUDA tensors launch
    kernel K9 (``adam8bit_superleaf_update.launches`` counts its
    launches)."""
    _check(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, wd, out)
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd, out=out)
    if g2.device.type == "cpu":
        return adam8bit_superleaf_update_plain(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, **kw)
    if g2.device.type != "cuda":
        raise ValueError(f"adam8bit_superleaf_update has no kernel for device {g2.device}")
    return _adam8bit_update_cuda(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, **kw)


adam8bit_superleaf_update.launches = 0


def _adam8bit_update_cuda(g2, mq, ms, nq, nlo, nhi, nv, p2, scal, *, b1, b2, eps, wd,
                          out):
    from .cuda_build import check, load

    nb = g2.shape[0]
    upd = torch.empty_like(g2) if out is None else out
    mq2, nq2 = torch.empty_like(mq), torch.empty_like(nq)
    ms2, nlo2, nhi2 = torch.empty_like(ms), torch.empty_like(nlo), torch.empty_like(nhi)
    fn = load("adam8bit_update").adam8bit_update_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_long] + [ctypes.c_float] * 9 \
        + [ctypes.c_void_p]
    # (1 - b) in double, then rounded to f32: the JAX package's weak-typed
    # Python constants
    err = fn(g2.data_ptr(), mq.data_ptr(), ms.data_ptr(), nq.data_ptr(), nlo.data_ptr(),
             nhi.data_ptr(), nv.data_ptr(), p2.data_ptr() if wd else None, scal.data_ptr(),
             upd.data_ptr(), mq2.data_ptr(), ms2.data_ptr(), nq2.data_ptr(),
             nlo2.data_ptr(), nhi2.data_ptr(), nb, b1, 1.0 - b1, b2, 1.0 - b2, eps,
             float(wd), _TINY, _LOG_TINY, _LOG_RANGE,
             torch.cuda.current_stream(g2.device).cuda_stream)
    check(err, "adam8bit_superleaf_update")
    adam8bit_superleaf_update.launches += 1
    return upd, mq2, ms2, nq2, nlo2, nhi2
