"""Exact MIPS top-k: the CUDA kernel and its plain PyTorch version.

Counterpart of ``retrieval_augmented_mds_tpu/ops/mips_topk.py``. Both
versions compute scores = (q . e) * row_scale + row_bias in f32, mask
columns >= N and the per-query ignore ids to -3e38, and return the top-k
DISTINCT score values in descending order, each with the lowest corpus
index holding it (bit-identical scores, e.g. duplicate rows, collapse to
one hit). Leftover slots are (-3e38, -1).

Routing is by device: a CPU tensor goes to `mips_topk_plain`, a CUDA
tensor to the kernel in ``csrc/mips_topk.cu``; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = float(-3.0e38)
MAX_K = 128
_ROW_TILE = 256  # csrc/mips_topk.cu kRT
_QUERY_GROUP = 16  # csrc/mips_topk.cu kQB
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _query_dtype(corpus: torch.Tensor) -> torch.dtype:
    # int8 (SQ8) payloads are scored against bf16 queries
    return torch.bfloat16 if corpus.dtype == torch.int8 else corpus.dtype


def _distinct_topk(scores: torch.Tensor, k: int):
    """[B, N] f32 → (vals [B, k], ids [B, k]) under the distinct-value,
    lowest-index rule."""
    b, n = scores.shape
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=scores.device)
    sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    keep = first & (rank < k)
    rows, cols = keep.nonzero(as_tuple=True)
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=scores.device)
    ids = torch.full((b, k), -1, dtype=torch.int32, device=scores.device)
    vals[rows, rank[rows, cols]] = sv[rows, cols]
    ids[rows, rank[rows, cols]] = si[rows, cols].to(torch.int32)
    ids = torch.where(vals == neg, torch.full_like(ids, -1), ids)
    return vals, ids


def mips_topk_plain(
    queries: torch.Tensor,  # [B, D]
    corpus: torch.Tensor,  # [N, D] f32 / bf16 / int8
    k: int = 10,
    row_bias: torch.Tensor | None = None,  # [N] f32
    ignore: torch.Tensor | None = None,  # [B, I] int32, -1 = none
    row_scale: torch.Tensor | None = None,  # [N] f32 (SQ8 scales)
):
    """Plain PyTorch version: materializes the [B, N] scores. Products of
    the (rounded) operands are exact in f32, so computing them in f32
    gives the kernel's f32-accumulated dot products."""
    n = corpus.shape[0]
    q = queries.to(_query_dtype(corpus)).float()
    scores = q @ corpus.float().T
    if row_scale is not None:
        scores = scores * row_scale.float()[None, :]
    if row_bias is not None:
        scores = scores + row_bias.float()[None, :]
    if ignore is not None:
        ign = ignore.long()
        hit = (ign >= 0) & (ign < n)
        rows = torch.arange(ign.shape[0], device=ign.device)[:, None].expand_as(ign)
        scores[rows[hit], ign[hit]] = NEG_INF
    return _distinct_topk(scores, k)


def _splits(b: int, n: int) -> tuple[int, int]:
    """Corpus rows per CTA and the CTA count along N: enough CTAs for a few
    waves over 132 SMs, in whole 256-row tiles."""
    def cdiv(a, m):
        return -(-a // m)

    target = max(1, cdiv(1056, cdiv(b, _QUERY_GROUP)))
    splits = min(cdiv(n, _ROW_TILE), target)
    rows = cdiv(cdiv(n, splits), _ROW_TILE) * _ROW_TILE
    return rows, cdiv(n, rows)


def _mips_topk_cuda(queries, corpus, k, row_bias, ignore, row_scale):
    from .cuda_build import check, load

    if corpus.dtype not in _DTYPE_CODE:
        raise TypeError(f"corpus dtype {corpus.dtype} is not f32/bf16/int8")
    b, d = queries.shape
    n, d2 = corpus.shape
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    if not corpus.is_contiguous():
        raise ValueError("corpus must be contiguous")
    dev = queries.device
    for name, t, dt in (("row_bias", row_bias, torch.float32),
                        ("row_scale", row_scale, torch.float32)):
        if t is not None and (t.dtype != dt or t.shape != (n,)
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [{n}] on {dev}")
    if ignore is not None and (ignore.dtype != torch.int32 or ignore.dim() != 2
                               or ignore.shape[0] != b or ignore.device != dev
                               or not ignore.is_contiguous()):
        raise ValueError(f"ignore must be a contiguous int32 [{b}, I] on {dev}")
    if corpus.device != dev:
        raise ValueError("queries and corpus must be on the same device")

    q = queries.to(_query_dtype(corpus)).float().contiguous()
    rows, splits = _splits(b, n)
    part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = load("mips_topk")
    fn = lib.mips_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(
        q.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype],
        ptr(row_bias), ptr(row_scale), ptr(ignore),
        0 if ignore is None else ignore.shape[1], b, n, d, k, rows, splits,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "mips_topk")
    mips_topk.launches += 1
    return vals, ids


def mips_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
    row_bias: torch.Tensor | None = None,
    ignore: torch.Tensor | None = None,
    row_scale: torch.Tensor | None = None,
):
    """Exact top-k MIPS → (values f32 [B, k], ids int32 [B, k]), sorted by
    descending score. CPU tensors take `mips_topk_plain`; CUDA tensors the
    kernel (``mips_topk.launches`` counts its launches)."""
    if queries.device.type == "cpu":
        return mips_topk_plain(queries, corpus, k, row_bias, ignore, row_scale)
    if queries.device.type != "cuda":
        raise ValueError(f"mips_topk has no kernel for device {queries.device}")
    return _mips_topk_cuda(queries, corpus, k, row_bias, ignore, row_scale)


mips_topk.launches = 0


def quantize_corpus_sq8(corpus: torch.Tensor):
    """Per-row symmetric int8 quantization (FAISS SQ8 analog):
    (int8 values [N, D], scales [N] f32) with corpus ≈ values · scales."""
    x = corpus.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale
