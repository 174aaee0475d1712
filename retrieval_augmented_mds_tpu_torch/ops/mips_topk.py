"""Exact MIPS top-k: the CUDA kernel and its plain PyTorch version.

Counterpart of ``retrieval_augmented_mds_tpu/ops/mips_topk.py``. Both
versions compute scores = (q . e) * row_scale + row_bias in f32, mask
columns >= N and the per-query ignore ids to -3e38, and return the top-k
DISTINCT score values in descending order, each with the lowest corpus
index holding it (bit-identical scores, e.g. duplicate rows, collapse to
one hit). Leftover slots are (-3e38, -1).

Routing is by device: a CPU tensor goes to `mips_topk_plain`, a CUDA
tensor to the kernel in ``csrc/mips_topk.cu`` through the custom op
``ramds::mips_topk`` (`torch.library`; its fake implementation gives the
shapes an export traces with, its implementation plans, launches and
counts); there is no fallback. Every
corpus is scored on the tensor cores (``csrc/mips_tile.cuh``): bf16 or int8
against bf16 queries, f32 against f32 queries in split TF32.

`mips_topk_blocked` is the JAX package's two-phase exact top-k, which no
path calls (there as here): phase 1 writes every score and the maximum
of every 128-column chunk (`mips_chunkmax`, kernel K10 in
``csrc/mips_chunkmax.cu``, or `mips_chunkmax_plain` on the CPU); phase 2,
plain PyTorch on both devices, keeps the top-k chunks and selects among
their columns. Unlike `mips_topk` it does not collapse equal scores.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = float(-3.0e38)
MAX_K = 128
CHUNK = 128  # columns per chunk maximum of `mips_topk_blocked`
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


def _cdiv(a: int, m: int) -> int:
    return -(-a // m)


def _query_group(b: int) -> int:
    """Queries per CTA asked of the tensor-core tile: 8, 16, 32 or 64."""
    for nq in (8, 16, 32):
        if b <= nq:
            return nq
    return 64


def _splits(b: int, n: int, sms: int, layout) -> tuple[int, int, int]:
    """A kernel's layout → (queries per CTA, corpus rows per split, splits).

    ``layout(nq)`` = (queries per CTA, corpus rows per tile, shared bytes,
    CTAs per SM) of the kernel's instance for groups of ``nq`` queries, as
    the kernel reports it (`_kernel_layout`; 0 CTAs: its shared memory does
    not fit). Takes the largest query group that fits (large k takes
    smaller ones; 8 always fits) and cuts the corpus into splits of whole
    tiles, enough (query group, split) CTAs to fill each of ``sms`` SMs
    once at that occupancy."""
    nq = _query_group(b)
    while True:
        nq, tile, _, per_sm = layout(nq)
        if per_sm > 0:
            break
        if nq <= 8:
            raise RuntimeError(f"no query group of the kernel fits an SM: {layout(nq)}")
        nq //= 2
    splits = min(_cdiv(n, tile), max(1, sms * per_sm // _cdiv(b, nq)))
    rows = _cdiv(_cdiv(n, splits), tile) * tile
    return nq, rows, _cdiv(n, rows)


@functools.lru_cache(maxsize=None)
def _kernel_layout(kernel: str, device: int, *args: int) -> tuple[int, int, int, int]:
    """``<kernel>_layout(*args)`` of csrc/<kernel>.cu on CUDA device
    ``device``: (queries per CTA, corpus rows per tile, shared bytes, CTAs
    per SM)."""
    from .cuda_build import check, load

    fn = getattr(load(kernel), f"{kernel}_layout")
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        check(fn(*[ctypes.c_int(a) for a in args], out), f"{kernel} layout")
    return tuple(out)


def _k1_plan(q: torch.Tensor, corpus: torch.Tensor, k: int) -> tuple[int, int, int, int]:
    """K1's layout for these CUDA tensors → (queries per CTA, rows per
    split, splits, vec)."""
    dev = q.device
    vec = int(_vec_ok(corpus.shape[1], q, corpus))
    code = _DTYPE_CODE[corpus.dtype]
    return (*_splits(q.shape[0], corpus.shape[0], _sm_count(dev), lambda nq: _kernel_layout(
        "mips_topk", dev.index, code, nq, vec, k)), vec)


def _vec_ok(d: int, *tensors: torch.Tensor) -> bool:
    """16-byte `cp.async` copies: every row stride a multiple of 16 bytes
    and every base pointer 16-byte aligned."""
    return all(d * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0 for t in tensors)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_k1(queries, corpus, k, row_bias, ignore, row_scale):
    """Raise on what K1 does not take (shapes, types, devices: nothing that
    reads a pointer, so it runs on the fake tensors of an export too)."""
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


def _mips_topk_launch(q: torch.Tensor, corpus: torch.Tensor, k: int,
                      row_bias: torch.Tensor | None, ignore: torch.Tensor | None,
                      row_scale: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's launch, the implementation of the custom op ``ramds::mips_topk``:
    ``q`` already in the kernel's query type (bf16 for a bf16 or int8
    corpus, f32 for an f32 one), the arguments checked by `_check_k1`.
    Plans the splits from the tensors' pointers and the card's layout,
    launches on the current stream, counts the launch."""
    from .cuda_build import check, load

    b, d = q.shape
    n = corpus.shape[0]
    dev = q.device
    q = q.contiguous()
    nq, rows, splits, vec = _k1_plan(q, corpus, k)
    part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = load("mips_topk")
    fn = lib.mips_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 5
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(
        q.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype],
        ptr(row_bias), ptr(row_scale), ptr(ignore),
        0 if ignore is None else ignore.shape[1], b, n, d, k, nq, vec, rows, splits,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "mips_topk")
    mips_topk.launches += 1
    return vals, ids


_mips_topk_op = torch.library.custom_op("ramds::mips_topk", _mips_topk_launch,
                                        mutates_args=(), device_types="cuda")


@_mips_topk_op.register_fake
def _(q, corpus, k, row_bias, ignore, row_scale):
    b = q.shape[0]
    return (q.new_empty((b, k), dtype=torch.float32),
            q.new_empty((b, k), dtype=torch.int32))


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
    kernel through the custom op ``ramds::mips_topk``
    (``mips_topk.launches`` counts its launches)."""
    if queries.device.type == "cpu":
        return mips_topk_plain(queries, corpus, k, row_bias, ignore, row_scale)
    if queries.device.type != "cuda":
        raise ValueError(f"mips_topk has no kernel for device {queries.device}")
    _check_k1(queries, corpus, k, row_bias, ignore, row_scale)
    return _mips_topk_op(queries.to(_query_dtype(corpus)), corpus, k, row_bias, ignore,
                         row_scale)


mips_topk.launches = 0


def quantize_corpus_sq8(corpus: torch.Tensor):
    """Per-row symmetric int8 quantization (FAISS SQ8 analog):
    (int8 values [N, D], scales [N] f32) with corpus ≈ values · scales."""
    x = corpus.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# the two-phase (chunk-max) exact top-k
# ---------------------------------------------------------------------------

def _chunked(n: int) -> int:
    """N rounded up to whole chunks."""
    return -(-n // CHUNK) * CHUNK


def mips_chunkmax_plain(
    queries: torch.Tensor,  # [B, D]
    corpus: torch.Tensor,  # [N, D] f32 / bf16
    row_bias: torch.Tensor | None = None,  # [N] f32
    ignore: torch.Tensor | None = None,  # [B, I] int32, -1 = none
):
    """Plain version of phase 1: (scores [B, N_pad], chunk maxima
    [B, N_pad / 128]) in f32, N_pad = N rounded up to 128; columns >= N and
    the ignored ids are -3e38."""
    b = queries.shape[0]
    n = corpus.shape[0]
    scores = torch.full((b, _chunked(n)), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    s = queries.to(corpus.dtype).float() @ corpus.float().T
    if row_bias is not None:
        s = s + row_bias.float()[None, :]
    scores[:, :n] = s
    if ignore is not None:
        ign = ignore.long()
        hit = (ign >= 0) & (ign < n)
        rows = torch.arange(b, device=ign.device)[:, None].expand_as(ign)
        scores[rows[hit], ign[hit]] = NEG_INF
    return scores, scores.reshape(b, -1, CHUNK).amax(dim=-1)


def mips_chunkmax(queries, corpus, row_bias=None, ignore=None):
    """Kernel K10: (scores, chunk maxima), as `mips_chunkmax_plain`."""
    from .cuda_build import check, load

    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype {corpus.dtype} is not f32/bf16")
    b, d = queries.shape
    n, d2 = corpus.shape
    dev = queries.device
    if dev.type != "cuda" or corpus.device != dev:
        raise ValueError(f"mips_chunkmax needs CUDA tensors on one device, got {dev}")
    if d != d2:
        raise ValueError(f"query dim {d} != corpus dim {d2}")
    if not corpus.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if row_bias is not None and (row_bias.dtype != torch.float32 or row_bias.shape != (n,)
                                 or row_bias.device != dev or not row_bias.is_contiguous()):
        raise ValueError(f"row_bias must be a contiguous f32 [{n}] on {dev}")
    if ignore is not None and (ignore.dtype != torch.int32 or ignore.dim() != 2
                               or ignore.shape[0] != b or ignore.device != dev
                               or not ignore.is_contiguous()):
        raise ValueError(f"ignore must be a contiguous int32 [{b}, I] on {dev}")
    n_pad = _chunked(n)
    q = queries.to(corpus.dtype).contiguous()
    vec = int(_vec_ok(d, q, corpus))
    code = _DTYPE_CODE[corpus.dtype]
    nq, rows, splits = _splits(b, n, _sm_count(dev), lambda nq: _kernel_layout(
        "mips_chunkmax", dev.index, code, nq, vec))
    scores = torch.empty((b, n_pad), dtype=torch.float32, device=dev)
    cmax = torch.empty((b, n_pad // CHUNK), dtype=torch.float32, device=dev)
    fn = load("mips_chunkmax").mips_chunkmax_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(q.data_ptr(), corpus.data_ptr(), code, ptr(row_bias), ptr(ignore),
             0 if ignore is None else ignore.shape[1], b, n, d, n_pad, nq, vec, rows, splits,
             scores.data_ptr(), cmax.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mips_chunkmax")
    mips_chunkmax.launches += 1
    return scores, cmax


mips_chunkmax.launches = 0


def chunk_topk(scores: torch.Tensor, cmax: torch.Tensor, k: int):
    """Phase 2: the top-k chunks by their maxima, then the top-k of their
    columns → (vals f32 [B, k], ids int32 [B, k]). Exact: at most k chunks
    hold a top-k score. Equal scores stay separate hits and ties go to the
    lowest column (stable descending sorts over columns in index order);
    slots of -3e38 get id -1."""
    b, n_chunks = cmax.shape
    kc = min(k, n_chunks)
    if kc * CHUNK < k:
        raise ValueError(f"k={k} exceeds the {kc * CHUNK} columns of the corpus")
    top = torch.sort(cmax, dim=1, descending=True, stable=True).indices[:, :kc]
    chunks = torch.sort(top, dim=1).values  # columns in index order
    cols = (chunks[:, :, None] * CHUNK
            + torch.arange(CHUNK, device=cmax.device)).reshape(b, kc * CHUNK)
    vals, pos = torch.sort(torch.gather(scores, 1, cols), dim=1, descending=True,
                           stable=True)
    vals = vals[:, :k]
    ids = torch.gather(cols, 1, pos[:, :k]).to(torch.int32)
    return vals, torch.where(vals <= NEG_INF / 2, torch.full_like(ids, -1), ids)


def mips_topk_blocked(queries, corpus, k: int = 10, row_bias=None, ignore=None):
    """Exact top-k by the two-phase algorithm → (vals f32 [B, k], ids int32
    [B, k]), sorted by descending score. Phase 1 takes `mips_chunkmax_plain`
    for CPU tensors and the kernel (``mips_chunkmax.launches``) for CUDA
    tensors; phase 2 is `chunk_topk` on both."""
    if queries.device.type == "cpu":
        scores, cmax = mips_chunkmax_plain(queries, corpus, row_bias, ignore)
    else:
        scores, cmax = mips_chunkmax(queries, corpus, row_bias, ignore)
    return chunk_topk(scores, cmax, k)
