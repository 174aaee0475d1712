"""Per-query IVF search: the probe kernel K8 and its plain PyTorch version.

Counterpart of ``retrieval_augmented_mds_tpu/index/ivf_serving.py``. At
serving batch sizes each query reads exactly its own nprobe clusters
(B·nprobe·L·D bytes) instead of the whole corpus. Around the kernel the
steps are the JAX package's: normalize and pad the queries, score the
centroids in f32 and take the top nprobe probes, run the kernel, map each
probed-set position ``p·L + slot`` to its doc id, search the spill with
the MIPS kernel (always, on this route), merge, drop the ignored ids and
select the final top-k.

`ivf_probe_topk` routes by device: a CPU tensor takes
`ivf_probe_topk_plain`, a CUDA tensor the kernel in
``csrc/ivf_probe_topk.cu``; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.mips_topk import _DTYPE_CODE, MAX_K, _distinct_topk, _query_dtype
from .ivf import IVFIndex, _select, _spill_hits, prepare_queries, probe_clusters

INT_MAX = 2**31 - 1  # the position of an empty hit
_ROWS = 256  # csrc/ivf_probe_topk.cu kRows: cluster rows per block
_MAX_D = 8192  # csrc/ivf_probe_topk.cu kMaxD


def ivf_probe_scores_plain(q, clustered, bias, scale, probes):
    """Scores of every probed row → [B, nprobe·L] f32, position p·L + slot:
    (q · e) · scale + bias, the query rounded to bf16 for an int8 or bf16
    payload, products and sums in f32."""
    b, p = probes.shape
    L = clustered.shape[1]
    qf = q.to(_query_dtype(clustered)).float()
    e = clustered[probes.long()].float()  # [B, P, L, D]
    s = torch.bmm(e.reshape(b, p * L, -1), qf[:, :, None])[..., 0]
    if scale is not None:
        s = s * scale[probes.long()].reshape(b, p * L)
    return s + bias[probes.long()].reshape(b, p * L)


def ivf_probe_topk_plain(q, clustered, bias, scale, probes, k):
    """Plain version of K8: the [B, nprobe, L, D] gather, an f32 product and
    the distinct-value top-k (ties to the lowest position) → (values f32
    [B, k], positions int32 [B, k]); empty hits are (-3e38, INT_MAX)."""
    vals, pos = _distinct_topk(ivf_probe_scores_plain(q, clustered, bias, scale, probes), k)
    return vals, torch.where(pos < 0, torch.full_like(pos, INT_MAX), pos)


def _ivf_probe_topk_cuda(q, clustered, bias, scale, probes, k):
    from ..ops.cuda_build import check, load

    if clustered.dtype not in _DTYPE_CODE:
        raise TypeError(f"payload dtype {clustered.dtype} is not f32/bf16/int8")
    b, d = q.shape
    c, L, d2 = clustered.shape
    p = probes.shape[1]
    if d != d2 or d % 16 or d > _MAX_D:
        raise ValueError(f"query dim {d} vs payload dim {d2}: must match, be a "
                         f"multiple of 16 and at most {_MAX_D}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    dev = q.device
    if not clustered.is_contiguous() or clustered.device != dev:
        raise ValueError(f"clustered must be a contiguous [C, L, D] on {dev}")
    for name, t in (("bias", bias), ("scale", scale)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (c, L)
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [{c}, {L}] on {dev}")
    if (probes.dtype != torch.int32 or probes.shape[0] != b or probes.device != dev
            or not probes.is_contiguous()):
        raise ValueError(f"probes must be a contiguous int32 [{b}, nprobe] on {dev}")

    qk = q.to(_query_dtype(clustered)).float().contiguous()
    splits = -(-L // _ROWS)
    part_v = torch.empty((b, p * splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, p * splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    pos = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = load("ivf_probe_topk").ivf_probe_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
    err = fn(
        qk.data_ptr(), clustered.data_ptr(), _DTYPE_CODE[clustered.dtype],
        bias.data_ptr(), None if scale is None else scale.data_ptr(), probes.data_ptr(),
        b, p, L, d, k, splits, part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
        pos.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "ivf_probe_topk")
    ivf_probe_topk.launches += 1
    return vals, pos


def ivf_probe_topk(
    q: torch.Tensor,  # [B, D] f32
    clustered: torch.Tensor,  # [C, L, D] f32 / bf16 / int8
    bias: torch.Tensor,  # [C, L] f32 (-3e38 on pads)
    scale: torch.Tensor | None,  # [C, L] f32 (SQ8) or None
    probes: torch.Tensor,  # [B, nprobe] int32 cluster ids
    k: int,
):
    """Top-k distinct scores over each query's probed clusters →
    (values f32 [B, k], positions int32 [B, k]), a position being
    p·L + slot and a tie going to the lowest position. CPU tensors take
    `ivf_probe_topk_plain`; CUDA tensors the kernel
    (``ivf_probe_topk.launches`` counts its launches)."""
    if q.device.type == "cpu":
        return ivf_probe_topk_plain(q, clustered, bias, scale, probes, k)
    if q.device.type != "cuda":
        raise ValueError(f"ivf_probe_topk has no kernel for device {q.device}")
    return _ivf_probe_topk_cuda(q, clustered, bias, scale, probes, k)


ivf_probe_topk.launches = 0


def ivf_search_serving(
    index: IVFIndex,
    queries: torch.Tensor,  # [B, D]
    k: int = 10,
    nprobe: int = 8,
    ignore: torch.Tensor | None = None,  # [B, I] int32 global doc ids, -1 pad
):
    """Per-query probed search → (scores f32 [B, k], doc ids int32 [B, k]).
    With ``ignore`` (the reference's self-exclusion), k + I candidates are
    fetched, the ignored ids dropped after the spill merge, and the top-k
    selected again."""
    k_fetch = k + (0 if ignore is None else ignore.shape[1])
    if k_fetch > MAX_K:
        raise ValueError(f"k + ignore columns = {k_fetch} > {MAX_K}")
    L = index.clustered.shape[1]
    nprobe = min(nprobe, index.n_clusters)
    q = prepare_queries(index, queries)
    probes = probe_clusters(index, q, nprobe)
    vals, pos = ivf_probe_topk(q, index.clustered, index.clustered_bias,
                               index.clustered_scale, probes.to(torch.int32).contiguous(),
                               k_fetch)

    # probed-set positions → global doc ids
    p64 = pos.long()
    cluster = torch.gather(probes, 1, torch.clamp(p64 // L, 0, nprobe - 1))
    ids = index.clustered_ids[cluster, torch.clamp(p64 % L, 0, L - 1)]
    ids = torch.where(pos == INT_MAX, torch.full_like(ids, -1), ids)

    s_vals, s_ids = _spill_hits(index, q, k_fetch)
    if ignore is not None:
        ignore = ignore.to(torch.int32)
    return _select(torch.cat([vals, s_vals], dim=1), torch.cat([ids, s_ids], dim=1),
                   k, ignore)
