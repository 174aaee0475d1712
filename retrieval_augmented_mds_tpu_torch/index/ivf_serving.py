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
``csrc/ivf_probe_topk.cu`` through the custom op ``ramds::ivf_probe_topk``
(its fake for an export's trace, its implementation the plan and the
launch); there is no fallback. The kernel groups the
probes by cluster itself, so that a cluster several queries probe is read
once; the wrapper plans its row splits from the layout it reports
(`_plan`).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.mips_topk import _DTYPE_CODE, MAX_K, _distinct_topk, _query_dtype
from .ivf import IVFIndex, _select, _spill_hits, prepare_queries, probe_clusters

INT_MAX = 2**31 - 1  # the position of an empty hit
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


# waves of CTAs when the probes outnumber the card's CTA slots: runs that
# serve several queries take longer than the rest, and short CTAs let the
# block scheduler even them out
_WAVES = 4


def _plan(b: int, p: int, L: int, sms: int, layout) -> tuple[int, int]:
    """K8's layout → (cluster rows per split, splits).

    ``layout()`` = (queries per chunk, cluster rows per tile, shared bytes,
    CTAs per SM) of the kernel instance, as the kernel reports it (0 CTAs:
    it does not fit). If each of the B·nprobe probes read its own cluster,
    one wave of CTAs would fill the card's ``sms`` x CTAs-per-SM slots when
    the probes are fewer than the slots, and ``_WAVES`` waves otherwise;
    the splits are whole tiles, at least two of them."""
    _, tile, _, per_sm = layout()
    if per_sm <= 0:
        raise RuntimeError(f"K8 does not fit an SM: {layout()}")
    slots, n_tiles = sms * per_sm, -(-L // tile)
    want = slots // (b * p) if b * p <= slots else -(-_WAVES * slots // (b * p))
    splits = min(max(1, n_tiles // 2), max(1, want))
    rows = -(-n_tiles // splits) * tile
    return rows, -(-L // rows)


def _check_k8(q, clustered, bias, scale, probes, k):
    """Raise on what K8 does not take (shapes, types, devices: nothing that
    reads a pointer, so it runs on the fake tensors of an export too)."""
    if clustered.dtype not in _DTYPE_CODE:
        raise TypeError(f"payload dtype {clustered.dtype} is not f32/bf16/int8")
    b, d = q.shape
    c, L, d2 = clustered.shape
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


def _ivf_probe_topk_launch(q: torch.Tensor, clustered: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor | None, probes: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's launch, the implementation of the custom op
    ``ramds::ivf_probe_topk``: ``q`` already in the kernel's query type,
    the arguments checked by `_check_k8`. Checks the payload's alignment,
    plans the row splits from the card's layout, launches on the current
    stream, counts the launch."""
    from ..ops.cuda_build import check, load
    from ..ops.mips_topk import _kernel_layout, _sm_count

    b, d = q.shape
    L = clustered.shape[1]
    p = probes.shape[1]
    dev = q.device
    if clustered.data_ptr() % 16:
        raise ValueError("clustered must be 16-byte aligned")
    code = _DTYPE_CODE[clustered.dtype]
    qk = q.contiguous()
    rows, splits = _plan(b, p, L, _sm_count(dev), lambda: _kernel_layout(
        "ivf_probe_topk", dev.index, code, k))
    part_v = torch.empty((b * p, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b * p, splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    pos = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = load("ivf_probe_topk").ivf_probe_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    err = fn(
        qk.data_ptr(), clustered.data_ptr(), code, bias.data_ptr(),
        None if scale is None else scale.data_ptr(), probes.data_ptr(), b, p, L, d, k,
        rows, splits, part_v.data_ptr(),
        part_i.data_ptr(), vals.data_ptr(), pos.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "ivf_probe_topk")
    ivf_probe_topk.launches += 1
    return vals, pos


_ivf_probe_topk_op = torch.library.custom_op("ramds::ivf_probe_topk", _ivf_probe_topk_launch,
                                             mutates_args=(), device_types="cuda")


@_ivf_probe_topk_op.register_fake
def _(q, clustered, bias, scale, probes, k):
    b = q.shape[0]
    return (q.new_empty((b, k), dtype=torch.float32),
            q.new_empty((b, k), dtype=torch.int32))


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
    `ivf_probe_topk_plain`; CUDA tensors the kernel through the custom op
    ``ramds::ivf_probe_topk`` (``ivf_probe_topk.launches`` counts its
    launches)."""
    if q.device.type == "cpu":
        return ivf_probe_topk_plain(q, clustered, bias, scale, probes, k)
    if q.device.type != "cuda":
        raise ValueError(f"ivf_probe_topk has no kernel for device {q.device}")
    _check_k8(q, clustered, bias, scale, probes, k)
    return _ivf_probe_topk_op(q.to(_query_dtype(clustered)), clustered, bias, scale,
                              probes, k)


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
