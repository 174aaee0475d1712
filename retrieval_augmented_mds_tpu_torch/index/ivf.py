"""IVF clustered MIPS index: k-means, probed search, and its mesh sharding.

Counterpart of ``retrieval_augmented_mds_tpu/index/ivf.py``. The analog
of the reference's FAISS IVF factories (``IVF256,SQ8`` at
sotasum/config.yaml:94, ``nprobe`` at sotasum/mips.py:342-345): Lloyd
iterations are plain matmuls, and the clustered corpus is one fixed-shape
``[C, L, D]`` tensor on the device (clusters padded to a common capacity
L, overflow rows kept in an always-searched spill buffer, so no document
is dropped).

`ivf_search` takes the JAX package's four routes, in its order:

1. B·nprobe ≥ C with a flat sibling payload: the flat search over it;
2. B·nprobe ≥ C: every cluster and the spill scanned by the MIPS kernel;
3. the per-query route (`ivf_serving.ivf_search_serving`, kernel K8) when
   k + I ≤ 128, unless ``serving=False``;
4. the union probe: the batch's probed clusters gathered once and
   searched, with the spill, by the MIPS kernel.

Over a mesh (`parallel.mesh`), `shard_ivf_index` keeps shard rank s's
clusters [s·C/S, (s+1)·C/S) and the whole centroids and spill, and
`ivf_search_sharded` probes on every rank, searches the rank's partition
(all of it, or the probed clusters it owns) with the MIPS kernel, merges
the shards' candidates, then the spill's, and masks the ignore ids last.
A search whose queries are this data rank's rows of a batch split over
``data`` (``data_sharded``) decides its route by the whole batch, B·D,
and unions the whole batch's probes, as the JAX package does under `jit`,
where the queries of every data rank are one array.

One deliberate difference from the JAX package: the assignment of the
whole corpus to the final centroids is chunked like k-means' own, where
the JAX ``build_ivf_index`` makes one [N, C] f32 score matrix (4 GB at
N = 1M, C = 1024). The chunks give the same assignment.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..ops.mips_topk import MAX_K, NEG_INF, mips_topk
from .flat import (  # noqa: F401
    FlatIndex,
    build_flat_index,
    load_flat_index,
    merge_topk,
    round_up,
    save_flat_index,
    topk_stable,
)
from .flat import search as flat_search

ASSIGN_CHUNK = 8192  # corpus rows per score matrix in k-means and assignment


# ---------------------------------------------------------------------------
# k-means (Lloyd): matmul assignments, chunked one-hot updates
# ---------------------------------------------------------------------------

def assign_clusters(x: torch.Tensor, cent: torch.Tensor,
                    chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest centroid of every row in L2 → [N] int64, ``chunk`` rows at a
    time. ‖x−c‖² is smallest where x·c − ‖c‖²/2 is largest (one matmul and
    a row bias); ties go to the lowest centroid."""
    bias = -0.5 * (cent * cent).sum(dim=-1)
    return torch.cat([torch.argmax(xc @ cent.T + bias[None, :], dim=-1)
                      for xc in torch.split(x, chunk)])


def kmeans(
    x: torch.Tensor,  # [N, D] f32
    n_clusters: int,
    iters: int = 15,
    chunk: int = ASSIGN_CHUNK,
    *,
    generator: torch.Generator | None = None,
    init: torch.Tensor | None = None,
):
    """L2 k-means → (centroids [C, D] f32, assignments [N] int64).

    The initial centroids are ``init`` when given, else C distinct rows
    drawn with ``generator`` (a CPU generator: the draw is the same on
    every device). An empty cluster keeps its centroid."""
    n, d = x.shape
    if n < n_clusters:
        raise ValueError(f"k-means of {n} rows into {n_clusters} clusters")
    if init is None:
        pick = torch.randperm(n, generator=generator)[:n_clusters]
        cent = x[pick.to(x.device)].clone()
    else:
        cent = torch.as_tensor(init, dtype=torch.float32, device=x.device).clone()
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(n_clusters, dtype=x.dtype, device=x.device)
        for xc in torch.split(x, chunk):
            onehot = torch.nn.functional.one_hot(
                assign_clusters(xc, cent, chunk), n_clusters).to(x.dtype)
            sums += onehot.T @ xc
            counts += onehot.sum(dim=0)
        cent = torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts[:, None], min=1), cent)
    return cent, assign_clusters(x, cent, chunk)


# ---------------------------------------------------------------------------
# Index construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IVFIndex:
    centroids: torch.Tensor  # [C, D_pad] f32
    centroid_bias: torch.Tensor  # [C] f32 (metric bias for probing)
    clustered: torch.Tensor  # [C, L, D_pad] rows grouped by cluster
    clustered_ids: torch.Tensor  # [C, L] int32 global doc ids (-1 pad)
    clustered_bias: torch.Tensor  # [C, L] f32 (metric row bias; -3e38 on pads)
    spill: torch.Tensor  # [S, D_pad] overflow rows (always searched)
    spill_ids: torch.Tensor  # [S] int32
    spill_bias: torch.Tensor  # [S] f32
    n: int
    metric: str
    normalized: bool
    clustered_scale: torch.Tensor | None = None  # [C, L] f32 (SQ8 payloads)
    spill_scale: torch.Tensor | None = None  # [S] f32
    # flat sibling of the same payload in row order: B·nprobe ≥ C searches
    # take it instead of scanning the padded clustered layout
    flat: FlatIndex | None = None
    # exact overflow-row count from packing; 0 skips the scan-all and
    # union-probe routes' spill search; -1 = unknown
    n_spill: int = -1
    # > 1: the clustered fields hold this mesh rank's C / shards clusters
    shards: int = 1

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]


def _pack(x, assign, *, n_clusters, cap, spill_cap, d_pad, metric, sq8, payload):
    """Inverted lists: sort the rows by cluster (stable), number them within
    their cluster, and scatter the first ``cap`` of each into
    ``[C, cap, D_pad]``, the rest, in the same order, into the spill. Row
    biases and SQ8 scales come from the f32 rows before the scatter, so the
    clustered buffer is allocated at payload width."""
    n, d = x.shape
    dev = x.device
    xp = torch.nn.functional.pad(x.float(), (0, d_pad - d))
    if metric == "l2":
        row_bias = -0.5 * (xp * xp).sum(dim=-1)
    else:
        row_bias = torch.zeros(n, dtype=torch.float32, device=dev)
    row_scale = None
    if sq8:
        row_scale = torch.clamp(xp.abs().amax(dim=-1), min=1e-12) / 127.0
        xq = torch.clamp(torch.round(xp / row_scale[:, None]), -127, 127).to(torch.int8)
    else:
        xq = xp.to(payload)
    del xp

    order = torch.argsort(assign, stable=True)
    sorted_a = assign[order]
    starts = torch.searchsorted(sorted_a, torch.arange(n_clusters, device=dev))
    pos = torch.arange(n, device=dev) - starts[sorted_a]
    in_cap = pos < cap
    over = (~in_cap).nonzero(as_tuple=True)[0]
    n_over = int(over.numel())
    kept = in_cap.nonzero(as_tuple=True)[0]
    dc, dp = sorted_a[kept], pos[kept]
    src_kept, src_over = order[kept], order[over[:spill_cap]]

    clustered = torch.zeros((n_clusters, cap, d_pad), dtype=xq.dtype, device=dev)
    clustered[dc, dp] = xq[src_kept]
    cids = torch.full((n_clusters, cap), -1, dtype=torch.int32, device=dev)
    cids[dc, dp] = src_kept.to(torch.int32)
    cl_bias = torch.full((n_clusters, cap), NEG_INF, dtype=torch.float32, device=dev)
    cl_bias[dc, dp] = row_bias[src_kept]

    m = src_over.numel()
    spill = torch.zeros((spill_cap, d_pad), dtype=xq.dtype, device=dev)
    spill[:m] = xq[src_over]
    sids = torch.full((spill_cap,), -1, dtype=torch.int32, device=dev)
    sids[:m] = src_over.to(torch.int32)
    sp_bias = torch.full((spill_cap,), NEG_INF, dtype=torch.float32, device=dev)
    sp_bias[:m] = row_bias[src_over]

    cl_scale = sp_scale = None
    if sq8:
        cl_scale = torch.ones((n_clusters, cap), dtype=torch.float32, device=dev)
        cl_scale[dc, dp] = row_scale[src_kept]
        sp_scale = torch.ones((spill_cap,), dtype=torch.float32, device=dev)
        sp_scale[:m] = row_scale[src_over]
    return clustered, cids, cl_bias, spill, sids, sp_bias, cl_scale, sp_scale, n_over


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "f32": torch.float32,
           "int8": torch.int8}


def build_ivf_index(
    embeddings,  # [N, D] tensor or array
    n_clusters: int,
    *,
    metric: str = "ip",
    normalize: bool = False,
    dtype=torch.bfloat16,
    alpha: float = 1.5,  # cluster capacity = alpha * N / C, in whole 8-row tiles
    train_size: int | None = None,  # k-means sample (reference mips_train_size)
    iters: int = 15,
    seed: int = 0,
    spill_cap: int | None = None,  # overflow capacity; None = the exact count
    keep_flat: bool | None = None,  # flat sibling; None = when payload <= 384 MB
    init: torch.Tensor | None = None,  # k-means' initial centroids; None = drawn
    device=None,
) -> IVFIndex:
    """k-means over ``train_size`` rows drawn with ``seed`` (all rows when
    None), then every row assigned to its nearest centroid and packed.
    ``dtype`` int8 stores SQ8 payloads with per-row scales."""
    dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    x = torch.as_tensor(embeddings, device=device).float()
    n, d = x.shape
    if normalize:
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

    gen = torch.Generator().manual_seed(seed)
    train = x
    if train_size is not None and train_size < n:
        train = x[torch.randperm(n, generator=gen)[:train_size].to(x.device)]
    cent, _ = kmeans(train, n_clusters, iters=iters, generator=gen, init=init)
    assign = assign_clusters(x, cent)

    cap = max(8, round_up(int(alpha * n / n_clusters), 8))
    d_pad = round_up(d, 128)
    if spill_cap is None:
        # the exact overflow count, bucketed to powers of two
        counts = torch.bincount(assign, minlength=n_clusters)
        n_over = int(torch.clamp(counts - cap, min=0).sum())
        spill_cap = 64
        while spill_cap < n_over:
            spill_cap *= 2
    sq8 = dtype == torch.int8
    (clustered, cids, cl_bias, spill, sids, sp_bias, cl_scale, sp_scale,
     n_over) = _pack(x, assign, n_clusters=n_clusters, cap=cap, spill_cap=spill_cap,
                     d_pad=d_pad, metric=metric, sq8=sq8, payload=dtype)
    if n_over > spill_cap:
        raise ValueError(f"cluster overflow {n_over} exceeds spill capacity "
                         f"{spill_cap}; raise alpha or spill_cap")

    cent_pad = torch.nn.functional.pad(cent, (0, d_pad - d))
    if metric == "l2":
        cent_bias = -0.5 * (cent_pad * cent_pad).sum(dim=-1)
    else:
        cent_bias = torch.zeros(n_clusters, dtype=torch.float32, device=x.device)

    if keep_flat is None:
        itemsize = 1 if sq8 else torch.finfo(dtype).bits // 8
        keep_flat = n * d_pad * itemsize <= 384 * 2**20
    flat = None
    if keep_flat:
        # x is normalized above when asked; the sibling normalizes queries
        flat = dataclasses.replace(
            build_flat_index(x, metric=metric, normalize=False, dtype=dtype),
            normalized=normalize)
    return IVFIndex(
        centroids=cent_pad.contiguous(), centroid_bias=cent_bias, clustered=clustered,
        clustered_ids=cids, clustered_bias=cl_bias, spill=spill, spill_ids=sids,
        spill_bias=sp_bias, clustered_scale=cl_scale, spill_scale=sp_scale, n=n,
        metric=metric, normalized=normalize, flat=flat, n_spill=n_over,
    )


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def prepare_queries(index: IVFIndex, queries: torch.Tensor) -> torch.Tensor:
    """f32 queries, normalized for a normalized "ip" index, zero-padded to
    the index's width."""
    q = queries.float()
    if index.normalized and index.metric == "ip":
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.nn.functional.pad(q, (0, index.dim - q.shape[1])).contiguous()


def probe_clusters(index: IVFIndex, q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The ``nprobe`` best centroids of every query → [B, nprobe] int64."""
    return topk_stable(q @ index.centroids.T + index.centroid_bias[None, :], nprobe)[1]


def union_pad(flat_ids: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
    """Unique ids of a flat int tensor, ascending, padded with ``sentinel``
    to ``cap``."""
    u = torch.unique(flat_ids)[:cap]
    return torch.nn.functional.pad(u, (0, cap - u.numel()), value=sentinel)


def _mask_ignored(vals, gids, ignore):
    if ignore is None:
        return vals
    bad = (gids[:, :, None] == ignore[:, None, :].to(gids.dtype)).any(-1)
    return torch.where(bad, torch.full_like(vals, NEG_INF), vals)


def _select(vals, gids, k, ignore):
    """Ignore mask, top-k (ties to the lower candidate), -1 for empty hits."""
    vals, sel = topk_stable(_mask_ignored(vals, gids, ignore), k)
    got = torch.gather(gids, 1, sel)
    return vals, torch.where(vals > NEG_INF / 2, got, torch.full_like(got, -1))


def _spill_hits(index: IVFIndex, q, k_fetch):
    """The spill's top hits by the MIPS kernel → (values, global ids)."""
    v, p = mips_topk(q, index.spill, min(k_fetch, index.spill.shape[0]),
                     index.spill_bias, None, index.spill_scale)
    ids = index.spill_ids[p.clamp(min=0).long()]
    return v, torch.where(p >= 0, ids, torch.full_like(ids, -1))


def _scan_all_clusters(index: IVFIndex, q, k, ignore):
    """Exact search of the clustered layout, viewed as one [C·L, D] corpus,
    and the spill, each by the MIPS kernel, then merged."""
    c, L, d_pad = index.clustered.shape
    kk = k + (0 if ignore is None else ignore.shape[1])
    scale = None if index.clustered_scale is None else index.clustered_scale.reshape(-1)
    v1, p1 = mips_topk(q, index.clustered.reshape(c * L, d_pad), kk,
                       index.clustered_bias.reshape(-1), None, scale)
    ids = index.clustered_ids.reshape(-1)
    g1 = torch.where(p1 >= 0, ids[p1.clamp(min=0).long()], torch.full_like(p1, -1))
    if index.n_spill == 0:
        vals, gids = v1, g1
    else:
        v2, g2 = _spill_hits(index, q, kk)
        vals, gids = torch.cat([v1, v2], dim=1), torch.cat([g1, g2], dim=1)
    return _select(vals, gids, k, ignore)


def _batch_probes(index: IVFIndex, q, nprobe, mesh, data_sharded):
    """The probes of the whole batch [B·D or B, nprobe]: with
    ``data_sharded``, every data rank's, gathered in rank order."""
    probes = probe_clusters(index, q, nprobe)
    if not data_sharded:
        return probes
    from ..parallel.collectives import gather_cat

    return gather_cat(probes, mesh.data_group)


def _union_probe(index: IVFIndex, q, k, nprobe, ignore, mesh=None, data_sharded=False):
    """The batch's probed clusters, unioned and gathered once, searched with
    the spill by the MIPS kernel."""
    c = index.n_clusters
    probes = _batch_probes(index, q, nprobe, mesh, data_sharded)
    cap = min(c, probes.numel())
    union = union_pad(probes.reshape(-1), cap, sentinel=c)
    in_union = union < c
    safe = torch.where(in_union, union, torch.zeros_like(union))
    L, d_pad = index.clustered.shape[1:]
    corpus = index.clustered[safe].reshape(cap * L, d_pad)
    bias = torch.where(in_union[:, None], index.clustered_bias[safe],
                       torch.full((cap, L), NEG_INF, device=q.device)).reshape(-1)
    ids = index.clustered_ids[safe].reshape(-1)
    scale = (None if index.clustered_scale is None
             else index.clustered_scale[safe].reshape(-1))
    if index.n_spill != 0:
        corpus = torch.cat([corpus, index.spill.to(corpus.dtype)])
        bias = torch.cat([bias, index.spill_bias])
        ids = torch.cat([ids, index.spill_ids])
        if scale is not None:
            scale = torch.cat([scale, index.spill_scale])
    kk = k + (0 if ignore is None else ignore.shape[1])
    vals, pos = mips_topk(q, corpus.contiguous(), kk, bias.contiguous(), None,
                          None if scale is None else scale.contiguous())
    gids = torch.where(pos >= 0, ids[pos.clamp(min=0).long()], torch.full_like(pos, -1))
    return _select(vals, gids, k, ignore)


def ivf_search(
    index: IVFIndex,
    queries: torch.Tensor,  # [B, D]
    k: int = 10,
    nprobe: int = 8,
    ignore: torch.Tensor | None = None,  # [B, I] int32 global doc ids, -1 pad
    *,
    serving: bool | None = None,
    mesh=None,
    data_sharded: bool = False,
):
    """Probed search → (scores f32 [B, k], doc ids int32 [B, k]).

    ``serving`` pins the per-query route on (None, the default, as on the
    TPU) or off (False: the union probe); the B·nprobe ≥ C routes come
    first either way. ``data_sharded``: the queries are this rank's rows of
    a batch split over the ``mesh``'s data axis; the route and the union
    are the whole batch's."""
    if index.shards > 1:
        raise ValueError("a sharded IVF index is searched by ivf_search_sharded")
    b = queries.shape[0] * (mesh.data if data_sharded else 1)
    route = ivf_route(index, b, k, nprobe, 0 if ignore is None else ignore.shape[1],
                      serving)
    if route == "flat":
        # ids are in row order, so this equals a flat index of the payload
        return flat_search(index.flat, queries, k=k, ignore=ignore)
    nprobe = min(nprobe, index.n_clusters)
    if ignore is not None:
        ignore = ignore.to(torch.int32)
    if route == "per_query":
        from .ivf_serving import ivf_search_serving

        return ivf_search_serving(index, queries, k=k, nprobe=nprobe, ignore=ignore)
    q = prepare_queries(index, queries)
    if route == "scan_all":
        return _scan_all_clusters(index, q, k, ignore)
    return _union_probe(index, q, k, nprobe, ignore, mesh, data_sharded)


def ivf_route(index: IVFIndex, b: int, k: int, nprobe: int, n_ignore: int = 0,
              serving: bool | None = None) -> str:
    """The route `ivf_search` takes for a batch of ``b`` queries (the whole
    batch, over every data rank) and ``n_ignore`` ignore columns: "flat",
    "scan_all", "per_query" or "union_probe"."""
    nprobe = min(nprobe, index.n_clusters)
    if b * nprobe >= index.n_clusters:
        return "flat" if index.flat is not None else "scan_all"
    if serving is not False and k + n_ignore <= MAX_K:
        return "per_query"
    return "union_probe"


# ---------------------------------------------------------------------------
# Over a mesh: clusters partitioned over the shard axis
# ---------------------------------------------------------------------------

def shard_ivf_index(index: IVFIndex, mesh) -> IVFIndex:
    """This rank's part of ``index``: clusters [s·C/S, (s+1)·C/S) of the
    clustered payload; the centroids, their bias and the spill whole; no
    flat sibling (the partition is scanned in place). C must divide into
    the S shards."""
    s_n = mesh.shard
    c = index.n_clusters
    if c % s_n:
        raise ValueError(f"{c} clusters do not split into {s_n} shards")
    part = slice(mesh.s * c // s_n, (mesh.s + 1) * c // s_n)
    take = lambda t: None if t is None else t[part].contiguous()  # noqa: E731
    return dataclasses.replace(
        index, clustered=take(index.clustered), clustered_ids=take(index.clustered_ids),
        clustered_bias=take(index.clustered_bias),
        clustered_scale=take(index.clustered_scale), flat=None, shards=s_n)


def owned_probed_rows(index: IVFIndex, probes: torch.Tensor, s: int):
    """The rows of shard rank ``s``'s clusters among ``probes`` (the whole
    batch's, [B, nprobe] global cluster ids), unioned and gathered once:
    (corpus [cap·L, D_pad], bias [cap·L] with -3e38 on unused slots, doc
    ids [cap·L], SQ8 scales [cap, L] or None), cap = min(C/S, B·nprobe)."""
    c_local, L, d_pad = index.clustered.shape
    mine = probes - s * c_local
    mine = torch.where((mine >= 0) & (mine < c_local), mine, torch.full_like(mine, c_local))
    cap = min(c_local, probes.numel())
    union = union_pad(mine.reshape(-1), cap, sentinel=c_local)
    ok = union < c_local
    safe = torch.where(ok, union, torch.zeros_like(union))
    corpus = index.clustered[safe].reshape(cap * L, d_pad)
    bias = torch.where(ok[:, None], index.clustered_bias[safe],
                       torch.full((cap, L), NEG_INF, device=probes.device)).reshape(-1)
    ids = index.clustered_ids[safe].reshape(-1)
    scale = None if index.clustered_scale is None else index.clustered_scale[safe]
    return corpus, bias, ids, scale


def ivf_search_sharded(
    index: IVFIndex,
    queries: torch.Tensor,  # [B, D]
    mesh,
    k: int = 10,
    nprobe: int = 8,
    ignore: torch.Tensor | None = None,  # [B, I] int32 global doc ids, -1 pad
    *,
    data_sharded: bool = False,
):
    """Probed search over a cluster-partitioned index (`shard_ivf_index`)
    → (scores f32 [B, k], doc ids int32 [B, k]), the same on every rank of
    a ``shard`` group. Every rank probes the whole centroid set; when the
    batch (B·D with ``data_sharded``) times nprobe reaches C it scans its
    whole partition, else the union of the batch's probed clusters that it
    owns. Each rank fetches k + I candidates with the MIPS kernel; they are
    merged over the shard group (`merge_topk`), then with the spill's, and
    the ignore ids (the reference's self-exclusion) are masked only then,
    before the final top-k."""
    kk = k + (0 if ignore is None else ignore.shape[1])
    c = index.n_clusters
    nprobe = min(nprobe, c)
    q = prepare_queries(index, queries)
    c_local, L, d_pad = index.clustered.shape
    b = q.shape[0] * (mesh.data if data_sharded else 1)
    if b * nprobe >= c:
        corpus = index.clustered.reshape(c_local * L, d_pad)
        bias = index.clustered_bias.reshape(-1)
        ids = index.clustered_ids.reshape(-1)
        scale = index.clustered_scale
    else:
        corpus, bias, ids, scale = owned_probed_rows(
            index, _batch_probes(index, q, nprobe, mesh, data_sharded), mesh.s)
    vals, pos = mips_topk(q, corpus.contiguous(), kk, bias.contiguous(), None,
                          None if scale is None else scale.reshape(-1).contiguous())
    gids = torch.where(pos >= 0, ids[pos.clamp(min=0).long()], torch.full_like(pos, -1))
    from ..parallel.collectives import gather_stack

    vals, gids = merge_topk(gather_stack(vals, mesh.shard_group),
                            gather_stack(gids, mesh.shard_group), kk)
    v2, g2 = _spill_hits(index, q, kk)
    return _select(torch.cat([vals, v2], dim=1), torch.cat([gids, g2], dim=1), k,
                   None if ignore is None else ignore.to(torch.int32))


# ---------------------------------------------------------------------------
# Persistence: the JAX package's layout (ivf.npz, meta.json, flat/)
# ---------------------------------------------------------------------------

_IVF_ARRAYS = (
    "centroids", "centroid_bias", "clustered", "clustered_ids",
    "clustered_bias", "spill", "spill_ids", "spill_bias",
)
_DTYPE_NAMES = {torch.int8: "int8", torch.bfloat16: "bfloat16", torch.float32: "float32"}


def save_ivf_index(index: IVFIndex, path: str) -> None:
    if index.shards > 1:
        raise ValueError("a sharded index holds one rank's clusters; save the whole index")
    os.makedirs(path, exist_ok=True)

    def portable(t):
        # bf16 has no npz encoding: float payloads are stored as f32 (exact)
        # and their type restored from meta.json
        t = t.detach().cpu()
        return (t if t.dtype in (torch.int8, torch.int32) else t.float()).numpy()

    arrays = {name: portable(getattr(index, name)) for name in _IVF_ARRAYS}
    if index.clustered_scale is not None:
        arrays["clustered_scale"] = portable(index.clustered_scale)
        arrays["spill_scale"] = portable(index.spill_scale)
    np.savez(os.path.join(path, "ivf.npz"), **arrays)
    if index.flat is not None:
        save_flat_index(index.flat, os.path.join(path, "flat"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"kind": "ivf", "n": index.n, "metric": index.metric,
                   "normalized": index.normalized,
                   "payload_dtype": _DTYPE_NAMES[index.clustered.dtype],
                   "n_spill": index.n_spill}, f)


def load_ivf_index(path: str, *, device=None) -> IVFIndex:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "int8" in meta["payload_dtype"]:
        payload = torch.int8
    elif "bfloat16" in meta["payload_dtype"]:
        payload = torch.bfloat16
    else:
        payload = torch.float32
    data = np.load(os.path.join(path, "ivf.npz"))
    kw = {name: torch.from_numpy(data[name]).to(device) for name in _IVF_ARRAYS}
    kw["clustered"] = kw["clustered"].to(payload).contiguous()
    kw["spill"] = kw["spill"].to(payload).contiguous()
    if "clustered_scale" in data.files:
        kw["clustered_scale"] = torch.from_numpy(data["clustered_scale"]).to(device)
        kw["spill_scale"] = torch.from_numpy(data["spill_scale"]).to(device)
    flat_dir = os.path.join(path, "flat")
    if os.path.isdir(flat_dir):
        kw["flat"] = load_flat_index(flat_dir, device=device)
    return IVFIndex(n=meta["n"], metric=meta["metric"], normalized=meta["normalized"],
                    n_spill=meta.get("n_spill", -1), **kw)
