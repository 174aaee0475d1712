"""Exact (flat) MIPS index, on one device or row-sharded over a mesh.

Counterpart of ``retrieval_augmented_mds_tpu/index/flat.py``. Metrics:
"ip" (optionally row-normalized) and "l2" (served by the same top-k
through row_bias = -‖e‖²/2). On one device the MIPS kernel masks ragged
edges itself, so an index built here carries no padding rows; an index
loaded from the JAX package keeps its padded rows, whose bias is -3e38
so they are never retrieved. The on-disk format is shared with the JAX
package (``embeddings.npy``, ``row_bias.npy``, ``row_scale.npy``,
``meta.json``), so either package loads the other's index.

With a mesh of S > 1 shards (`parallel.mesh`), N is padded to a multiple
of S × ``row_align`` and shard rank s keeps rows [s·N_pad/S,
(s+1)·N_pad/S) (``shards`` = S). A search runs the MIPS kernel on the
local rows with the ignore ids shifted by the shard's offset, offsets the
hits to global ids, gathers every shard's top-k over the ``shard`` group
and merges them (`merge_topk`), as the JAX package's ``shard_map`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..ops.mips_topk import NEG_INF, mips_topk, quantize_corpus_sq8


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def topk_stable(vals: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order) → (values, indices int64)."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def merge_topk(vals_s: torch.Tensor, ids_s: torch.Tensor, k: int):
    """[S, B, k'] per-shard candidates → the global top-k [B, k], over the
    candidates laid out shard-major; equal values keep the lower position,
    so the lower shard (the JAX package's ``_merge_topk``). K1's
    distinct-value rule holds within a shard only: one value may come from
    two shards."""
    s, b, kk = vals_s.shape
    vals = vals_s.permute(1, 0, 2).reshape(b, s * kk)
    ids = ids_s.permute(1, 0, 2).reshape(b, s * kk)
    top, pos = topk_stable(vals, k)
    return top, torch.gather(ids, 1, pos)


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    embeddings: torch.Tensor  # [N_rows, D] bf16 / f32 / int8 (SQ8)
    row_bias: torch.Tensor  # [N_rows] f32 (-3e38 on padding rows)
    row_scale: torch.Tensor | None  # [N_rows] f32 dequant scales (SQ8 only)
    n: int  # real rows (of the whole index)
    metric: str
    normalized: bool
    shards: int = 1  # > 1: the rows are this mesh rank's part of S

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "f32": torch.float32, "int8": torch.int8}


def build_flat_index(
    embeddings,  # [N, D] tensor or array
    *,
    metric: str = "ip",
    normalize: bool = False,
    dtype=torch.bfloat16,
    device=None,
    mesh=None,
    row_align: int = 2048,
) -> FlatIndex:
    """The index of ``embeddings``; with a ``mesh`` of S > 1 shards, this
    rank's rows of the padded index (the module's docstring)."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    x = torch.as_tensor(embeddings, device=device).float()
    n = x.shape[0]
    shards = 1 if mesh is None else mesh.shard
    if shards > 1:
        rows = round_up(n, shards * row_align) // shards
        x = x[mesh.s * rows:(mesh.s + 1) * rows]
    if normalize:
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    if metric == "l2":
        bias = -0.5 * (x * x).sum(dim=-1)
    else:
        bias = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    row_scale = None
    if dtype == torch.int8:
        emb, row_scale = quantize_corpus_sq8(x)
    else:
        emb = x.to(dtype)
    if shards > 1:  # padding rows: zero, scale 1, never retrieved
        pad = rows - x.shape[0]
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        bias = torch.nn.functional.pad(bias, (0, pad), value=NEG_INF)
        if row_scale is not None:
            row_scale = torch.nn.functional.pad(row_scale, (0, pad), value=1.0)
    return FlatIndex(embeddings=emb.contiguous(), row_bias=bias.contiguous(),
                     row_scale=row_scale, n=n, metric=metric,
                     normalized=normalize, shards=shards)


def search(
    index: FlatIndex,
    queries: torch.Tensor,  # [B, D] (un-normalized; normalized here if needed)
    k: int = 10,
    ignore: torch.Tensor | None = None,  # [B, I] int32 corpus ids, -1 pad
    *,
    mesh=None,
):
    """Top-k search → (scores f32 [B, k], ids int32 [B, k]). A sharded
    index needs its ``mesh``: every rank of a ``shard`` group searches its
    rows and gets the merged top-k of the group."""
    if index.shards > 1 and (mesh is None or mesh.shard != index.shards):
        raise ValueError(f"an index sharded {index.shards} ways needs a mesh of "
                         f"{index.shards} shards, got {mesh and mesh.shard}")
    b, d = queries.shape
    q = queries.float()
    if index.normalized and index.metric == "ip":
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    if d != index.dim:  # index saved with padded columns
        q = torch.nn.functional.pad(q, (0, index.dim - d))
    if index.shards == 1:
        if ignore is not None:
            ignore = ignore.to(torch.int32).contiguous()
        return mips_topk(q.contiguous(), index.embeddings, k, index.row_bias,
                         ignore, index.row_scale)
    from ..parallel.collectives import gather_stack

    offset = mesh.s * index.embeddings.shape[0]
    if ignore is not None:  # ids of other shards fall outside the local rows
        ignore = (ignore.to(torch.int32) - offset).contiguous()
    vals, ids = mips_topk(q.contiguous(), index.embeddings, k, index.row_bias,
                          ignore, index.row_scale)
    ids = torch.where(ids >= 0, ids + offset, torch.full_like(ids, -1))
    return merge_topk(gather_stack(vals, mesh.shard_group),
                      gather_stack(ids, mesh.shard_group), k)


def save_flat_index(index: FlatIndex, path: str) -> None:
    if index.shards > 1:
        raise ValueError("a sharded index holds one rank's rows; save the whole index")
    os.makedirs(path, exist_ok=True)
    emb = index.embeddings
    if emb.dtype != torch.int8:
        emb = emb.float()
    np.save(os.path.join(path, "embeddings.npy"), emb.cpu().numpy())
    np.save(os.path.join(path, "row_bias.npy"), index.row_bias.cpu().numpy())
    if index.row_scale is not None:
        np.save(os.path.join(path, "row_scale.npy"), index.row_scale.cpu().numpy())
    dtype = {torch.int8: "int8", torch.bfloat16: "bfloat16",
             torch.float32: "float32"}[index.embeddings.dtype]
    meta = {"n": index.n, "metric": index.metric,
            "normalized": index.normalized, "dtype": dtype}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_flat_index(path: str, *, device=None, mesh=None) -> FlatIndex:
    """A saved flat index; with a ``mesh`` of S > 1 shards, this rank's
    rows (the saved rows padded to a multiple of S), read alone."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "int8" in meta["dtype"]:
        dtype = torch.int8
    elif "bfloat16" in meta["dtype"]:
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    emb = np.load(os.path.join(path, "embeddings.npy"), mmap_mode="r")
    bias = np.load(os.path.join(path, "row_bias.npy"), mmap_mode="r")
    scale_path = os.path.join(path, "row_scale.npy")
    scale = np.load(scale_path, mmap_mode="r") if os.path.exists(scale_path) else None
    shards = 1 if mesh is None else mesh.shard
    rows = lo = pad = 0
    if shards > 1:
        rows = -(-emb.shape[0] // shards)
        lo = mesh.s * rows
        pad = rows - len(emb[lo:lo + rows])
        emb, bias = emb[lo:lo + rows], bias[lo:lo + rows]
        scale = None if scale is None else scale[lo:lo + rows]

    def tensor(a, value=0.0):
        t = torch.from_numpy(np.array(a))
        return torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 2 else (0, pad),
                                       value=value) if pad else t

    return FlatIndex(
        embeddings=tensor(emb).to(dtype).to(device).contiguous(),
        row_bias=tensor(bias, NEG_INF).float().to(device).contiguous(),
        row_scale=None if scale is None else tensor(scale, 1.0).to(device),
        n=meta["n"], metric=meta["metric"], normalized=meta["normalized"],
        shards=shards,
    )
