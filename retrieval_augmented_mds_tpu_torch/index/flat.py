"""Exact (flat) MIPS index on one device.

Counterpart of ``retrieval_augmented_mds_tpu/index/flat.py`` without the
mesh sharding. Metrics: "ip" (optionally row-normalized) and "l2" (served
by the same top-k through row_bias = -‖e‖²/2). The MIPS kernel masks
ragged edges itself, so an index built here carries no padding rows; an
index loaded from the JAX package keeps its padded rows, whose bias is
-3e38 so they are never retrieved. The on-disk format is shared with the
JAX package (``embeddings.npy``, ``row_bias.npy``, ``row_scale.npy``,
``meta.json``), so either package loads the other's index.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..ops.mips_topk import mips_topk, quantize_corpus_sq8


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    embeddings: torch.Tensor  # [N_rows, D] bf16 / f32 / int8 (SQ8)
    row_bias: torch.Tensor  # [N_rows] f32 (-3e38 on padding rows)
    row_scale: torch.Tensor | None  # [N_rows] f32 dequant scales (SQ8 only)
    n: int  # real rows
    metric: str
    normalized: bool

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
) -> FlatIndex:
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    x = torch.as_tensor(embeddings, device=device).float()
    n = x.shape[0]
    if normalize:
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    if metric == "l2":
        bias = -0.5 * (x * x).sum(dim=-1)
    else:
        bias = torch.zeros(n, dtype=torch.float32, device=x.device)
    row_scale = None
    if dtype == torch.int8:
        emb, row_scale = quantize_corpus_sq8(x)
    else:
        emb = x.to(dtype)
    return FlatIndex(embeddings=emb.contiguous(), row_bias=bias.contiguous(),
                     row_scale=row_scale, n=n, metric=metric,
                     normalized=normalize)


def search(
    index: FlatIndex,
    queries: torch.Tensor,  # [B, D] (un-normalized; normalized here if needed)
    k: int = 10,
    ignore: torch.Tensor | None = None,  # [B, I] int32 corpus ids, -1 pad
):
    """Top-k search → (scores f32 [B, k], ids int32 [B, k])."""
    b, d = queries.shape
    q = queries.float()
    if index.normalized and index.metric == "ip":
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    if d != index.dim:  # index saved with padded columns
        q = torch.nn.functional.pad(q, (0, index.dim - d))
    if ignore is not None:
        ignore = ignore.to(torch.int32).contiguous()
    return mips_topk(q.contiguous(), index.embeddings, k, index.row_bias,
                     ignore, index.row_scale)


def save_flat_index(index: FlatIndex, path: str) -> None:
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


def load_flat_index(path: str, *, device=None) -> FlatIndex:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "int8" in meta["dtype"]:
        dtype = torch.int8
    elif "bfloat16" in meta["dtype"]:
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    emb = torch.from_numpy(np.load(os.path.join(path, "embeddings.npy")))
    bias = torch.from_numpy(np.load(os.path.join(path, "row_bias.npy")))
    scale_path = os.path.join(path, "row_scale.npy")
    scale = (torch.from_numpy(np.load(scale_path)).to(device)
             if os.path.exists(scale_path) else None)
    return FlatIndex(
        embeddings=emb.to(dtype).to(device).contiguous(),
        row_bias=bias.float().to(device).contiguous(),
        row_scale=scale, n=meta["n"], metric=meta["metric"],
        normalized=meta["normalized"],
    )

