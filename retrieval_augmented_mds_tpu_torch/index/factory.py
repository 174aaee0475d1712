"""FAISS-style factory strings → index builders.

Counterpart of ``retrieval_augmented_mds_tpu/index/factory.py``:

  * "Flat"               → FlatIndex (exact search by the MIPS kernel)
  * "IVF<n>,Flat"        → IVFIndex with n clusters, payload of ``dtype``
  * "IVF<n>,SQ8"         → IVFIndex with n clusters and int8 payloads with
                           per-row scales
  * "IVF<n>_HNSW<m>,..." → as "IVF<n>,...": the centroid scan is one small
                           matmul, so the graph quantizer is not needed

The cluster count is clamped to ``min(n, N // 8)``; over a mesh of S > 1
shards it is then rounded down to a multiple of S (at least S), and the
index is built whole on every rank and sharded (`flat.build_flat_index`'s
rows, `ivf.shard_ivf_index`'s clusters). A changed count is reported on
stderr, as in the JAX package.
"""

from __future__ import annotations

import re
import sys
from typing import Any

import torch

from .flat import FlatIndex, build_flat_index
from .ivf import IVFIndex, build_ivf_index, shard_ivf_index

_IVF_RE = re.compile(r"^IVF(\d+)(?:_HNSW\d+)?$")


def parse_factory(spec: str) -> dict[str, Any]:
    parts = [p.strip() for p in spec.split(",")]
    if parts == ["Flat"]:
        return {"kind": "flat"}
    if len(parts) == 2:
        m = _IVF_RE.match(parts[0])
        if m and parts[1] in ("Flat", "SQ8"):
            return {"kind": "ivf", "n_clusters": int(m.group(1)),
                    "payload": parts[1].lower()}
    raise ValueError(f"unsupported index factory: {spec!r}")


def build_index_from_factory(
    embeddings, spec: str, *, metric: str = "ip", normalize: bool = False,
    dtype=torch.bfloat16, train_size: int | None = None, seed: int = 0, device=None,
    mesh=None,
) -> FlatIndex | IVFIndex:
    p = parse_factory(spec)
    if p["kind"] == "flat":
        return build_flat_index(embeddings, metric=metric, normalize=normalize,
                                dtype=dtype, device=device, mesh=mesh)
    n = len(embeddings)
    n_clusters = min(p["n_clusters"], max(1, n // 8))
    n_shards = 1 if mesh is None else mesh.shard
    if n_shards > 1:  # the cluster partition needs C % shards == 0
        n_clusters = max(n_shards, (n_clusters // n_shards) * n_shards)
    if n_clusters != p["n_clusters"]:
        print(f"[index] factory {spec!r}: effective n_clusters={n_clusters} "
              f"(requested {p['n_clusters']}; corpus={n}, shards={n_shards})",
              file=sys.stderr)
    index = build_ivf_index(
        embeddings, n_clusters, metric=metric, normalize=normalize,
        dtype="int8" if p["payload"] == "sq8" else dtype, train_size=train_size,
        seed=seed, device=device,
    )
    return shard_ivf_index(index, mesh) if n_shards > 1 else index
