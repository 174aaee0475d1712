"""FAISS-style factory strings → index builders.

Counterpart of ``retrieval_augmented_mds_tpu/index/factory.py`` on one
device (no mesh, so no rounding of the cluster count to a shard count):

  * "Flat"               → FlatIndex (exact search by the MIPS kernel)
  * "IVF<n>,Flat"        → IVFIndex with n clusters, payload of ``dtype``
  * "IVF<n>,SQ8"         → IVFIndex with n clusters and int8 payloads with
                           per-row scales
  * "IVF<n>_HNSW<m>,..." → as "IVF<n>,...": the centroid scan is one small
                           matmul, so the graph quantizer is not needed

The cluster count is clamped to ``min(n, N // 8)`` and a clamp is reported
on stderr, as in the JAX package.
"""

from __future__ import annotations

import re
import sys
from typing import Any

import torch

from .flat import FlatIndex, build_flat_index
from .ivf import IVFIndex, build_ivf_index

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
) -> FlatIndex | IVFIndex:
    p = parse_factory(spec)
    if p["kind"] == "flat":
        return build_flat_index(embeddings, metric=metric, normalize=normalize,
                                dtype=dtype, device=device)
    n = len(embeddings)
    n_clusters = min(p["n_clusters"], max(1, n // 8))
    if n_clusters != p["n_clusters"]:
        print(f"[index] factory {spec!r}: effective n_clusters={n_clusters} "
              f"(requested {p['n_clusters']}; corpus={n}, shards=1)", file=sys.stderr)
    return build_ivf_index(
        embeddings, n_clusters, metric=metric, normalize=normalize,
        dtype="int8" if p["payload"] == "sq8" else dtype, train_size=train_size,
        seed=seed, device=device,
    )
