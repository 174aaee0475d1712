"""FAISS-style factory strings → index builders.

Counterpart of ``retrieval_augmented_mds_tpu/index/factory.py``. Only
"Flat" is ported; the "IVF<n>,Flat|SQ8" specs parse as in the JAX package
and raise until the IVF index is ported.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from .flat import FlatIndex, build_flat_index

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
    dtype=torch.bfloat16, device=None,
) -> FlatIndex:
    if parse_factory(spec)["kind"] != "flat":
        raise NotImplementedError(
            f"index factory {spec!r}: the IVF index is not ported yet "
            "(ROADMAP queue 1: IVF, kernel K8)"
        )
    return build_flat_index(embeddings, metric=metric, normalize=normalize,
                            dtype=dtype, device=device)
