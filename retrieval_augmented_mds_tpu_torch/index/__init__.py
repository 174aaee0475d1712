import dataclasses
import json
import os

import torch

from .augment import augment_corpus, augment_queries  # noqa: F401
from .factory import build_index_from_factory, parse_factory  # noqa: F401
from .flat import (  # noqa: F401
    FlatIndex,
    build_flat_index,
    load_flat_index,
    save_flat_index,
    search,
)
from .ivf import (  # noqa: F401
    IVFIndex,
    build_ivf_index,
    ivf_search,
    kmeans,
    load_ivf_index,
    save_ivf_index,
)


def load_index(path: str, *, device=None):
    """A persisted index directory (either package's `save_flat_index` or
    `save_ivf_index` output), dispatched on ``meta.json``'s ``kind``."""
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f).get("kind", "flat")
    if kind == "ivf":
        return load_ivf_index(path, device=device)
    return load_flat_index(path, device=device)


def save_index(index, path: str) -> None:
    """`save_flat_index` or `save_ivf_index`, by the index's type."""
    if isinstance(index, IVFIndex):
        save_ivf_index(index, path)
    else:
        save_flat_index(index, path)


def index_to(index, device):
    """A copy of a flat or IVF index with every tensor on ``device``."""
    moved = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, torch.Tensor):
            moved[f.name] = v.to(device)
        elif isinstance(v, FlatIndex):
            moved[f.name] = index_to(v, device)
    return dataclasses.replace(index, **moved)
