"""JAX param trees and indexes → the port's modules and indexes.

The port's modules name their parameters after the JAX param tree
(``led.encoder.0.attn.q.kernel`` is ``params["led"]["encoder"][0]["attn"]
["q"]["kernel"]``) and keep its layouts, so loading a tree is a copy with
no renames. An 8-bit Adam state comes over array for array
(`adam8bit_state_from_jax`): both packages lay it out in the same
superleaf order. An index built by the JAX package comes over as its arrays
and static fields (`ivf_index_from_arrays`, `flat_index_from_arrays`), so
one index can be searched by both packages whatever k-means drew; given a
mesh, a rank keeps its part of it (its rows, or its clusters). Works on
numpy-convertible leaves (numpy arrays, or JAX arrays through
``np.asarray``, bf16 included); imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from .index.flat import FlatIndex
from .index.ivf import IVFIndex


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists → {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy every leaf of ``tree`` into the parameter of the same path.
    Raises when the key sets or any shape differ."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing, extra = sorted(params.keys() - flat.keys()), sorted(flat.keys() - params.keys())
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing[:5]}, extra {extra[:5]}")
    for name, p in params.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module


def _tensor(a: Any, device=None) -> torch.Tensor:
    """A numpy-convertible array as a tensor of the same type (bf16 via
    f32, which holds it exactly)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def adam8bit_state_from_jax(state: Any, device=None):
    """A JAX ``Adam8bitState`` (its fields numpy-convertible) → the port's
    `train.adam8bit.Adam8bitState`, with the int8/uint8 codes kept."""
    from .train.adam8bit import _ARRAYS, Adam8bitState

    arrays = {k: _tensor(getattr(state, k), device).contiguous() for k in _ARRAYS}
    return Adam8bitState(count=int(np.asarray(state.count)), **arrays)


def flat_index_from_arrays(arrays: dict[str, Any], *, n: int, metric: str,
                           normalized: bool, device=None, mesh=None) -> FlatIndex:
    """The port's FlatIndex from a flat index's ``embeddings``, ``row_bias``
    and ``row_scale`` (None unless SQ8) and static fields. With a ``mesh``
    of S > 1 shards, this rank's rows [s·R/S, (s+1)·R/S) of the R given
    (a multiple of S, as the JAX package's sharded layout pads them)."""
    scale = arrays.get("row_scale")
    shards = 1 if mesh is None else mesh.shard
    rows = slice(None)
    if shards > 1:
        r = len(arrays["row_bias"])
        if r % shards:
            raise ValueError(f"{r} rows do not split into {shards} shards")
        rows = slice(mesh.s * r // shards, (mesh.s + 1) * r // shards)
    return FlatIndex(
        embeddings=_tensor(np.asarray(arrays["embeddings"])[rows], device).contiguous(),
        row_bias=_tensor(np.asarray(arrays["row_bias"])[rows], device).contiguous(),
        row_scale=None if scale is None
        else _tensor(np.asarray(scale)[rows], device).contiguous(),
        n=n, metric=metric, normalized=normalized, shards=shards)


def ivf_index_from_arrays(arrays: dict[str, Any], *, n: int, metric: str,
                          normalized: bool, n_spill: int = -1,
                          flat: FlatIndex | None = None, device=None,
                          mesh=None) -> IVFIndex:
    """The port's IVFIndex from the arrays of an IVF index (every tensor
    field of `IVFIndex` but ``flat``; the scales None unless SQ8) and its
    static fields. With a ``mesh`` of several shards, this rank's part
    (`index.ivf.shard_ivf_index`: its clusters, no flat sibling)."""
    from .index.ivf import shard_ivf_index

    fields = [f.name for f in dataclasses.fields(IVFIndex)
              if f.name not in ("n", "metric", "normalized", "flat", "n_spill", "shards")]
    kw = {f: None if arrays.get(f) is None else _tensor(arrays[f], device).contiguous()
          for f in fields}
    index = IVFIndex(n=n, metric=metric, normalized=normalized, n_spill=n_spill,
                     flat=flat, **kw)
    if mesh is None or mesh.shard == 1:
        return index
    return shard_ivf_index(index, mesh)
