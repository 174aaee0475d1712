"""JAX param trees → the port's modules.

The port's modules name their parameters after the JAX param tree
(``led.encoder.0.attn.q.kernel`` is ``params["led"]["encoder"][0]["attn"]
["q"]["kernel"]``) and keep its layouts, so loading a tree is a copy with
no renames. Works on any tree of numpy-convertible leaves (numpy arrays,
or JAX arrays through ``np.asarray``); imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


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
