"""ZeRO sharding of the optimizer state over the mesh's ``data`` axis.

Counterpart of ``retrieval_augmented_mds_tpu/parallel/zero.py``, whose
``zero_sharding_for_tree`` shards every leaf of the optax state over
``data`` on its largest axis that the ``data`` size D divides (the first
of equal sizes), and replicates a leaf that has none. The port keeps the
same rule as a per-leaf spec (`zero_axis`: the axis, or None) and as data
rank d's part of a leaf (`zero_slice`: slice d of D along that axis, or
the whole leaf). `ZeroLayout` lays the parts of a list of leaves back to
back in one flat buffer, the form the optimizers keep their state in, and
puts a whole leaf back together from every data rank's buffer.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch


def zero_axis(shape: Sequence[int], n_shards: int) -> int | None:
    """The axis a leaf of ``shape`` is sharded on over ``n_shards`` data
    ranks, or None (replicated)."""
    if not shape or n_shards <= 1:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):  # stable: first wins ties
        if shape[ax] % n_shards == 0 and shape[ax] >= n_shards:
            return ax
    return None


def zero_slice(x: torch.Tensor, axis: int | None, d: int, n_shards: int) -> torch.Tensor:
    """Data rank ``d``'s part of ``x`` (a view)."""
    if axis is None:
        return x
    step = x.shape[axis] // n_shards
    return x.narrow(axis, d * step, step)


class ZeroLayout:
    """Data rank ``d``'s parts of the leaves ``shapes`` (in order), back to
    back in one flat buffer."""

    def __init__(self, shapes: Sequence[Sequence[int]], n_shards: int, d: int):
        self.shapes = [tuple(s) for s in shapes]
        self.n_shards, self.d = n_shards, d
        self.axes = [zero_axis(s, n_shards) for s in self.shapes]
        self.sizes = [math.prod(s) // (1 if a is None else n_shards)
                      for s, a in zip(self.shapes, self.axes)]
        self.offsets = [0, *itertools.accumulate(self.sizes)]
        self.numel = self.offsets.pop()

    def local(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's parts of ``leaves`` as one flat f32 buffer."""
        return torch.cat([zero_slice(x, a, self.d, self.n_shards).reshape(-1).float()
                          for x, a in zip(leaves, self.axes)])

    def whole_leaf(self, stacked: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` whole from every data rank's buffer, stacked [D, numel]
        in rank order: a sharded leaf's parts joined along its axis, a
        replicated leaf taken from rank 0."""
        off = self.offsets[i]
        part = list(self.shapes[i])
        a = self.axes[i]
        if a is not None:
            part[a] //= self.n_shards
        rows = [row[off:off + self.sizes[i]].view(part) for row in stacked]
        return rows[0] if a is None else torch.cat(rows, dim=a)

