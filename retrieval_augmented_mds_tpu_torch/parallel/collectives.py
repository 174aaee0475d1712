"""The mesh's collectives: every one of the port goes through here.

Of the collectives that run on CUDA tensors under both backends
(``all_gather`` in its list form, ``all_reduce`` with SUM or MAX,
``broadcast``), the port needs the first two. Under gloo a CUDA tensor
is staged through the host here. A group of one process returns at
once. Each call times out with its group
(`mesh.TIMEOUT`) and is counted in `STATS`: ``calls``, and ``bytes``, the
bytes this rank receives (an all_reduce counted as the all_gather of its
inputs, (n - 1) x its size).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0}


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def _count(x: torch.Tensor, received: int) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += received * x.numel() * x.element_size()


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every group member's ``x`` (all of one shape), stacked in group-rank
    order on a new leading axis → [n, *x.shape]."""
    n = dist.get_world_size(group)
    if n == 1:
        return x[None]
    xs = _staged(x, group)
    out = [torch.empty_like(xs) for _ in range(n)]
    dist.all_gather(out, xs, group=group)
    _count(x, n - 1)
    return torch.stack(out).to(x.device)


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every group member's ``x``, concatenated along ``dim`` in group-rank
    order."""
    g = gather_stack(x, group)
    return torch.cat(g.unbind(0), dim=dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or elementwise maximum (``"max"``) of every
    group member's ``x``, as a new tensor."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    xs = _staged(x, group)
    xs = xs.clone() if xs is x else xs
    dist.all_reduce(xs, op=red, group=group)
    _count(x, n - 1)
    return xs.to(x.device)

