"""The mesh's collectives: every one of the port goes through here.

Of the collectives that run on CUDA tensors under both backends
(``all_gather`` in its list form, ``all_reduce`` with SUM or MAX,
``broadcast``), the port needs the first two. Under gloo a CUDA tensor
is staged through the host here. A group of one process returns at
once. Each call times out with its group
(`mesh.TIMEOUT`) and is counted in `STATS`: ``calls``, and ``bytes``, the
bytes this rank receives (an all_reduce counted as the all_gather of its
inputs, (n - 1) x its size).

Gradients. `gather_stack`, `gather_cat` and `all_reduce` with SUM carry
one under autograd; MAX carries none (its callers take it of a
stop-gradient shift, as the JAX package's ``stop_gradient``). Each
backward is the exact transpose of its forward over the group: the
cotangents of every member are summed. That is right when every rank's
loss is its share of the global loss, the shares summing to it (the
convention of the mesh's train step: a value replicated over a group
enters each member's loss divided by the group's size), and the
parameters' gradients are then summed over every rank (`all_reduce_grads`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0}
BUCKET_BYTES = 256 << 20  # the flat gradient all_reduce, in f32 buckets of this size


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def _count(x: torch.Tensor, received: int) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += received * x.numel() * x.element_size()


def _gather_stack(x: torch.Tensor, group, host: bool = False) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x[None]
    xs = _staged(x, group)
    out = [torch.empty_like(xs) for _ in range(n)]
    dist.all_gather(out, xs, group=group)
    _count(x, n - 1)
    out = torch.stack(out)
    return out if host else out.to(x.device)


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    xs = _staged(x, group)
    xs = xs.clone() if xs is x else xs
    dist.all_reduce(xs, op=red, group=group)
    _count(x, n - 1)
    return xs.to(x.device)


class _GatherStack(torch.autograd.Function):
    # the transpose of an all_gather is a reduce-scatter: member r's
    # gradient is slot r of every member's cotangent, summed (an all_reduce
    # of the stacked cotangents, then this rank's slot: gloo has no
    # reduce_scatter)
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_stack(x, group)

    @staticmethod
    def backward(ctx, g):
        if dist.get_world_size(ctx.group) == 1:
            return g[0], None
        return _all_reduce(g.contiguous(), ctx.group, "sum")[dist.get_rank(ctx.group)], None


class _AllReduceSum(torch.autograd.Function):
    # y = sum over the group of x, on every member: the transpose sums the
    # members' cotangents, an all_reduce SUM again
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "sum"), None


def gather_stack(x: torch.Tensor, group, host: bool = False) -> torch.Tensor:
    """Every group member's ``x`` (all of one shape), stacked in group-rank
    order on a new leading axis → [n, *x.shape]. ``host`` (no gradient):
    leave the result where the backend put it, on the host when gloo
    staged a CUDA tensor there (the caller moves what it needs, a piece at
    a time, rather than the whole stack to the card)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherStack.apply(x, group)
    return _gather_stack(x, group, host)


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every group member's ``x``, concatenated along ``dim`` in group-rank
    order."""
    g = gather_stack(x, group)
    return torch.cat(g.unbind(0), dim=dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or elementwise maximum (``"max"``, no
    gradient) of every group member's ``x``, as a new tensor."""
    if op == "sum" and x.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(x, group)
    if op == "max":
        x = x.detach()
    return _all_reduce(x, group, op)


@torch.no_grad()
def all_reduce_grads(grads: list[torch.Tensor], group=None) -> None:
    """Sum every tensor of ``grads`` over ``group`` (None: every rank), in
    place: the tensors are packed into flat f32 buckets of at most
    `BUCKET_BYTES` (a tensor larger than that has one of its own), one
    all_reduce a bucket."""
    if dist.get_world_size(group) == 1 or not grads:
        return
    limit = BUCKET_BYTES // 4
    buckets: list[list[torch.Tensor]] = [[]]
    size = 0
    for g in grads:
        if buckets[-1] and size + g.numel() > limit:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel()
    for bucket in buckets:
        flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in bucket]), group, "sum")
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
