"""The (data, shard) device mesh on `torch.distributed`.

Counterpart of ``retrieval_augmented_mds_tpu/parallel/mesh.py``. The JAX
package drives its mesh from one controller (a `jax.sharding.Mesh`,
`shard_map`, global shapes under `jit`); the port runs one process per
mesh position instead, and each process holds its own part:

  * ``data``  — the batch axis: data rank ``d`` takes rows
                ``[d·B/D, (d+1)·B/D)`` of a batch whose size D divides;
  * ``shard`` — the index and sequence axis: shard rank ``s`` holds rows
                ``[s·N/S, (s+1)·N/S)`` of a flat index, clusters
                ``[s·C/S, (s+1)·C/S)`` of an IVF index, and tokens
                ``[s·T/S, (s+1)·T/S)`` of a sequence-sharded encoder.

Process ``rank = d·S + s``. Its ``data`` group holds the ranks of its
``s`` (the other data ranks of its shard), its ``shard`` group the ranks
of its ``d``. The backend is chosen once, from the device layout, when the
process group starts: ``nccl`` when every local rank has a card of its
own, else ``gloo`` (on the CPU, or when ranks share a card, whose
collectives gloo stages through the host). Every group times out after
`TIMEOUT`, so a rank that dies leaves its peers with an error, not a hang.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SHARD_AXIS = "shard"
TIMEOUT = timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``data * shard`` must equal the world size."""

    data: int
    shard: int


def best_mesh(n: int, prefer_shard: int | None = None) -> MeshSpec:
    """A (data, shard) factorisation of ``n`` processes: ``prefer_shard``
    when given, else shard the largest power of two <= sqrt(n) that
    divides n, and data the rest (the JAX package's rule)."""
    if prefer_shard is not None:
        if n % prefer_shard:
            raise ValueError(f"{n} processes not divisible by shard={prefer_shard}")
        return MeshSpec(n // prefer_shard, prefer_shard)
    shard = 1
    while shard * 2 <= max(1, int(n ** 0.5)) and n % (shard * 2) == 0:
        shard *= 2
    return MeshSpec(n // shard, shard)


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    shard: int
    rank: int
    d: int  # this rank's data coordinate
    s: int  # this rank's shard coordinate
    data_group: object  # the ranks with this rank's s
    shard_group: object  # the ranks with this rank's d
    backend: str
    device: torch.device

    def splits_batch(self, b: int) -> bool:
        """Whether a batch of ``b`` rows is split over ``data`` (else every
        data rank takes the whole batch, as the JAX package replicates it)."""
        return self.data > 1 and b % self.data == 0

    def data_rows(self, b: int) -> slice:
        """This rank's rows of a batch of ``b``."""
        if not self.splits_batch(b):
            return slice(0, b)
        n = b // self.data
        return slice(self.d * n, (self.d + 1) * n)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def world_size() -> int:
    """The process group's size, or ``WORLD_SIZE`` (torchrun's) before it
    starts; 1 without either."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK % device_count``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def choose_backend(device: torch.device) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if device.type != "cuda":
        return "gloo"
    local = _env_int("LOCAL_WORLD_SIZE", world_size())
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed(device: str | torch.device = "cuda", *,
                     init_method: str | None = None) -> str:
    """Start the default process group for this rank (``RANK`` and
    ``WORLD_SIZE`` from the environment, as torchrun sets them; the store
    from ``init_method``, else ``env://``) unless it is running → its
    backend."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    backend = choose_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=_env_int("WORLD_SIZE", 1),
                            rank=_env_int("RANK", 0), timeout=TIMEOUT)
    return backend


def make_mesh(spec: MeshSpec, device: str | torch.device = "cuda") -> Mesh:
    """The mesh ``spec`` over the running process group (started from the
    environment when it is not: `init_distributed`). Every rank must call
    this with the same ``spec``: each creates every data and shard group,
    in one order."""
    backend = init_distributed(device)
    world = dist.get_world_size()
    if spec.data * spec.shard != world:
        raise ValueError(f"mesh data={spec.data} x shard={spec.shard} needs "
                         f"{spec.data * spec.shard} processes, the world has {world}")
    rank = dist.get_rank()
    d, s = divmod(rank, spec.shard)
    data_group = shard_group = None
    for si in range(spec.shard):
        g = dist.new_group([di * spec.shard + si for di in range(spec.data)],
                           timeout=TIMEOUT)
        if si == s:
            data_group = g
    for di in range(spec.data):
        g = dist.new_group([di * spec.shard + si for si in range(spec.shard)],
                           timeout=TIMEOUT)
        if di == d:
            shard_group = g
    return Mesh(data=spec.data, shard=spec.shard, rank=rank, d=d, s=s,
                data_group=data_group, shard_group=shard_group, backend=backend,
                device=rank_device(device))


def build_mesh(cfg, device: str | torch.device = "cuda") -> Mesh | None:
    """The config's mesh, by the JAX package's rules with the world size
    where it has the device count: ``data`` or ``shard`` 0 → None (one
    device); both given → that mesh, which must cover the world; else None
    on a world of 1, and `best_mesh` on more. A mesh of one process is
    None: the single-device path. Prints the backend to stderr."""
    m = cfg.mesh
    world = world_size()
    if m.data == 0 or m.shard == 0:
        return None
    if m.data and m.shard:
        spec = MeshSpec(m.data, m.shard)
        if spec.data * spec.shard != world:
            raise ValueError(
                f"mesh data={m.data} x shard={m.shard} needs {m.data * m.shard} "
                f"processes, the world has {world} (run it under `torchrun "
                f"--nproc-per-node {m.data * m.shard}`, or leave the mesh unset)")
    elif world == 1:
        if m.data or m.shard:
            print(f"[mesh] data={m.data} shard={m.shard} on a world of 1: one device",
                  file=sys.stderr)
        return None
    else:
        spec = best_mesh(world)
    if world == 1:
        return None
    mesh = make_mesh(spec, device)
    print(f"[mesh] rank {mesh.rank}: data={mesh.data} shard={mesh.shard} (d={mesh.d}, "
          f"s={mesh.s}), backend {mesh.backend}, device {mesh.device}", file=sys.stderr)
    return mesh
