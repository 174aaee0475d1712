"""Start one fresh interpreter per rank, bound by a timeout: the launcher
of the mesh tests and of `chip_smoke.py`'s ``[mesh_eval]`` (a user starts
the ranks with ``torchrun``).

    results = launch("module:function", world=4, args=(...,),
                     workdir=DIR, timeout=300)

Runs ``function(*args)`` in ``world`` new Python processes (never a fork
of the caller, which may have touched CUDA or started threads), with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as
torchrun sets them on one host, and the caller's ``sys.path``. A rank's
process group can start from ``file://<workdir>/pg_store``
(`store_url`), so concurrent launches never contend for a TCP port.
Returns each rank's return value, in rank order. When a rank exits
non-zero, or the ``timeout`` (seconds) runs out, every rank still running
is killed and `RankFailure` names the ranks and the end of their stderr.

A rank's standard output and error go to ``<workdir>/rank<r>.log``. A
rank ends its process group itself once its result is written.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time


class RankFailure(RuntimeError):
    pass


def store_url(workdir: str) -> str:
    return "file://" + os.path.join(os.path.abspath(workdir), "pg_store")


def launch(target: str, world: int, *, args: tuple = (), workdir: str,
           timeout: float, env: dict | None = None) -> list:
    os.makedirs(workdir, exist_ok=True)
    for name in ("pg_store", "spec.pkl"):
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    spec = os.path.join(workdir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump((target, args), f)
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            e = dict(os.environ, **(env or {}), RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                     PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, spec, workdir], env=e,
                stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: its peers would wait out their group timeout
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for r, c in enumerate(codes):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            tails.append(f"--- rank {r} exit {c} ---\n{tail}")
        timed_out = time.monotonic() > deadline
        raise RankFailure(f"{target} over {world} ranks: exit codes {codes}"
                          + (f" (killed after {timeout} s)" if timed_out else "")
                          + "\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.result.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(spec: str, workdir: str) -> None:
    with open(spec, "rb") as f:
        target, args = pickle.load(f)
    module, fn = target.split(":")
    result = getattr(importlib.import_module(module), fn)(*args)
    rank = os.environ["RANK"]
    with open(os.path.join(workdir, f"rank{rank}.result.pkl"), "wb") as f:
        pickle.dump(result, f)
    # end the process group here, not in the interpreter's teardown, where
    # gloo's threads can be destroyed while still joinable (an abort)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:3])
