"""Profiling: per-phase wall timing and device traces.

Counterpart of ``retrieval_augmented_mds_tpu/obs/profiling.py``.
`phase_timer` sums the wall time of named phases into a `PhaseTimes`;
`trace` wraps a block in `torch.profiler` (the JAX package's wraps
``jax.profiler``) and writes one Chrome trace of it, host ops and, when a
card is present, its kernels, under ``<log_dir>``: ``fit --profile`` puts it
in ``<logging.log_dir>/trace``. Open it in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimes:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def report(self) -> dict[str, float]:
        return {
            k: self.totals[k] / max(1, self.counts[k]) for k in self.totals
        }


_GLOBAL = PhaseTimes()


@contextlib.contextmanager
def phase_timer(name: str, times: PhaseTimes | None = None):
    t = times or _GLOBAL
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t.totals[name] += time.perf_counter() - t0
        t.counts[name] += 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (the CPU, and CUDA when
    available) and write ``<log_dir>/trace_<unix time>.json``, also when
    the block raises. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time())}.json"))
