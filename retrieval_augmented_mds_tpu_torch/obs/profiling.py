"""Profiling: the program's spans and device traces.

Counterpart of ``retrieval_augmented_mds_tpu/obs/profiling.py``.

`span` names a part of the program (``with span("train.forward"): ...``).
It records only while a `torch.profiler` profile runs, which is when a
device trace exists to put it on: a recorded span holds its parent and root
span, its start and end on ``time.time_ns()`` (the clock of the trace's
``baseTimeNanoseconds``), on CUDA a pair of timing events recorded at its
ends (resolved only when read), and ``syncs``, the blocking host-device
synchronisations inside it (while a recorded root span is open, torch's sync
debug mode warns, and each warning is counted against the open spans, from
whichever thread raised it: autograd runs a CUDA backward on a thread of its
own). It
also opens ``torch.profiler.record_function(name)``, so the span is a
``user_annotation`` range on the kernels' timeline. Off, a span is one flag
check. `recorded` returns the spans of the most recent profiled stretch
(a profiler's start begins a new one).

`trace` wraps a block in `torch.profiler` (the JAX package's wraps
``jax.profiler``) and writes one Chrome trace of it, host ops and, when a
card is present, its kernels, under ``<log_dir>``: ``--profile`` puts it in
``<logging.log_dir>/trace``. Open it in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

# the text of torch's warning in sync debug mode "warn"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class Span:
    """A recorded span. ``start_ns``/``end_ns`` are host times
    (``time.time_ns``); ``events`` the CUDA timing events at its ends, or
    None off CUDA."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "events", "syncs")

    def __init__(self, name: str, id_: int, parent: int | None, root: int):
        self.name, self.id, self.parent, self.root = name, id_, parent, root
        self.start_ns = self.end_ns = 0
        self.events = None
        self.syncs = 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def stream_ms(self) -> float | None:
        """The device stream's time between the span's two events, or None
        off CUDA. Call it once the device has passed the span's end."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


class _Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.next_id = 0
        # a profiler started since the last recorded span: the next recorded
        # root starts a new stretch
        self.fresh = True
        self.restore = None  # what the root's open changed

    def open_root(self) -> None:
        if self.fresh:
            self.spans = []
            self.fresh = False
        caught = warnings.catch_warnings()
        caught.__enter__()
        shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.showwarning = self._counter(shown)
        mode = None
        if torch.cuda.is_initialized():
            # torch's one notice that the mode is a prototype
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(1)
        self.restore = (caught, mode)

    def close_root(self) -> None:
        caught, mode = self.restore
        self.restore = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)

    def _counter(self, shown):
        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_MESSAGE):
                for s in self.stack:
                    s.syncs += 1
            elif shown is warnings._showwarning_orig:  # the default display
                warnings._showwarnmsg_impl(warnings.WarningMessage(
                    message, category, filename, lineno, file, line))
            else:
                shown(message, category, filename, lineno, file, line)
        return show


_REC = _Recorder()


def _on_profiler_start(start=_profiler._run_on_profiler_start):
    # torch calls this as it enables any profiler
    _REC.fresh = True
    start()


_profiler._run_on_profiler_start = _on_profiler_start


class _Off:
    """An unrecorded span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A recorded span."""

    __slots__ = ("name", "span", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        if not rec.stack:
            rec.open_root()
        parent = rec.stack[-1] if rec.stack else None
        s = Span(self.name, rec.next_id, parent.id if parent else None,
                 parent.root if parent else rec.next_id)
        rec.next_id += 1
        self.span = s
        self.fn = torch.profiler.record_function(s.name)
        self.fn.__enter__()
        rec.stack.append(s)
        rec.spans.append(s)
        if torch.cuda.is_initialized():
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.time_ns()
        if s.events is not None:
            s.events[1].record()
        rec = _REC
        rec.stack.pop()
        self.fn.__exit__(None, None, None)
        if not rec.stack:
            rec.close_root()
        return False


def span(name: str):
    """A span of the program named ``name`` (a context manager): recorded
    while a `torch.profiler` profile runs, else nothing but this check."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def recorded() -> list[Span]:
    """The spans of the most recent profiled stretch (those recorded since
    a profiler last started), in the order they opened."""
    return list(_REC.spans)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (the CPU, and CUDA when
    available) and write ``<log_dir>/trace_<unix time>.json``, also when
    the block raises. Yields the profiler."""
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
