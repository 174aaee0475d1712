"""The program's own spans (`obs.profiling.span` in the port) that the
per-layer metrics read: those recorded in the run's profiled window, where
the program records spans at all. A program without the recorder, or a run
without a profiled window, gives None, and the metric is left out."""

from __future__ import annotations

import statistics


def spans(run, name: str) -> list | None:
    """The program's spans named ``name`` that lie inside the run's profiled
    window (between its first and last benchmark span), or None."""
    try:
        from retrieval_augmented_mds_tpu_torch.obs.profiling import recorded
    except ImportError:  # a program without spans
        return None
    if not run.spans_ns:
        return None
    lo = min(a for _, a, _ in run.spans_ns)
    hi = max(b for _, _, b in run.spans_ns)
    got = [s for s in recorded() if s.name == name and lo <= s.start_ns and s.end_ns <= hi]
    return got or None


def host_ms(run, name: str) -> float | None:
    """The median host time of the spans, ms: the time the host took to
    enqueue their work (and to wait, where they synchronise)."""
    got = spans(run, name)
    return statistics.median(s.host_ms for s in got) if got else None


def syncs(run, name: str) -> float | None:
    """The mean count of blocking host-device synchronisations a span."""
    got = spans(run, name)
    return sum(s.syncs for s in got) / len(got) if got else None


def stream_ms(run, name: str) -> float | None:
    """The median device-stream time between each span's CUDA events, ms;
    None off CUDA."""
    got = spans(run, name)
    if not got:
        return None
    times = [s.stream_ms() for s in got]
    return None if None in times else statistics.median(times)
