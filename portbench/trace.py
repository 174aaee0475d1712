"""Reading a `torch.profiler` trace of part of the window: the card's
kernels, the busy time, and the breakdown the result line carries, its idle
stretches named by the benchmark's own spans."""

from __future__ import annotations

import json
import os
import tempfile

from .roofline import kernel_name

SPANS = ("data", "step", "encode", "generate")


def _trace(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, window_ns: tuple[int, int], spans_ns: list) -> dict:
    """→ {"kernels": {name: [seconds, launches]}, "window_s", "busy_s",
    "breakdown": {"device_ops", "idle_gaps"}} (times in seconds). Kernel
    events are those the trace files under ``kernel``, their times put on
    the host's clock (``time.time_ns``) by the trace's base time; the window
    and the spans are the benchmark's, on that clock."""
    trace = _trace(prof)
    base = int(trace.get("baseTimeNanoseconds", 0))
    w0, w1 = window_ns
    kernels, by_name = [], {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        s = float(e["ts"]) * 1e3 + base
        dur = float(e.get("dur", 0.0)) * 1e3
        if s + dur <= w0 or s >= w1:
            continue
        kernels.append((s, s + dur))
        k = kernel_name(e.get("name", ""))
        acc = by_name.setdefault(k, [0.0, 0])
        acc[0] += dur / 1e9
        acc[1] += 1
    busy = _merge((max(s, w0), min(e, w1)) for s, e in kernels)
    # idle stretches of the card inside the window, named by the span the
    # host was in at their middle (the innermost first)
    spans = sorted(((a, b, n) for n, a, b in spans_ns if n in SPANS), key=lambda x: x[1] - x[0])
    idle, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2
            name = next((n for a, b, n in spans if a <= mid <= b), "other")
            idle[name] = idle.get(name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    ops = sorted(((n, v[0]) for n, v in by_name.items()), key=lambda x: -x[1])[:10]
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"kernels": by_name, "window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in gaps]}}
