"""Arithmetic the per-layer readers share. Each reader is a file of its
own under ``layer_metrics/`` (the name of its metric); a reader that finds
nothing to read returns None and the harness leaves its metric out."""

from __future__ import annotations

import statistics

from . import roofline

def kind(run) -> str:
    return "predict" if run.workload["entry"] == "predict" else "train"


def median_ms(values) -> float | None:
    values = list(values)
    return 1000 * statistics.median(values) if values else None


def phase_ms(run, phase: str) -> float | None:
    if kind(run) != "train":
        return None
    return median_ms(t[phase] for t in run.facts.get("phases", []) if phase in t)


def idle_pct(run, of: str) -> float | None:
    prof = run.profile
    if kind(run) != of or not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100 * (1 - prof["busy_s"] / prof["window_s"])


def attn_roofline(run, of: str) -> float | None:
    """Sum of each attention-kernel launch's bound over the sum of the
    kernels' device time in the traced window; None unless every wrapper's
    launch count equals the launches the benchmark expected from its own
    calls."""
    w, prof, launches = run.facts.get("work"), run.profile, run.facts.get("launches")
    if kind(run) != of or w is None or not prof or launches is None or not w.bounds:
        return None
    bound = device = 0.0
    for wrapper, bounds in w.bounds.items():
        if launches.get(wrapper) != len(bounds):
            return None
        t = sum(prof["kernels"].get(n, (0.0, 0))[0] for n in roofline.KERNELS[wrapper])
        if t <= 0:
            return None
        bound += sum(bounds)
        device += t
    return 100 * bound / device


def mfu_pct(run, of: str) -> float | None:
    w, prof = run.facts.get("work"), run.profile
    if kind(run) != of or w is None or not prof or prof["window_s"] <= 0 or w.flops <= 0:
        return None
    peak = roofline.PEAK[run.cfg_file["experiment"]["precision"]]
    return 100 * w.flops / (prof["window_s"] * peak)
