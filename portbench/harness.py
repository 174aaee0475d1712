"""The harness: finds a cell's files by name, runs its entry, reads its
metrics, and prints the result line.

A cell is ``workloads/<name>.json`` (its configuration's name, its entry,
its traffic). A configuration is ``configs/<name>.json``. An entry is
``entries/<entry>.py``, with ``setup(run)``, ``window(run, state,
seconds)``, ``release(state)`` and ``check(run, state)``. An end-to-end
metric is ``end_to_end/<name>.py`` and a per-layer one
``layer_metrics/<name>.py``, each with ``read(run)`` → a number, or None
when the run holds nothing for it to read. Which metrics a cell reports
comes from ``BENCHMARK.json``. A later PR adds a cell, a configuration or
a metric by adding such files and entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "retrieval_augmented_mds_tpu")
BENCH_FILE = "BENCHMARK.json"


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """JAX or the JAX package is loaded in the process."""


def process_start() -> float:
    """The time.time() at which this process started (its start in
    /proc/self/stat against the uptime), or now where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_workload(name: str, base: Path = HERE) -> dict:
    """The cell's file, with its configuration's file under ``"config_file"``."""
    wl = load_json(base / "workloads" / f"{name}.json")
    wl["name"] = name
    wl["config_file"] = load_json(base / "configs" / f"{wl['config']}.json")
    return wl


def cell_metrics(name: str, bench: dict) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics of ``BENCHMARK.json`` that the
    cell reports: those that list it, and those without a list (a
    per-layer one then where the cell reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return e2e, layer


def load_reader(kind: str, name: str, base: Path = HERE):
    """The reader ``<base>/<kind>/<name>.py``, or the benchmark's own where
    ``base`` has none."""
    path = base / kind / f"{name}.py"
    if not path.exists():
        path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Run:
    """One run: its arguments, what it measured, and its comparisons."""

    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    facts: dict = dataclasses.field(default_factory=dict)
    # (name, t0, t1) host seconds (perf_counter), and (name, t0, t1) in time_ns
    spans: list = dataclasses.field(default_factory=list)
    spans_ns: list = dataclasses.field(default_factory=list)
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    profile: dict | None = None
    profiling: bool = False

    @property
    def cfg_file(self) -> dict:
        return self.workload["config_file"]

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a call into a layer (on the clock of the profiler's trace
        too, to name the card's idle stretches)."""
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.spans.append((name, t0, time.perf_counter()))
        if self.profiling:
            self.spans_ns.append((name, n0, time.time_ns()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def profiled(self):
        """Profile the enclosed part of the window with `torch.profiler` into
        ``profile``: the card's kernels only (recording the host's operators
        too costs a train step of rag_train half its time again, against
        28% for the kernels alone), the spans on the host's clock."""
        from . import trace

        acts = [torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        self.spans_ns = []
        with prof:
            torch.ones(1, device=self.device).add_(1)  # the tracer is up before the window
            self.sync()
            self.profiling = True
            w0 = time.time_ns()
            try:
                yield
                self.sync()
            finally:
                self.profiling = False
            w1 = time.time_ns()
        self.profile = trace.read(prof, (w0, w1), self.spans_ns)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))


def _device_info(run: Run, peak: int) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace and run.profile:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
    return info


def execute(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            base: Path = HERE, bench_file: Path = REPO / BENCH_FILE,
            control: str | None = None) -> tuple[dict, Run]:
    """Run one cell → (the result line's object, the run). Raises
    `NoDevice` before any work when the cards are missing and `Forbidden`
    when JAX is loaded once the window has closed (checked last, after the
    comparison and the readers). ``control``: the control (a lower
    precision of the reference, `reference.model.Precision`, or ``half``)
    takes the program's place in the comparison, which it should fail; the
    program's own numbers are then kept as readings only."""
    started = process_start()
    wl = load_workload(name, base)
    chips = int(wl.get("chips", 1))
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                       f"torch.cuda.is_available() = {torch.cuda.is_available()}")
    bench = load_json(bench_file)
    e2e, layer = cell_metrics(name, bench)
    entry = importlib.import_module(f"portbench.entries.{wl['entry']}")
    run = Run(workload=wl, seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=dev, started=started)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = entry.setup(run)
    run.sync()
    run.facts["setup_s"] = time.time() - started
    entry.window(run, state, run.seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else run.facts.get("peak_bytes", 0))
    run.facts["peak_bytes"] = peak
    entry.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        entry.check(run, state, control)
    except Exception:  # noqa: BLE001 - outputs the comparison cannot take are wrong ones
        traceback.print_exc()
        run.check("comparison_ran", 1.0, 0.0)
    run.facts["check_s"] = time.perf_counter() - t0
    correct = all(v <= lim for _, v, lim in run.checks) and bool(run.checks)
    metrics = {}
    for m in (layer if trace else e2e):
        kind = "layer_metrics" if trace else "end_to_end"
        value = load_reader(kind, m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result: dict[str, Any] = {
        "correct": correct,
        "attempted": int(run.facts.get("attempted", 0)),
        "failed": int(run.facts.get("failed", 0)),
        "metrics": metrics,
        "device": _device_info(run, peak),
    }
    if trace and run.profile:
        result["breakdown"] = run.profile["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    bad = forbidden_modules()
    if bad:
        raise Forbidden(f"loaded in the process once the window closed: {', '.join(bad)}")
    return result, run


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, choices=("fp8", "tf32", "half"),
                    help="put the control in the program's place in the comparison: the "
                         "reference at a lower precision (fp8, tf32) or on half of each "
                         "batch (half); it should come out not correct. Not a measured run")
    args = ap.parse_args(argv)
    try:
        result, run = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                              control=args.control)
    except (NoDevice, Forbidden) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    detail = {k: run.facts[k] for k in ("control", "readings", "check_detail", "check_s",
                                        "store_build_s", "setup_s", "launches", "batch_s",
                                        "served_lengths")
              if k in run.facts}
    print("portbench detail " + json.dumps(detail, default=str), file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'OVER'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
