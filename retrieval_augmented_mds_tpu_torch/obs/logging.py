"""Metrics logging + artifact dumps.

Counterpart of ``retrieval_augmented_mds_tpu/obs/logging.py``, owned by
the port (no JAX). Replaces the reference's MLFlow + TensorBoard dual
loggers (config/no_mips.yaml:18-25, sotasum/pretrain.py:570-579) with a
dependency-free JSONL metrics writer (one line per step — trivially
ingested by any tracker) plus the per-epoch output JSON dumps the
reference writes (sotasum/lightning_model.py:377-389, 400-416). With
``tensorboard`` or ``mlflow`` set, every logged row is mirrored into a
TensorBoard event file (``<log_dir>/tb/<run_name>``, `obs.tb`) or an mlflow
file store (``<log_dir>/mlruns``, `obs.mlflow`), as the JAX package does.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Callable


def fault_tolerant(f: Callable) -> Callable:
    """Blanket guard for observability paths (reference decorator at
    sotasum/lightning_model.py:20-28): never let logging kill training."""

    @functools.wraps(f)
    def wrapper(*a, **k):
        try:
            return f(*a, **k)
        except Exception as e:  # noqa: BLE001
            print(f"[fault_tolerant] {f.__name__} failed: {e}")
            return None

    return wrapper


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run",
                 tensorboard: bool = False, mlflow: bool = False):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()
        self._tb = None
        self._mlflow = None
        if tensorboard:
            # opt-in standard-format mirror; JSONL stays the primary sink
            from .tb import TBEventWriter

            self._tb = TBEventWriter(os.path.join(log_dir, "tb", run_name))
        if mlflow:
            from .mlflow import MlflowFileStore

            self._mlflow = MlflowFileStore(os.path.join(log_dir, "mlruns"), run_name=run_name)

    @fault_tolerant
    def log(self, step: int, metrics: dict[str, Any], prefix: str = ""):
        row = {"step": int(step), "time": round(time.time() - self.t0, 3)}
        for k, v in metrics.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                row[prefix + k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(step, {prefix + k: v for k, v in metrics.items()})
        if self._mlflow is not None:
            self._mlflow.log_metrics({prefix + k: v for k, v in metrics.items()}, step)

    @fault_tolerant
    def log_hyperparams(self, config: dict[str, Any]):
        """Full-config dump (reference `before_fit` hyperparam log,
        main.py:13-15)."""
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
        if self._mlflow is not None:
            self._mlflow.log_params(config)

    @fault_tolerant
    def dump_outputs(self, name: str, outputs: list[dict]):
        """Per-epoch generation dumps (lightning_model.py:383-389)."""
        with open(os.path.join(self.log_dir, f"{name}.json"), "w") as f:
            json.dump(outputs, f, indent=1, default=str)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._mlflow is not None:
            self._mlflow.close()
