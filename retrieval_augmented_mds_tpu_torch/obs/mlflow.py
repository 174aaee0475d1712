"""Minimal MLflow *file-store* writer (no mlflow dependency).

Counterpart of ``retrieval_augmented_mds_tpu/obs/mlflow.py``, owned by the
port (a copy: the same layout and records, but for the run id and the
times).

The reference tracks every run with an MLFlowLogger pointed at a
file-store tracking URI (config/no_mips.yaml:18-25,
sotasum/pretrain.py:570-579). This sink reproduces that on-disk layout —
``mlruns/<experiment_id>/<run_id>/{meta.yaml,metrics/,params/,tags/}`` —
so a stock ``mlflow ui --backend-store-uri <dir>`` (or MlflowClient)
browses runs written here without any mlflow code in this repo:

  * experiment ``meta.yaml``: name / id / lifecycle_stage / timestamps
  * run ``meta.yaml``: run_id, experiment_id, status, start/end times
  * ``metrics/<key>``: one line per point — ``<timestamp_ms> <value> <step>``
  * ``params/<key>``: the single stringified value
  * ``tags/mlflow.runName``: the run name shown in the UI

Format reference: mlflow.store.tracking.file_store.FileStore (the
line-per-point metric files and key-per-file params are the documented
stable interchange; mlflow has read this layout since 1.x).

Opt-in via ``logging.mlflow: true``; JSONL stays the primary sink
(obs/logging.py) and TensorBoard the other optional mirror (obs/tb.py).
"""

from __future__ import annotations

import os
import re
import time
import uuid


def _now_ms() -> int:
    return int(time.time() * 1000)


def _yaml_dump(d: dict, path: str) -> None:
    # plain scalar mapping — avoid importing yaml for a flat dict
    with open(path, "w") as f:
        for k, v in d.items():
            if isinstance(v, str):
                f.write(f"{k}: {v}\n" if v else f"{k}: ''\n")
            elif v is None:
                f.write(f"{k}: null\n")
            else:
                f.write(f"{k}: {v}\n")


_KEY_RE = re.compile(r"[^A-Za-z0-9_\-./ ]")


def _safe_key(key: str) -> str:
    """File-system-safe metric/param key (mlflow validates similarly)."""
    key = _KEY_RE.sub("_", key).strip("/. ")
    return key or "_"


class MlflowFileStore:
    """One tracked run in an mlflow file store rooted at ``root``."""

    def __init__(self, root: str, run_name: str = "run",
                 experiment: str = "Default"):
        self.root = root
        # experiment 0 is mlflow's default; keep one experiment per store
        self.exp_id = "0"
        exp_dir = os.path.join(root, self.exp_id)
        os.makedirs(exp_dir, exist_ok=True)
        exp_meta = os.path.join(exp_dir, "meta.yaml")
        if not os.path.exists(exp_meta):
            _yaml_dump(
                {
                    "artifact_location": f"file://{os.path.abspath(exp_dir)}",
                    "creation_time": _now_ms(),
                    "experiment_id": self.exp_id,
                    "last_update_time": _now_ms(),
                    "lifecycle_stage": "active",
                    "name": experiment,
                },
                exp_meta,
            )
        self.run_id = uuid.uuid4().hex
        self.run_dir = os.path.join(exp_dir, self.run_id)
        for sub in ("metrics", "params", "tags", "artifacts"):
            os.makedirs(os.path.join(self.run_dir, sub), exist_ok=True)
        self._start = _now_ms()
        self._write_run_meta(status="RUNNING", end_time=None)
        self.set_tag("mlflow.runName", run_name)

    def _write_run_meta(self, status: str, end_time):
        _yaml_dump(
            {
                "artifact_uri":
                    f"file://{os.path.abspath(self.run_dir)}/artifacts",
                "end_time": end_time,
                "entry_point_name": "",
                "experiment_id": self.exp_id,
                "lifecycle_stage": "active",
                "run_id": self.run_id,
                "run_uuid": self.run_id,
                "run_name": "",
                "source_name": "",
                "source_type": 4,  # LOCAL
                "source_version": "",
                "start_time": self._start,
                "status": status,
                "user_id": os.environ.get("USER", "unknown"),
            },
            os.path.join(self.run_dir, "meta.yaml"),
        )

    def set_tag(self, key: str, value: str) -> None:
        path = os.path.join(self.run_dir, "tags", _safe_key(key))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(str(value))

    def log_param(self, key: str, value) -> None:
        path = os.path.join(self.run_dir, "params", _safe_key(key))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):  # params are write-once in mlflow
            with open(path, "w") as f:
                f.write(str(value))

    def log_params(self, params: dict, prefix: str = "") -> None:
        """Flatten a nested config dict into dotted param keys (the shape
        the reference's before_fit hyperparam dump produces)."""
        for k, v in params.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                self.log_params(v, prefix=f"{key}.")
            else:
                self.log_param(key, v)

    def log_metric(self, key: str, value: float, step: int) -> None:
        path = os.path.join(self.run_dir, "metrics", _safe_key(key))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(f"{_now_ms()} {value} {int(step)}\n")

    def log_metrics(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            try:
                self.log_metric(k, float(v), step)
            except (TypeError, ValueError):
                continue  # non-scalar values stay JSONL-only

    def close(self, status: str = "FINISHED") -> None:
        self._write_run_meta(status=status, end_time=_now_ms())
