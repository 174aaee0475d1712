"""The port's observability tail against the JAX package's, on the CPU: the
TensorBoard event writer and the mlflow file store (the same records from
the same scalars, read back as TensorBoard and mlflow read them), their
wiring into `MetricsLogger`, the Teams notifier (posting to a local
``http.server`` only), and the profiling helpers with ``fit --profile``.
Wall times, the file name's host and time, and the mlflow run id may
differ; nothing else may."""

import http.server
import json
import os
import struct
import threading

import numpy as np
import pytest
import yaml

from retrieval_augmented_mds_tpu.obs import callbacks as jcallbacks
from retrieval_augmented_mds_tpu.obs import logging as jlogging
from retrieval_augmented_mds_tpu.obs import mlflow as jmlflow
from retrieval_augmented_mds_tpu.obs import tb as jtb
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.obs import callbacks as tcallbacks
from retrieval_augmented_mds_tpu_torch.obs import logging as tlogging
from retrieval_augmented_mds_tpu_torch.obs import mlflow as tmlflow
from retrieval_augmented_mds_tpu_torch.obs import profiling as tprofiling
from retrieval_augmented_mds_tpu_torch.obs import tb as ttb
from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

SCALARS = [(0, {"loss": 2.0, "lr": 0.0}), (1, {"loss": np.float32(1.75), "lr": 1e-4}),
           (7, {"loss": 1.23, "note": "a string", "val_rouge1": 0.25})]


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if not b & 0x80:
            return out, i


def _fields(buf: bytes) -> list[tuple[int, object]]:
    """A protobuf message → [(field number, value)]: varints as ints,
    fixed64/fixed32 as their bytes, length-delimited as bytes."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        out.append((num, v))
    return out


def tb_records(log_dir) -> list:
    """Every event of the one event file in ``log_dir``, each TFRecord's two
    masked CRC32Cs checked, its wall time (field 1) dropped."""
    (name,) = os.listdir(log_dir)
    assert name.startswith("events.out.tfevents.")
    data = open(os.path.join(log_dir, name), "rb").read()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == ttb._masked_crc(header)
        record = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == ttb._masked_crc(record)
        events.append([f for f in _fields(record) if f[0] != 1])
        i += 16 + n
    return events


def test_tb_writer_writes_the_jax_records(tmp_path):
    """The same scalars through both writers: the same events (file
    version, steps, tags and f32 values; the non-numeric one dropped), and
    TensorBoard's own reader gets the same scalars from both."""
    for pkg, sub in ((ttb, "t"), (jtb, "j")):
        w = pkg.TBEventWriter(str(tmp_path / sub))
        for step, scalars in SCALARS:
            w.add_scalars(step, scalars)
        w.close()
    got, ref = tb_records(tmp_path / "t"), tb_records(tmp_path / "j")
    assert got == ref and len(got) == 1 + len(SCALARS)
    assert got[0] == [(3, b"brain.Event:2")]
    assert ttb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    ea = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    read = []
    for sub in ("t", "j"):
        acc = ea.EventAccumulator(str(tmp_path / sub))
        acc.Reload()
        read.append({tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                     for tag in acc.Tags()["scalars"]})
    assert read[0] == read[1]
    assert set(read[0]) == {"loss", "lr", "val_rouge1"}
    assert [s for s, _ in read[0]["loss"]] == [0, 1, 7]
    np.testing.assert_allclose([v for _, v in read[0]["loss"]], [2.0, 1.75, 1.23], rtol=1e-6)


def _yaml(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def mlflow_store(root) -> dict:
    """An mlflow file store as mlflow reads it: the experiment's and the
    run's meta.yaml (times, ids and paths dropped), every metric's
    (value, step) points, the params and the tags."""
    exp = os.path.join(root, "0")
    (run,) = [d for d in os.listdir(exp) if os.path.isdir(os.path.join(exp, d))]
    rd = os.path.join(exp, run)
    drop = {"artifact_location", "creation_time", "last_update_time", "artifact_uri",
            "end_time", "start_time", "run_id", "run_uuid"}
    emeta, rmeta = _yaml(os.path.join(exp, "meta.yaml")), _yaml(os.path.join(rd, "meta.yaml"))
    assert rmeta["run_id"] == rmeta["run_uuid"] == run and rmeta["end_time"] > 0
    assert rmeta["artifact_uri"] == f"file://{os.path.abspath(rd)}/artifacts"

    def files(sub):
        out = {}
        for dirpath, _, names in os.walk(os.path.join(rd, sub)):
            for n in names:
                key = os.path.relpath(os.path.join(dirpath, n), os.path.join(rd, sub))
                out[key] = open(os.path.join(dirpath, n)).read()
        return out

    metrics = {}
    for key, text in files("metrics").items():
        points = [line.split() for line in text.splitlines()]
        assert all(int(ts) > 1_000_000_000_000 for ts, _, _ in points)
        metrics[key] = [(float(v), int(s)) for _, v, s in points]
    return {"experiment": {k: v for k, v in emeta.items() if k not in drop},
            "run": {k: v for k, v in rmeta.items() if k not in drop},
            "metrics": metrics, "params": files("params"), "tags": files("tags"),
            "subdirs": sorted(os.listdir(rd))}


def test_mlflow_store_writes_the_jax_records(tmp_path):
    for pkg, sub in ((tmlflow, "t"), (jmlflow, "j")):
        store = pkg.MlflowFileStore(str(tmp_path / sub), run_name="myrun")
        store.log_params({"train": {"lr": 3e-5, "warmup_steps": 10}, "seed": 0,
                          "odd key!": "x"})
        store.log_param("seed", 99)  # write-once
        for step, scalars in SCALARS:
            store.log_metrics(scalars, step)
        store.close()
    got, ref = mlflow_store(tmp_path / "t"), mlflow_store(tmp_path / "j")
    assert got == ref
    assert got["run"]["status"] == "FINISHED"
    assert got["params"]["seed"] == "0" and got["params"]["train.lr"] == "3e-05"
    assert got["metrics"]["loss"] == [(2.0, 0), (1.75, 1), (1.23, 7)]
    assert "note" not in got["metrics"] and got["tags"] == {"mlflow.runName": "myrun"}


def test_metrics_logger_mirrors_write_the_jax_records(tmp_path):
    """`MetricsLogger` with both mirrors on, fed the same rows and
    hyperparameters as the JAX package's: the same JSONL rows (times
    aside), TensorBoard events under ``tb/<run_name>`` and mlflow store
    under ``mlruns``."""
    rows = []
    for pkg, sub in ((tlogging, "t"), (jlogging, "j")):
        log = pkg.MetricsLogger(str(tmp_path / sub), "run", tensorboard=True, mlflow=True)
        log.log_hyperparams({"seed": 1, "data": {"batch_size": 4}})
        log.log(0, {"loss": 1.5})
        log.log(1, {"rouge1": 0.2, "note": object}, prefix="val_")
        log.close()
        rows.append([{k: v for k, v in json.loads(x).items() if k != "time"}
                     for x in open(tmp_path / sub / "run.metrics.jsonl")])
    assert rows[0] == rows[1]
    assert tb_records(tmp_path / "t" / "tb" / "run") == tb_records(tmp_path / "j" / "tb" / "run")
    got, ref = mlflow_store(tmp_path / "t" / "mlruns"), mlflow_store(tmp_path / "j" / "mlruns")
    assert got == ref and got["params"]["data.batch_size"] == "4"
    assert set(got["metrics"]) == {"loss", "val_rouge1"}


class _Hook(http.server.BaseHTTPRequestHandler):
    posts: list = []

    def do_POST(self):  # noqa: N802
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).posts.append((self.path, self.headers["Content-Type"], json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def hook():
    """A webhook on localhost → (its URL, the posts it received)."""
    _Hook.posts = []
    server = http.server.HTTPServer(("127.0.0.1", 0), _Hook)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/hook", _Hook.posts
    server.shutdown()
    server.server_close()


def test_teams_notifier_posts_the_jax_cards(hook):
    """Each callback posts the JAX notifier's card as JSON; with no URL
    nothing is posted; a failing post is reported and swallowed."""
    url, posts = hook
    for pkg in (tcallbacks, jcallbacks):
        n = pkg.TeamsNotifier(url, "myrun")
        n.on_fit_start({"lr": 0.1})
        n.on_exception(ValueError("boom"))
        pkg.TeamsNotifier(None, "off").on_fit_start()
    assert len(posts) == 4
    assert posts[:2] == posts[2:]
    assert all(p[:2] == ("/hook", "application/json") for p in posts)
    assert posts[0][2] == {"@type": "MessageCard", "title": "myrun: training started",
                           "text": "training started",
                           "sections": [{"facts": [{"name": "lr", "value": "0.1"}]}]}
    assert posts[1][2]["sections"][0]["facts"] == [{"name": "error",
                                                   "value": "ValueError('boom')"}]
    dead = url.rsplit(":", 1)[0] + ":9/hook"  # a closed port on this host
    assert tcallbacks.TeamsNotifier(dead, "x").on_fit_start() is None


def _tiny(tmp_path, **over) -> dict:
    d = {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16,
                 "memory_len": 64, "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10},
        "max_steps": 1, "eval_every": 0,
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "t"},
    }
    d.update(over)
    return d


def test_fit_tells_teams_when_it_starts_and_when_it_crashes(tmp_path, hook, monkeypatch):
    """``logging.teams_webhook`` on `run_fit`: one card when the run starts
    and, when a step raises, one more with the error, then the error
    propagates (as the JAX package's run_fit)."""
    url, posts = hook
    cfg = config_from_dict(_tiny(tmp_path, logging={
        "log_dir": str(tmp_path / "runs"), "run_name": "t", "teams_webhook": url}))
    assert cli.run_fit(cfg, device="cpu")["steps"] == 1
    assert [p[2]["title"] for p in posts] == ["t: training started"]

    from retrieval_augmented_mds_tpu_torch.train import trainer

    def broken(*a, **k):
        def step(*a, **k):
            raise RuntimeError("step failed")
        return step

    monkeypatch.setattr(trainer, "make_train_step", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        cli.run_fit(cfg, device="cpu")
    assert [p[2]["title"] for p in posts] == ["t: training started", "t: training started",
                                              "t: training crashed"]
    assert "step failed" in posts[-1][2]["sections"][0]["facts"][0]["value"]


def test_phase_timer_and_trace(tmp_path):
    """The phase timer's successor, `span`: spans run and nest outside a
    profiler and record nothing there, also when the block raises; `trace`
    writes one Chrome trace of the block, also when it raises, with the
    spans opened in it as ranges there and in `recorded`."""
    import torch

    for _ in range(3):
        with tprofiling.span("a"):
            with tprofiling.span("b"):
                pass
    with pytest.raises(KeyError):
        with tprofiling.span("b"):
            raise KeyError("x")
    with tprofiling.trace(str(tmp_path / "t1")):
        with tprofiling.span("a"):
            torch.ones(8).cumsum(0)
    assert [s.name for s in tprofiling.recorded()] == ["a"]
    with pytest.raises(ValueError):
        with tprofiling.trace(str(tmp_path / "t2")):
            with tprofiling.span("b"):
                raise ValueError("inside")
    assert [(s.name, s.end_ns >= s.start_ns) for s in tprofiling.recorded()] == [("b", True)]
    for sub in ("t1", "t2"):
        (name,) = os.listdir(tmp_path / sub)
        events = json.load(open(tmp_path / sub / name))["traceEvents"]
        assert isinstance(events, list)
    names = {e.get("name") for e in json.load(open(tmp_path / "t1" / name))["traceEvents"]}
    assert {"aten::cumsum", "a"} <= names


def test_fit_profile_writes_a_trace(tmp_path):
    """``fit --profile --device cpu`` on the BART baseline: a Chrome trace
    under ``<log_dir>/trace`` holding the run's ops, beside the metrics."""
    d = _tiny(tmp_path, baseline="bart", max_steps=2, eval_max_batches=1)
    d["generation"] = {"max_new_tokens": 4}
    path = tmp_path / "b.yaml"
    path.write_text(yaml.safe_dump(d))
    assert cli.main(["fit", "--config", str(path), "--device", "cpu", "--profile"]) == 0
    (name,) = os.listdir(tmp_path / "runs" / "trace")
    events = json.load(open(tmp_path / "runs" / "trace" / name))["traceEvents"]
    assert "aten::log_softmax" in {e.get("name") for e in events}
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("baseline_step") == 2 and "baseline_generate" in ranges
    assert (tmp_path / "runs" / "t_bart.metrics.jsonl").exists()
