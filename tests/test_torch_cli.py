"""`fit` of the port on the CPU: the settings it refuses, and the run
record it writes.

A config that asks for a part of the reference's `fit` that the port does
not have yet (a baseline model, a mesh of several devices, a Teams
webhook) raises before any work, naming the ROADMAP queue that ports it,
instead of training the RAG model on one device without a word. `fit`
writes the resolved config beside its metrics, as the reference's does.
"""

import dataclasses
import json
import os

import pytest
import yaml

from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.utils.config import (
    MeshConfig,
    config_from_dict,
    load_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(tmp_path, **over):
    d = {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16,
                 "memory_len": 64, "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10,
                  "frozen_groups": ["mips_enc"]},
        "max_steps": 1, "eval_every": 0,
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "t"},
    }
    d.update(over)
    return d


def test_fit_refuses_a_baseline_config(tmp_path, capsys):
    """configs/baseline_bart.yaml names `baseline: bart`: `fit` raises,
    through `main` too, and writes nothing."""
    cfg = load_config(os.path.join(REPO, "configs", "baseline_bart.yaml"))
    cfg = dataclasses.replace(
        cfg, logging=dataclasses.replace(cfg.logging, log_dir=str(tmp_path / "runs")))
    with pytest.raises(NotImplementedError, match=r"baseline 'bart'.*queue 1, item 8"):
        cli.run_fit(cfg, device="cpu")
    path = tmp_path / "bart.yaml"
    path.write_text(yaml.safe_dump({**_tiny(tmp_path), "baseline": "t5"}))
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        cli.main(["fit", "--config", str(path), "--device", "cpu"])
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("mesh,refused", [
    ({"data": 2}, True), ({"shard": 4}, True), ({"data": 2, "shard": 2}, True),
    ({"data": 1, "shard": 1}, False), ({"data": 0}, False), ({}, False),
])
def test_fit_refuses_a_mesh_of_several_devices(tmp_path, mesh, refused):
    """mesh.data or mesh.shard above 1 raises; 0, 1 or unset is the one
    device the port trains on."""
    cfg = config_from_dict(_tiny(tmp_path, mesh=mesh))
    assert cfg.mesh == MeshConfig(**mesh)
    if refused:
        with pytest.raises(NotImplementedError, match="queue 1, item 9"):
            cli.run_fit(cfg, device="cpu")
    else:
        cli.check_fit_config(cfg)


def test_fit_refuses_a_teams_webhook(tmp_path):
    cfg = config_from_dict(_tiny(tmp_path, logging={
        "log_dir": str(tmp_path / "runs"), "teams_webhook": "http://localhost:9/hook"}))
    with pytest.raises(NotImplementedError, match="teams_webhook.*queue 1, item 10"):
        cli.run_fit(cfg, device="cpu")


def test_fit_writes_the_resolved_config(tmp_path):
    """One CPU step; `<log_dir>/config_resolved.yaml` reads back with the
    port's `load_config` into the config the run used, every default
    filled in."""
    cfg = config_from_dict(_tiny(tmp_path))
    out = cli.run_fit(cfg, device="cpu")
    assert out["steps"] == 1
    path = tmp_path / "runs" / "config_resolved.yaml"
    back = load_config(str(path))
    assert back == cfg
    raw = yaml.safe_load(path.read_text())
    assert raw["train"]["frozen_groups"] == ["mips_enc"] and raw["baseline"] is None
    assert raw["model"]["led"]["d_model"] == cfg.model.led.d_model
    rows = [json.loads(x) for x in (tmp_path / "runs" / "t.metrics.jsonl")
            .read_text().splitlines()]
    assert any("loss" in r for r in rows)


_GUARD = """
import json, sys
from retrieval_augmented_mds_tpu_torch import cli
for mode in ("train", "test", "predict"):
    assert cli.main(["pretrain-retriever", "--mode", mode, "--config", sys.argv[1],
                     "--device", "cpu"]) == 0
bad = sorted(k for k, v in sys.modules.items() if v is not None and (
    k == "jax" or k.startswith("jax.") or k == "retrieval_augmented_mds_tpu"
    or k.startswith("retrieval_augmented_mds_tpu.")))
print(json.dumps({"bad": bad}))
"""


def test_pretrain_retriever_imports_nothing_of_jax(tmp_path):
    """A fresh interpreter runs `pretrain-retriever --device cpu` in its
    three modes (the retriever modules, the validation's flat search, the
    export and import of encoders.npz); neither JAX nor the JAX package is
    then loaded."""
    import subprocess
    import sys

    d = _tiny(tmp_path, max_steps=2, eval_every=1, ckpt_dir=str(tmp_path / "ckpt"),
              retriever={"token_loss": True, "eval_k": 4})
    path = tmp_path / "r.yaml"
    path.write_text(yaml.safe_dump(d))
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    res = subprocess.run([sys.executable, "-c", _GUARD, str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"bad": []}
    assert (tmp_path / "ckpt" / "encoders.npz").exists()
