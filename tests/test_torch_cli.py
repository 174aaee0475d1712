"""`fit` of the port on the CPU: the settings it refuses, and the run
record it writes.

A config whose mesh the world cannot form (a (2, 2) mesh in a world of
one process) raises before any work, naming the ``torchrun`` command that
forms it, instead of training on one device without a word; a mesh with
one axis given runs on one device, as the JAX package's `build_mesh`
rules. A baseline config goes to `run_fit_baseline`, and
`run_fit` itself refuses one. `fit` writes the resolved config beside its
metrics, as the reference's does.
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
    """configs/baseline_bart.yaml names `baseline: bart`: `run_fit` (the
    retrieval-augmented trainer) refuses it and writes nothing; `fit`
    through `main` trains the baseline (`run_fit_baseline`), here T5, to
    its JSON line."""
    cfg = load_config(os.path.join(REPO, "configs", "baseline_bart.yaml"))
    cfg = dataclasses.replace(
        cfg, logging=dataclasses.replace(cfg.logging, log_dir=str(tmp_path / "runs")))
    with pytest.raises(ValueError, match=r"baseline 'bart'.*run_fit_baseline"):
        cli.run_fit(cfg, device="cpu")
    assert not (tmp_path / "runs").exists()
    path = tmp_path / "bart.yaml"
    path.write_text(yaml.safe_dump({**_tiny(tmp_path, max_steps=2, eval_max_batches=1),
                                    "baseline": "t5", "generation": {"max_new_tokens": 4}}))
    capsys.readouterr()
    assert cli.main(["fit", "--config", str(path), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and "rouge1" in out
    assert (tmp_path / "runs" / "t_t5.metrics.jsonl").exists()


@pytest.mark.parametrize("mesh,refused", [
    ({"data": 2}, False), ({"shard": 4}, False), ({"data": 2, "shard": 2}, True),
    ({"data": 1, "shard": 1}, False), ({"data": 0}, False), ({}, False),
])
def test_fit_refuses_a_mesh_of_several_devices(tmp_path, mesh, refused):
    """In a world of one process: a mesh of both axes that needs several
    raises (`fit` over a mesh runs under ``torchrun``,
    tests/test_torch_mesh_fit.py), before any file is written; one axis
    given, 0, 1 or unset is the one device `build_mesh` leaves, and
    `check_fit_config` refuses none of them."""
    cfg = config_from_dict(_tiny(tmp_path, mesh=mesh))
    assert cfg.mesh == MeshConfig(**mesh)
    cli.check_fit_config(cfg)
    if refused:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
            cli.run_fit(cfg, device="cpu")
        assert not (tmp_path / "runs").exists()


def test_fit_refuses_a_teams_webhook(tmp_path, capsys):
    """A webhook is no longer refused: here it names a closed local port, so
    the notifier's post fails, is reported, and the run goes on to its end
    (the cards themselves: tests/test_torch_obs.py)."""
    cfg = config_from_dict(_tiny(tmp_path, logging={
        "log_dir": str(tmp_path / "runs"), "teams_webhook": "http://localhost:9/hook"}))
    assert cli.run_fit(cfg, device="cpu")["steps"] == 1
    assert "[fault_tolerant] _post failed" in capsys.readouterr().out


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
assert cli.main(["fit", "--config", sys.argv[2], "--device", "cpu"]) == 0
import gzip, os
import numpy as np
from retrieval_augmented_mds_tpu_torch.data import ingest
from retrieval_augmented_mds_tpu_torch.utils.cpu_baseline import cpu_mips_search
x = np.eye(8, dtype=np.float32)
assert cpu_mips_search(x, x[:2], 1)[1].ravel().tolist() == [0, 1]
src = os.path.join(sys.argv[3], "snap")
os.makedirs(src)
with gzip.open(os.path.join(src, "p.gz"), "wt") as f:
    f.write(json.dumps({"id": "W", "abstract_inverted_index": {"a": [0]}}) + "\\n")
assert ingest.build_openalex_abstracts(src, os.path.join(sys.argv[3], "oa.parquet")) == 1
bad = sorted(k for k, v in sys.modules.items() if v is not None and (
    k == "jax" or k.startswith("jax.") or k == "retrieval_augmented_mds_tpu"
    or k.startswith("retrieval_augmented_mds_tpu.")))
print(json.dumps({"bad": bad}))
"""


def test_pretrain_retriever_imports_nothing_of_jax(tmp_path):
    """A fresh interpreter runs `pretrain-retriever --device cpu` in its
    three modes (the retriever modules, the validation's flat search, the
    export and import of encoders.npz), then `fit --device cpu` with
    ``baseline: bart`` and TensorBoard and mlflow on (the baseline modules,
    the obs tail), the native CPU search and an ingestion; neither JAX nor
    the JAX package is then loaded."""
    import subprocess
    import sys

    d = _tiny(tmp_path, max_steps=2, eval_every=1, ckpt_dir=str(tmp_path / "ckpt"),
              retriever={"token_loss": True, "eval_k": 4})
    path = tmp_path / "r.yaml"
    path.write_text(yaml.safe_dump(d))
    bart = tmp_path / "b.yaml"
    bart.write_text(yaml.safe_dump(_tiny(
        tmp_path, baseline="bart", max_steps=2, eval_max_batches=1,
        generation={"max_new_tokens": 4},
        logging={"log_dir": str(tmp_path / "b"), "run_name": "g", "tensorboard": True,
                 "mlflow": True})))
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    res = subprocess.run([sys.executable, "-c", _GUARD, str(path), str(bart), str(tmp_path)],
                         cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"bad": []}
    assert (tmp_path / "ckpt" / "encoders.npz").exists()
    assert (tmp_path / "b" / "g_bart.metrics.jsonl").exists()
    assert os.listdir(tmp_path / "b" / "tb" / "g_bart") and (tmp_path / "b" / "mlruns").exists()
