"""`validate` and `test` over a (data, shard) mesh, on the CPU.

Four processes (`torch_mesh_launch`: fresh interpreters, gloo on a
``file://`` store under ``tmp_path``) run `cli.run_validate` of
``configs/smoke.yaml`` with ``mesh: {data: 2, shard: 2}`` and
``model.sequence_shard: true``: the store embedded data-parallel and
placed sharded, each data rank encoding (sequence-sharded LED) and
generating for its 2 rows of every batch, the ids gathered over ``data``.
Every rank's generated ids and ROUGE equal the port's single-device run on
an index of the same cluster count (`Flat`; ``IVF16,SQ8``, which 2 shards
round to 14 clusters, against ``IVF14,SQ8``), its retrieved ids equal the
single-device rows it holds, and its LED encoder states agree with them to
rtol = atol = 1e-5 (f32; the global rows' softmax sums across ranks in
another order). This is the JAX package's ``tests/test_multichip.py``
``test_sharded_generate_matches_unsharded`` for the port. Then the
command line itself runs over the mesh (`cli.main`), and the settings the
mesh refuses raise.
"""

import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.parallel import MeshSpec, best_mesh, build_mesh
from torch_mesh_launch import RankFailure, launch, store_url
from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 300  # s: the launch takes ~30 s here; a hang is killed, never waited out
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {  # name: (split, mesh factory, single-device factory)
    "flat_val": ("val", "Flat", "Flat"),
    "flat_test": ("test", "Flat", "Flat"),
    "ivf_val": ("val", "IVF16,SQ8", "IVF14,SQ8"),
}


def _config(log_dir, factory, mesh=True):
    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"]["sequence_shard"] = True
    d["index"] = {"factory": factory, "nprobe": 2, "rebuild_every": 0}
    d["logging"] = {"log_dir": log_dir, "run_name": "mesh"}
    if mesh:
        d["mesh"] = {"data": 2, "shard": 2}
    return d


def _summary(out, rep):
    return {"rouge": out, "ids": torch.cat(rep["ids"]).numpy(),
            "idx": torch.cat([e.retrieved_idx for e in rep["enc"]]).numpy(),
            "enc": torch.cat([e.enc_hidden for e in rep["enc"]]).numpy()}


def rank_validate(init, root):
    """One rank: the CASES over the (2, 2) mesh, then `cli.main validate`
    (whose rank 0 prints the JSON line) → {case: summary, ...}."""
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init)
    out = {}
    for name, (split, factory, _) in CASES.items():
        rep = {}
        cfg = config_from_dict(_config(os.path.join(root, name), factory))
        res = cli.run_validate(cfg, split, device="cpu", report=rep)
        out[name] = _summary(res, rep)
        mesh, index = rep["mesh"], rep["store"].index
        out[name]["placement"] = (mesh.d, mesh.s, mesh.backend, index.shards)
    path = os.path.join(root, "main.yaml")
    if torch.distributed.get_rank() == 0:
        with open(path, "w") as f:
            yaml.safe_dump(_config(os.path.join(root, "main"), "Flat"), f)
    torch.distributed.barrier()
    out["main"] = cli.main(["validate", "--config", path, "--device", "cpu"])
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "retrieval_augmented_mds_tpu.")) or m == "retrieval_augmented_mds_tpu")
    return out


def _single(root, name):
    split, _, factory = CASES[name]
    rep = {}
    cfg = config_from_dict(_config(os.path.join(root, "single_" + name), factory, mesh=False))
    return _summary(cli.run_validate(cfg, split, device="cpu", report=rep), rep)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_eval"))
    t0 = time.perf_counter()
    results = launch(f"{__name__}:rank_validate", 4, workdir=os.path.join(root, "ranks"),
                     args=(store_url(os.path.join(root, "ranks")), root),
                     timeout=LAUNCH_TIMEOUT)
    return root, results, time.perf_counter() - t0


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_validate_equals_single_device(mesh_run, name):
    """Each case over the (2, 2) mesh against the single-device run: the
    same generated ids and ROUGE on every rank, the single-device retrieved
    ids and encoder states at each rank's rows; the index sharded 2 ways;
    one output dump, rank 0's."""
    root, results, _ = mesh_run
    ref = _single(root, name)
    for r, res in enumerate(results):
        got = res[name]
        d, s, backend, shards = got["placement"]
        assert (d, s, backend, shards) == (r // 2, r % 2, "gloo", 2)
        np.testing.assert_array_equal(got["ids"], ref["ids"], err_msg=f"rank {r}")
        assert got["rouge"] == ref["rouge"], (r, got["rouge"], ref["rouge"])
        rows = ref["idx"].reshape(-1, 4, *ref["idx"].shape[1:])[:, 2 * d:2 * d + 2]
        np.testing.assert_array_equal(got["idx"], rows.reshape(got["idx"].shape))
        enc = ref["enc"].reshape(-1, 4, *ref["enc"].shape[1:])[:, 2 * d:2 * d + 2]
        np.testing.assert_allclose(got["enc"], enc.reshape(got["enc"].shape), **ENC_TOL)
    split = CASES[name][0]
    assert len(glob.glob(os.path.join(root, name, f"{split}_outputs_*.json"))) == 1


def test_mesh_cli_prints_on_rank_zero_and_loads_no_jax(mesh_run):
    """`cli.main validate` over the mesh: exit 0 on every rank, one JSON
    line (rank 0's) equal to the run's ROUGE; no rank loaded JAX or the
    JAX package."""
    root, results, _ = mesh_run
    assert [r["main"] for r in results] == [0] * 4
    assert all(r["modules"] == [] for r in results), [r["modules"] for r in results]
    lines = []
    for r in range(4):
        with open(os.path.join(root, "ranks", f"rank{r}.log")) as f:
            lines.append([ln for ln in f.read().splitlines() if ln.startswith("{")])
    assert [len(x) for x in lines] == [1, 0, 0, 0], lines
    assert json.loads(lines[0][0]) == results[0]["flat_val"]["rouge"]


def test_build_mesh_follows_the_jax_rules(monkeypatch):
    """`build_mesh`: data or shard 0 → None; both given → that mesh, which
    must cover the world, else ValueError before any process group; a
    world of 1 without both → None (with a word on stderr when one is
    given)."""
    for mesh in ({"data": 0}, {"shard": 0, "data": 4}, {}, {"data": 2}, {"shard": 2}):
        cfg = config_from_dict({"mesh": mesh})
        assert build_mesh(cfg, "cpu") is None
    cfg = config_from_dict({"mesh": {"data": 2, "shard": 2}})
    with pytest.raises(ValueError, match="needs 4 processes, the world has 1"):
        build_mesh(cfg, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs 4 processes, the world has 2"):
        build_mesh(cfg, "cpu")
    assert not torch.distributed.is_initialized()


def test_validate_refuses_a_mesh_the_world_cannot_form(tmp_path):
    """`validate` of a (2, 2) mesh config in a world of one process raises:
    it never runs on one device without a word."""
    cfg = config_from_dict(_config(str(tmp_path), "Flat"))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        cli.run_validate(cfg, device="cpu")


def test_fit_over_a_mesh_is_accepted_and_a_baseline_still_raises(tmp_path):
    """`check_fit_config` accepts the (2, 2) mesh config (`fit` over it runs
    under torchrun: tests/test_torch_mesh_fit.py) and refuses only a
    baseline; in a world of one process that mesh raises the launch it
    needs, as `validate` does, before any file is written."""
    cfg = config_from_dict(_config(str(tmp_path / "runs"), "Flat"))
    cli.check_fit_config(cfg)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        cli.run_fit(cfg, device="cpu")
    assert not (tmp_path / "runs").exists()
    with pytest.raises(ValueError, match="baseline 'bart'"):
        cli.check_fit_config(dataclasses.replace(cfg, baseline="bart"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_best_mesh_factorises_as_jax(n):
    """`best_mesh` and JAX's on the forced CPU devices: the same (data,
    shard) for every world size they hold, and with a preferred shard."""
    from retrieval_augmented_mds_tpu.parallel import best_mesh as jbest

    jm = jbest(n)
    assert best_mesh(n) == MeshSpec(jm.shape["data"], jm.shape["shard"])
    if n % 2 == 0:
        jm = jbest(n, prefer_shard=2)
        assert best_mesh(n, prefer_shard=2) == MeshSpec(jm.shape["data"], jm.shape["shard"])


def rank_fails(init, mode):
    """Rank 1 raises (or hangs) while rank 0 waits for it in a collective."""
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed
    from retrieval_augmented_mds_tpu_torch.parallel.collectives import all_reduce

    init_distributed("cpu", init_method=init)
    if torch.distributed.get_rank() == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails")
        time.sleep(3600)
    return all_reduce(torch.ones(1), None).item()


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_a_dead_rank_fails_the_launch_without_a_hang(tmp_path, mode):
    """A rank that raises fails the launch at once (its peer, waiting in a
    collective, is killed rather than left to its 60 s group timeout); a
    rank that hangs is killed at the launch's timeout. Either way
    `RankFailure` names the ranks, well before any test runner's limit."""
    t0 = time.perf_counter()
    with pytest.raises(RankFailure, match="rank 1 fails" if mode == "raise" else "killed"):
        launch(f"{__name__}:rank_fails", 2, workdir=str(tmp_path),
               args=(store_url(str(tmp_path)), mode), timeout=10)
    assert time.perf_counter() - t0 < 25
