"""Training over a (data, shard) mesh against the JAX package, on the CPU.

One launch of 4 processes (`torch_mesh_launch`: fresh interpreters, gloo
on a ``file://`` store under the module's temporary directory) forms the
(data 2, shard 2) mesh and runs, in order:

* one train step of the tiny RAG model (JAX parameters through
  `bridge.load_jax_params`, inputs from a numpy seed, B = 4 so 2 rows a
  data rank, its labels padded unevenly so the data ranks hold different
  numbers of active tokens), the LED encoder sequence-sharded: on a Flat
  store with AdamW (bf16 mu) ZeRO-sharded, on the same with the 8-bit
  AdamW ZeRO-sharded (its superleaf rows split over ``data``), on the same
  with ``remat: true``, and on an ``IVF8,SQ8`` store (the JAX package's
  index, its 8 clusters split over ``shard``, nprobe 2);
* the two ZeRO optimizers alone, four steps of given gradients on a small
  tree whose 8-bit superleaf has an odd row count (41, padded to 42);
* the contrastive loss with ``gather_axis="data"`` and one retriever step;
* `cli.run_fit` of ``configs/smoke.yaml`` over the mesh (3 steps, the
  store refreshed before steps 1 and 2, an eval over the mesh at step 3, a
  checkpoint), then `cli.main fit` (which ends each rank's process group).

The parent holds these against the JAX package's mesh step
(``make_train_step(mesh=MeshSpec(2, 2).build())`` on the forced CPU
devices of ``tests/conftest.py``), its optimizers and ``jax.shard_map``,
and against the port's own single-device `run_fit`. Tolerances are stated
at each test.
"""

import dataclasses
import hashlib
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_mesh_launch import launch, store_url

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 400  # s: the launch takes ~60 s here; a hang is killed, never waited out
B, S, T_DEC, N, LM, LQ = 4, 128, 16, 64, 64, 64
HYPER = dict(lr=5e-4, warmup_steps=1, total_steps=100, weight_decay=0.01, grad_clip=1.0)
NPROBE = 2
MESH = (2, 2)


# ---------------------------------------------------------------------------
# inputs, shared by the parent and the ranks (no JAX at module level: the
# ranks import this module)
# ---------------------------------------------------------------------------

def host_inputs(seed: int = 19) -> dict:
    """Store arrays and a batch of B rows (numpy), tiny-preset vocabularies."""
    rng = np.random.default_rng(seed)
    v, bos, sep, pad = 512, 0, 511, 1
    emb = rng.standard_normal((N, 64)).astype(np.float32)
    ids = rng.integers(4, v, (N, LM)).astype(np.int32)
    ids[:, 0] = bos
    mask = np.ones((N, LM), np.int32)
    mask[::3, 50:] = 0
    input_ids = rng.integers(4, v - 2, (B, S)).astype(np.int32)
    input_ids[:, 0] = bos
    input_ids[:, 40] = sep
    input_ids[:, 100] = sep  # a global in the second LED block
    attn = np.ones((B, S), np.int32)
    attn[1, 110:] = 0
    attn[3, 60:] = 0  # its second LED block all padding
    ignore = np.full((B, 8), -1, np.int32)
    ignore[:, :2] = rng.integers(0, N, (B, 2))
    labels = rng.integers(3, v, (B, T_DEC)).astype(np.int32)
    labels[0, 11:] = pad
    labels[2, 4:] = pad  # data rank 1 holds fewer active tokens than rank 0
    batch = {"input_ids": input_ids, "attention_mask": attn,
             "query_input_ids": rng.integers(4, v, (B, LQ)).astype(np.int32),
             "query_attention_mask": np.ones((B, LQ), np.int32), "mips_ignore": ignore,
             "labels": labels, "gold_aid": rng.integers(0, 20, B).astype(np.int32),
             "aid_counts": rng.integers(1, 4, B).astype(np.int32)}
    return {"emb": emb, "ids": ids, "mask": mask,
            "aids": rng.integers(0, 20, (N, 3)).astype(np.int32), "batch": batch}


def opt_tree() -> dict:
    """A small parameter tree: a leaf sharded on its second axis, one
    replicated (5 rows), eleven sharded on their only axis; 41 superleaf
    blocks."""
    rng = np.random.default_rng(3)
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"led": {"w": leaf(4, 130), "b": leaf(5)},
            "copy_head": [{"x": leaf(300)} for _ in range(11)],
            "mips_encoder": {"w": leaf(200)}}


OPT_CASES = {
    "clip_decay": dict(grad_clip=0.5, weight_decay=0.02),
    "no_clip": dict(grad_clip=None),
    "frozen_accumulate": dict(grad_clip=0.5, frozen_groups=("mips_encoder",),
                              accumulate_steps=2),
}
RET_ENC = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ffn=128, max_len=128,
               window=16, max_globals=4)


def smoke_config(root: str, name: str, mesh: bool, **over) -> dict:
    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"]["sequence_shard"] = True
    d["index"] = {"factory": "Flat", "rebuild_every": 1}
    d.update(max_steps=3, eval_every=3, eval_max_batches=1,
             ckpt_dir=os.path.join(root, name, "ckpt"),
             logging={"log_dir": os.path.join(root, name), "run_name": name})
    if mesh:
        d["mesh"] = {"data": MESH[0], "shard": MESH[1]}
    d.update(over)
    return d


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

class _Keep:
    """Wraps an optimizer: keeps the (all-reduced) gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def update(self, params, grads, state):
        self.grads = {n: g.detach().clone() for n, g in grads.items()}
        return self.tx.update(params, grads, state)


class _Tree(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, _Tree(v))
            elif isinstance(v, list):
                setattr(self, k, torch.nn.ModuleList(_Tree(x) for x in v))
            else:
                setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _digest(module) -> str:
    h = hashlib.sha1()
    for _, p in module.named_parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _arrays(flat: dict) -> dict:
    """An optimizer's state arrays as CPU tensors (bf16 kept)."""
    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v)) for k, v in flat.items()}


def _local_bytes(opt_state) -> int:
    return sum(v.numel() * v.element_size() for v in vars(opt_state).values()
               if isinstance(v, torch.Tensor))


def _train_steps(mesh, rank, args) -> dict:
    from retrieval_augmented_mds_tpu_torch.bridge import ivf_index_from_arrays, load_jax_params
    from retrieval_augmented_mds_tpu_torch.index.flat import build_flat_index
    from retrieval_augmented_mds_tpu_torch.models.led import shift_tokens_right
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import (
        MemoryStore,
        RAGConfig,
        init_rag,
    )
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu_torch.train.trainer import TrainState, make_train_step
    from retrieval_augmented_mds_tpu_torch.utils.config import TrainHyper

    cfg = RAGConfig.tiny(sequence_shard=True)
    host = host_inputs()
    t = torch.from_numpy
    stores = {
        "flat": build_flat_index(t(host["emb"]), dtype="float32", mesh=mesh),
        "ivf": ivf_index_from_arrays(args["ivf_arrays"], mesh=mesh, **args["ivf_static"]),
    }
    stores = {k: MemoryStore(index=v, token_ids=t(host["ids"]), token_mask=t(host["mask"]),
                             row_aids=t(host["aids"]), nprobe=NPROBE)
              for k, v in stores.items()}
    rows = mesh.data_rows(B)
    batch = {k: t(v[rows]) for k, v in host["batch"].items()}
    batch["decoder_input_ids"] = shift_tokens_right(batch["labels"], cfg.led.pad_id, 2)
    out = {}
    for name, store, kw in (("flat", "flat", {}), ("flat_8bit", "flat", {"adam_8bit": True}),
                            ("flat_remat", "flat", {"remat": True}), ("ivf", "ivf", {})):
        hyper = TrainHyper(**HYPER, **kw)
        model = load_jax_params(init_rag(cfg, torch.Generator().manual_seed(0)), args["params"])
        tx = build_optimizer(hyper.lr, hyper.warmup_steps, hyper.total_steps,
                             weight_decay=hyper.weight_decay, grad_clip=hyper.grad_clip,
                             state_8bit=hyper.adam_8bit, mesh=mesh)
        keep = _Keep(tx)
        state = TrainState.create(model, tx)
        zero_bytes = _local_bytes(state.opt_state)
        step = make_train_step(cfg, keep, hyper, remat=hyper.remat, mesh=mesh)
        state, metrics = step(state, stores[store], batch, None)
        res = {"metrics": {k: float(v) for k, v in metrics.items()}, "digest": _digest(model),
               "zero_bytes": zero_bytes, "state": _arrays(tx.state_arrays(model,
                                                                          state.opt_state))}
        if rank == 0:
            res["grads"] = {n: g.numpy() for n, g in keep.grads.items()}
            res["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        out[name] = res
    return out


def _optimizers(mesh, rank, args) -> dict:
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer

    out = {}
    for name, kw in OPT_CASES.items():
        for bits in (False, True):
            res = {}
            for over in (mesh, None):  # ZeRO, then the same on one device
                model = _Tree(opt_tree())
                tx = build_optimizer(1e-2, 1, 10, state_8bit=bits, mesh=over, **kw)
                state = tx.init(model)
                params = []
                for grads in args["opt_grads"]:
                    tx.update(model, {n: torch.from_numpy(g) for n, g in grads.items()}, state)
                    params.append({n: p.detach().numpy().copy()
                                   for n, p in model.named_parameters()})
                res["zero" if over else "single"] = {
                    "params": params, "digest": _digest(model),
                    "state": _arrays(tx.state_arrays(model, state)),
                    "bytes": _local_bytes(state)}
            # each step from the JAX package's state and parameters before it
            tx = build_optimizer(1e-2, 1, 10, state_8bit=bits, mesh=mesh, **kw)
            res["from_jax"] = []
            for grads, start in zip(args["opt_grads"], args["opt_jax"][(name, bits)]):
                model = _Tree(opt_tree())
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(start[".params/" + n.replace(".", "/")])
                state = tx.load_state_arrays(model, start)
                tx.update(model, {n: torch.from_numpy(g) for n, g in grads.items()}, state)
                res["from_jax"].append({
                    "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                    "state": _arrays(tx.state_arrays(model, state))})
            out[(name, bits)] = res
    # a single-device 8-bit state (41 rows) does not load into the 2-rank one (42)
    model = _Tree(opt_tree())
    single = build_optimizer(1e-2, 1, 10, state_8bit=True)
    flat = single.state_arrays(model, single.init(model))
    try:
        build_optimizer(1e-2, 1, 10, state_8bit=True, mesh=mesh).load_state_arrays(model, flat)
        out["nb_mismatch"] = None
    except ValueError as e:
        out["nb_mismatch"] = str(e)
    return out


def _retriever(mesh, rank, args) -> dict:
    from retrieval_augmented_mds_tpu_torch.bridge import load_jax_params
    from retrieval_augmented_mds_tpu_torch.models.config import EncoderConfig
    from retrieval_augmented_mds_tpu_torch.retriever import contrastive as tcon
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu_torch.train.trainer import (
        TrainState,
        make_retriever_train_step,
    )

    rcfg = tcon.RetrieverConfig(query_enc=EncoderConfig(**RET_ENC),
                                mips_enc=EncoderConfig(**RET_ENC), token_loss=True)

    def fresh():
        return load_jax_params(tcon.init_retriever(rcfg, torch.Generator().manual_seed(0)),
                               args["ret_params"])

    rows = mesh.data_rows(len(args["pairs"]["query_input_ids"]))
    batch = {k: torch.from_numpy(v[rows]) for k, v in args["pairs"].items()}
    model = fresh()
    loss, metrics = tcon.contrastive_loss(model, rcfg, batch, gather_axis="data", mesh=mesh)
    loss.backward()
    out = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                     if p.grad is not None}}
    model = fresh()
    tx = build_optimizer(1e-3, 1, 10)
    keep = _Keep(tx)
    step = make_retriever_train_step(rcfg, keep, gather_axis="data", mesh=mesh)
    _, m = step(TrainState.create(model, tx), batch)
    out["step_metrics"] = {k: float(v) for k, v in m.items()}
    out["step_grads"] = {n: g.numpy() for n, g in keep.grads.items()} if rank == 0 else None
    return out


def rank_fit(init, root, args):
    """One rank of the module's launch → its results."""
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.parallel import MeshSpec, init_distributed, make_mesh
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init)
    rank = torch.distributed.get_rank()
    mesh = make_mesh(MeshSpec(*MESH), "cpu")
    out = {"steps": _train_steps(mesh, rank, args), "opt": _optimizers(mesh, rank, args),
           "retriever": _retriever(mesh, rank, args)}
    rep = {}
    cfg = config_from_dict(smoke_config(root, "mesh_fit", True))
    out["fit"] = cli.run_fit(cfg, device="cpu", report=rep)
    out["fit_report"] = {"losses": rep["losses"], "refreshes": len(rep["refresh_s"]),
                         "collectives": rep["collectives"],
                         "placement": (rep["mesh"].d, rep["mesh"].s, rep["mesh"].backend,
                                       rep["store"].index.shards),
                         "digest": _digest(rep["state"].params)}
    from retrieval_augmented_mds_tpu_torch.dryrun import dryrun

    out["dryrun"] = dryrun("cpu", params=args["dry_params"], index_arrays=args["dry_arrays"],
                           index_static=args["dry_static"])
    path = os.path.join(root, "main_fit.yaml")
    if rank == 0:
        with open(path, "w") as f:
            yaml.safe_dump(smoke_config(root, "main_fit", True, max_steps=1, eval_every=0,
                                        ckpt_dir=None), f)
    torch.distributed.barrier()
    out["main"] = cli.main(["fit", "--config", path, "--device", "cpu"])
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "retrieval_augmented_mds_tpu.")) or m == "retrieval_augmented_mds_tpu")
    return out


# ---------------------------------------------------------------------------
# the parent: JAX references and the launch
# ---------------------------------------------------------------------------

def _jax_mesh():
    from retrieval_augmented_mds_tpu.parallel import MeshSpec

    return MeshSpec(*MESH).build()


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's inputs and its (2, 2) mesh steps with an
    optimizer that keeps the gradients (`test_torch_train`), on the Flat and
    the IVF store."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from retrieval_augmented_mds_tpu.index import flat as jflat
    from retrieval_augmented_mds_tpu.index import ivf as jivf
    from retrieval_augmented_mds_tpu.models import led as jled
    from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
    from retrieval_augmented_mds_tpu.parallel import zero_sharding_for_tree
    from retrieval_augmented_mds_tpu.train import trainer as jtrainer
    from tests.test_torch_train import _keep_gradients_tx

    jm = _jax_mesh()
    jcfg = jrag.RAGConfig.tiny(sequence_shard=True)
    jp = jrag.init_rag(jax.random.PRNGKey(0), jcfg)
    host = host_inputs()
    ivf = jivf.build_ivf_index(host["emb"], 8, dtype="int8", seed=19)
    ivf_arrays, ivf_static = _ivf_parts(ivf)
    tok = dict(token_ids=jnp.asarray(host["ids"]), token_mask=jnp.asarray(host["mask"]),
               row_aids=jnp.asarray(host["aids"]))
    stores = {
        "flat": jrag.MemoryStore(index=jflat.build_flat_index(
            host["emb"], dtype=jnp.float32, mesh=jm, row_align=64), nprobe=NPROBE, **tok),
        "ivf": jrag.MemoryStore(index=jivf.shard_ivf_index(ivf, jm), nprobe=NPROBE, **tok),
    }
    data = NamedSharding(jm, P("data"))
    batch = {k: jax.device_put(jnp.asarray(v), data) for k, v in host["batch"].items()}
    batch["decoder_input_ids"] = jax.device_put(
        jled.shift_tokens_right(jnp.asarray(host["batch"]["labels"]), 1, 2), data)
    keep = _keep_gradients_tx()
    hyper = jtrainer.TrainHyper(**HYPER)
    step = jtrainer.make_train_step(jcfg, keep, hyper, mesh=jm)
    out = {}
    for name, store in stores.items():
        params = jax.device_put(jax.tree_util.tree_map(jnp.array, jp), NamedSharding(jm, P()))
        state = jtrainer.TrainState.create(params, keep)
        state = dataclasses.replace(state, opt_state=jax.device_put(
            state.opt_state, zero_sharding_for_tree(state.opt_state, jm)))
        with jm:
            new, metrics = step(state, store, batch, None)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: np.asarray(v) for k, v in _flat(new.opt_state).items()})
    return {"params": jp, "ivf_arrays": ivf_arrays, "ivf_static": ivf_static, "steps": out,
            "jcfg": jcfg, "dryrun": _jax_dryrun(jm)}


def _ivf_parts(ivf):
    fields = [f.name for f in dataclasses.fields(ivf)
              if f.name not in ("n", "metric", "normalized", "flat", "n_spill", "shards")]
    return ({f: None if getattr(ivf, f) is None else np.asarray(getattr(ivf, f))
             for f in fields},
            {"n": ivf.n, "metric": ivf.metric, "normalized": ivf.normalized,
             "n_spill": ivf.n_spill})


def _jax_dryrun(jm) -> dict:
    """``__graft_entry__.dryrun_multichip``'s step on the (2, 2) mesh: its
    tiny setup (the IVF8,SQ8 index built once and split over ``shard``),
    batch 2 x data, ZeRO-sharded AdamW → its loss, params and index."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as g
    from retrieval_augmented_mds_tpu.index import ivf as jivf
    from retrieval_augmented_mds_tpu.parallel import zero_sharding_for_tree
    from retrieval_augmented_mds_tpu.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu.train import trainer as jtrainer

    cfg, params, store, batch = g._tiny_setup(batch=2 * MESH[0], factory="IVF8,SQ8",
                                              sequence_shard=True)
    arrays, static = _ivf_parts(store.index)
    store = dataclasses.replace(store, index=jivf.shard_ivf_index(store.index, jm))
    hyper = jtrainer.TrainHyper(lr=1e-4, warmup_steps=10, total_steps=100)
    tx = build_optimizer(hyper.lr, hyper.warmup_steps, hyper.total_steps,
                         grad_clip=hyper.grad_clip)
    tree = _numpy_tree(params)
    params = jax.device_put(params, NamedSharding(jm, P()))
    batch = {k: jax.device_put(v, NamedSharding(jm, P("data"))) for k, v in batch.items()}
    state = jtrainer.TrainState.create(params, tx)
    state = dataclasses.replace(state, opt_state=jax.device_put(
        state.opt_state, zero_sharding_for_tree(state.opt_state, jm)))
    with jm:
        _, metrics = jtrainer.make_train_step(cfg, tx, hyper, mesh=jm)(state, store, batch,
                                                                       None)
    return {"loss": float(metrics["loss"]), "params": tree, "arrays": arrays,
            "static": static}


def _flat(tree) -> dict:
    from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree

    return flatten_tree(tree)


@pytest.fixture(scope="module")
def opt_grads():
    """Four steps of gradients for `opt_tree`: small (a 0.5 clip does not
    trigger) and large (it does) in turn."""
    rng = np.random.default_rng(4)
    tree = _flat(opt_tree())
    return [{n: (rng.standard_normal(x.shape) * (3.0 if s % 2 else 1e-3)).astype(np.float32)
             for n, x in tree.items()} for s in range(4)]


@pytest.fixture(scope="module")
def retriever_side():
    """The tiny retriever's JAX parameters and 8 pairs (`test_torch_retriever`)."""
    import jax

    from retrieval_augmented_mds_tpu.models.config import EncoderConfig as JEnc
    from retrieval_augmented_mds_tpu.retriever import contrastive as jcon
    from tests.test_torch_retriever import _pairs

    jrcfg = jcon.RetrieverConfig(query_enc=JEnc(**RET_ENC), mips_enc=JEnc(**RET_ENC),
                                 token_loss=True)
    return {"cfg": jrcfg, "params": jcon.init_retriever(jax.random.PRNGKey(0), jrcfg),
            "pairs": _pairs(0, 8)}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory, jax_side, opt_grads, opt_jax, retriever_side):
    root = str(tmp_path_factory.mktemp("mesh_fit"))
    work = os.path.join(root, "ranks")
    args = {"params": _numpy_tree(jax_side["params"]), "ivf_arrays": jax_side["ivf_arrays"],
            "ivf_static": jax_side["ivf_static"], "opt_grads": opt_grads,
            "opt_jax": opt_jax, "ret_params": _numpy_tree(retriever_side["params"]),
            "pairs": retriever_side["pairs"], "dry_params": jax_side["dryrun"]["params"],
            "dry_arrays": jax_side["dryrun"]["arrays"],
            "dry_static": jax_side["dryrun"]["static"]}
    results = launch(f"{__name__}:rank_fit", 4, workdir=work, args=(store_url(work), root, args),
                     timeout=LAUNCH_TIMEOUT)
    return root, results


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

STEP_CASES = ("flat", "flat_8bit", "ivf")


def _check_grads(got: dict, ref: dict, what: str, rel: float):
    """Every leaf: ||g_port - g_jax|| <= rel ||g_jax|| + 1e-7, and the port
    reaches every leaf JAX gives a non-zero gradient."""
    for n, r in ref.items():
        g = got.get(n, np.zeros_like(r))
        gap = float(np.linalg.norm(g.astype(np.float64) - r))
        allowed = rel * float(np.linalg.norm(r)) + 1e-7
        assert gap <= allowed, f"{what}: {n} gradient {gap:.3g} apart, {allowed:.3g} allowed"


@pytest.mark.parametrize("case", STEP_CASES)
def test_mesh_step_equals_jax_mesh_step(mesh_run, jax_side, case):
    """One step over (2, 2) against the JAX package's mesh step on the
    same inputs: every metric of the JAX step (the loss and the global
    batch's copy, retrieval and gradient-norm metrics) within rtol 1e-4 +
    atol 1e-5, as the single-device steps are held (`steps_from_jax`);
    every gradient leaf within 1e-4 of its norm (a leaf summed from four
    ranks' shares in another order; a dropped ``shard`` or ``data``
    reduction would miss by half or double); the same parameters on every
    rank, bit for bit."""
    _, results = mesh_run
    jm, jgrads = jax_side["steps"]["ivf" if case == "ivf" else "flat"]
    res = results[0]["steps"][case]
    assert set(res["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    _check_grads(res["grads"], jgrads, case, 1e-4)
    assert len({r["steps"][case]["digest"] for r in results}) == 1
    for r in results[1:]:
        assert r["steps"][case]["metrics"] == res["metrics"]


def test_remat_over_the_mesh_equals_no_remat(mesh_run):
    """``remat: true`` over the mesh (each layer's forward, its collectives
    with it, run again in the backward): the metrics and every gradient of
    the step without remat, within rtol = atol = 1e-6."""
    _, results = mesh_run
    a, b = results[0]["steps"]["flat"], results[0]["steps"]["flat_remat"]
    for k, v in a["metrics"].items():
        np.testing.assert_allclose(b["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    for n, g in a["grads"].items():
        np.testing.assert_allclose(b["grads"][n], g, rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("case", ["flat", "flat_8bit"])
def test_zero_update_equals_jax_optimizer(mesh_run, jax_side, case):
    """The step's update and state against the JAX package's optimizer
    (jitted; the 8-bit one built with the mesh, so its superleaf is padded
    to the ``data`` size) applied to the port's own reduced gradients from
    the same start: the parameters within rtol = atol = 1e-6 (the
    single-device steps' bound); the gathered state under optax's key
    paths, its shapes equal (the 8-bit rows padded as JAX's), the bf16 mu
    within one bf16 step plus the roundoff of its terms and nu within
    rtol 1e-5 + atol 1e-7 (`check_bf16_mu_state`), the 8-bit codes within
    1 and scales within rtol 1e-5 + atol 1e-7 (`test_torch_adam8bit`); each
    rank's ZeRO state at most 0.6 of the single-device state's bytes."""
    import jax
    import jax.numpy as jnp
    import optax

    from retrieval_augmented_mds_tpu.train import optimizer as joptim
    from retrieval_augmented_mds_tpu.train import trainer as jtrainer
    from tests.test_torch_train import _jax_tree, _state_arrays, check_bf16_mu_state

    _, results = mesh_run
    res = results[0]["steps"][case]
    bits = case.endswith("8bit")
    jp = jax_side["params"]
    jtx = joptim.build_optimizer(HYPER["lr"], HYPER["warmup_steps"], HYPER["total_steps"],
                                 weight_decay=HYPER["weight_decay"],
                                 grad_clip=HYPER["grad_clip"], state_8bit=bits,
                                 state_8bit_fused=False, mesh=_jax_mesh(), params=jp)
    start = jtx.init(jp)
    upd, ref_opt = jax.jit(jtx.update)(_jax_tree(jp, res["grads"]), start, jp)
    ref_params = _flat(optax.apply_updates(jp, upd))
    for n, p in res["params"].items():
        np.testing.assert_allclose(p, ref_params[n], rtol=1e-6, atol=1e-6, err_msg=n)
    ref = _state_arrays(jtrainer.TrainState(params=jp, opt_state=ref_opt, step=jnp.int32(0)))
    ref = {k: v for k, v in ref.items() if k.startswith(".opt_state")}
    got = res["state"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert _same_size(got[k], r) and got[k].dtype == r.dtype, (k, got[k].shape, r.shape)
    if bits:
        for k, r in ref.items():
            g, r = got[k].numpy(), r.numpy()
            if r.dtype in (np.int8, np.uint8):
                assert np.abs(g.astype(np.int32) - r.astype(np.int32)).max() <= 1, k
            else:
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7, err_msg=k)
    else:
        prev = _state_arrays(jtrainer.TrainState(params=jp, opt_state=start,
                                                 step=jnp.int32(0)))
        clip = HYPER["grad_clip"] / max(res["metrics"]["grad_norm"], HYPER["grad_clip"])
        check_bf16_mu_state(got, ref, prev,
                            {n: torch.from_numpy(g) * clip for n, g in res["grads"].items()})
    whole = sum(r.numel() * r.element_size() for r in ref.values())
    for r in results:
        assert r["steps"][case]["zero_bytes"] <= 0.6 * whole, (r["steps"][case]["zero_bytes"],
                                                               whole)


def _same_size(a, b) -> bool:
    """Equal shapes, or both one element (optax keeps a scalar leaf's
    moments as [1] where the port keeps the leaf's 0-d shape)."""
    return tuple(a.shape) == tuple(b.shape) or a.numel() == b.numel() == 1


@pytest.fixture(scope="module")
def opt_jax(opt_grads):
    """The JAX package's jitted optimizers (the 8-bit one built with the
    (2, 2) mesh) on `opt_tree` over the four steps: for each case, the
    parameters and state before each step, and after the last, under the
    checkpoint key paths."""
    import jax
    import jax.numpy as jnp
    import optax

    from retrieval_augmented_mds_tpu.train import optimizer as joptim
    from retrieval_augmented_mds_tpu.train import trainer as jtrainer
    from tests.test_torch_train import _jax_tree, _state_arrays

    out = {}
    for name, kw in OPT_CASES.items():
        for bits in (False, True):
            jp = jax.tree_util.tree_map(jnp.asarray, opt_tree())
            jtx = joptim.build_optimizer(1e-2, 1, 10, state_8bit=bits, state_8bit_fused=False,
                                         mesh=_jax_mesh(), params=jp, **kw)
            jstate, jupdate, traj = jtx.init(jp), jax.jit(jtx.update), []
            for grads in opt_grads + [None]:
                traj.append(_state_arrays(jtrainer.TrainState(params=jp, opt_state=jstate,
                                                              step=jnp.int32(0))))
                if grads is not None:
                    upd, jstate = jupdate(_jax_tree(jp, grads), jstate, jp)
                    jp = optax.apply_updates(jp, upd)
            out[(name, bits)] = traj
    return out


def _same_size(a, b) -> bool:
    """Equal shapes, or both one element (optax keeps a scalar leaf's
    moments as [1] where the port keeps the leaf's 0-d shape)."""
    return tuple(a.shape) == tuple(b.shape) or a.numel() == b.numel() == 1


@pytest.mark.parametrize("case", list(OPT_CASES))
@pytest.mark.parametrize("bits", [False, True], ids=["adamw", "8bit"])
def test_zero_optimizers_equal_one_device_and_jax(mesh_run, opt_grads, opt_jax, case, bits):
    """AdamW (bf16 mu) and the 8-bit AdamW, ZeRO-sharded over D = 2, four
    steps of given gradients on a small tree (clip and decay; no clip; a
    frozen group with accumulation over 2 steps):

    * against the port's optimizer on one device on the same gradients:
      the parameters after every step bit for bit, on every rank, and the
      gathered state equal to its state (the 8-bit arrays' 41 rows, and a
      42nd that pads them, of no valid element): the update is elementwise
      and the clip's norm is one device's; each rank's state at most 0.6
      of the one device's bytes;
    * against the JAX package's jitted optimizer (the 8-bit one built with
      the (2, 2) mesh: 41 rows padded to 42), each step begun from JAX's
      parameters and state (`load_state_arrays` taking this rank's part
      of them): the gathered state's keys, shapes and dtypes (``nvalid``
      equal, padding included); the parameters within rtol = atol = 1e-6;
      the state by the single-device steps' rules: bf16 mu within one bf16
      step plus the roundoff of its terms (`check_bf16_mu_state`, its
      gradient magnitudes bounded by the step's largest), nu and the
      accumulator within rtol 1e-5 + atol 1e-7, the 8-bit codes within 1
      and their scales within rtol 1e-5 + atol 1e-7."""
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import _ARRAYS
    from tests.test_torch_train import check_bf16_mu_state

    _, results = mesh_run
    res = results[0]["opt"][(case, bits)]
    zero, single = res["zero"], res["single"]
    assert len({r["opt"][(case, bits)]["zero"]["digest"] for r in results}) == 1
    for s, (a, b) in enumerate(zip(zero["params"], single["params"])):
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=f"step {s}: {n}")
    for k, v in single["state"].items():
        got = zero["state"][k]
        if bits and k.rsplit(".", 1)[-1] in _ARRAYS:
            torch.testing.assert_close(got[:v.shape[0]], v, rtol=0, atol=0, msg=k)
            assert got.shape[0] == v.shape[0] + 1, k
            if k.endswith("nvalid"):
                assert int(got[v.shape[0]:].sum()) == 0, k
        else:
            torch.testing.assert_close(got, v, rtol=0, atol=0, msg=k)
    assert zero["bytes"] <= 0.6 * single["bytes"], (zero["bytes"], single["bytes"])

    traj = opt_jax[(case, bits)]
    big = {n: np.max([np.abs(g[n]) for g in opt_grads], axis=0) for n in opt_grads[0]}
    for s, step in enumerate(res["from_jax"]):
        prev, after = traj[s], traj[s + 1]
        for n, p in step["params"].items():
            np.testing.assert_allclose(p, after[".params/" + n.replace(".", "/")].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {s}: {n}")
        ref = {k: v for k, v in after.items() if k.startswith(".opt_state")}
        got = step["state"]
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert _same_size(got[k], r) and got[k].dtype == r.dtype, (k, got[k].shape,
                                                                       r.shape)
            got[k] = got[k].reshape(r.shape)
        if not bits:
            check_bf16_mu_state(got, ref, prev, {n: torch.from_numpy(x) for n, x in big.items()})
            continue
        for k, r in ref.items():
            g, r = got[k].numpy(), r.numpy()
            if k.endswith("nvalid"):
                np.testing.assert_array_equal(g, r, err_msg=k)
            elif r.dtype in (np.int8, np.uint8):
                assert np.abs(g.astype(np.int32) - r.astype(np.int32)).max() <= 1, k
            else:
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7, err_msg=f"step {s}: {k}")


def test_an_8bit_state_of_another_row_count_raises(mesh_run):
    """A single-device 8-bit state of the small tree (41 superleaf rows)
    does not load into the optimizer over D = 2 (42 rows): it raises, as
    the JAX package's update does on a row count that is not its own."""
    _, results = mesh_run
    for r in results:
        assert r["opt"]["nb_mismatch"] and "(41, 128)" in r["opt"]["nb_mismatch"], \
            r["opt"]["nb_mismatch"]


def test_zero_spec_equals_jax_sharding(jax_side):
    """`zero_axis` against JAX's `zero_sharding_for_tree` on the RAG
    model's optimizer state trees (AdamW with accumulation and frozen
    groups; the 8-bit one), over data = 2 and 4: the same axis, or both
    replicated, for every leaf."""
    import jax

    from retrieval_augmented_mds_tpu.parallel import MeshSpec, zero_sharding_for_tree
    from retrieval_augmented_mds_tpu.train import optimizer as joptim
    from retrieval_augmented_mds_tpu_torch.parallel.zero import zero_axis

    jp = jax_side["params"]
    for data in (2, 4):
        jm = MeshSpec(data, 1).build()
        for kw in (dict(accumulate_steps=2, frozen_groups=("mips_encoder",), grad_clip=1.0),
                   dict(state_8bit=True, state_8bit_fused=False, mesh=jm)):
            state = joptim.build_optimizer(1e-3, 1, 10, params=jp, **kw).init(jp)
            specs = zero_sharding_for_tree(state, jm)
            n = 0
            for leaf, sh in zip(jax.tree_util.tree_leaves(state),
                                jax.tree_util.tree_leaves(specs)):
                spec = tuple(sh.spec)
                want = spec.index("data") if "data" in spec else None
                assert zero_axis(np.shape(leaf), data) == want, (np.shape(leaf), spec)
                n += want is not None
            assert n > 0


def test_contrastive_gather_axis_equals_jax_shard_map(mesh_run, retriever_side):
    """`contrastive_loss(gather_axis="data")` over D = 2 (4 pairs a data
    rank, the other rank's mips embeddings as negatives) against the JAX
    package's under ``jax.shard_map`` on the same (2, 2) mesh: each rank's
    loss and metrics within rtol 1e-5 of JAX's device of that data rank,
    and the parameters' gradients of the mean loss over ``data`` (the
    ranks' own, summed over the data ranks and halved) held to JAX's
    ``jax.grad`` of that mean, leaf by leaf within 1e-5 of the leaf's norm;
    the retriever train step's reduced gradients too, and its metrics
    equal the means over ``data``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from retrieval_augmented_mds_tpu.retriever import contrastive as jcon

    _, results = mesh_run
    jm = _jax_mesh()
    jrcfg, jp = retriever_side["cfg"], retriever_side["params"]
    batch = {k: jnp.asarray(v) for k, v in retriever_side["pairs"].items()}

    def per_device(params, b):
        loss, m = jcon.contrastive_loss(params, jrcfg, b, gather_axis="data")
        return (jax.lax.pmean(loss, "data"),
                {k: v[None] for k, v in m.items()})

    fn = jax.shard_map(per_device, mesh=jm, in_specs=(P(), P("data")),
                       out_specs=(P(), P("data")))
    (mean, per), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp, batch)
    ref = _flat(grads)
    for r, res in enumerate(results):
        d = r // MESH[1]
        for k, v in res["retriever"]["metrics"].items():
            np.testing.assert_allclose(v, float(per[k][d]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r}: {k}")
    summed = {n: sum(results[d * MESH[1]]["retriever"]["grads"][n] for d in range(MESH[0]))
              / MESH[0] for n in results[0]["retriever"]["grads"]}
    _check_grads(summed, ref, "contrastive gather", 1e-5)
    _check_grads(results[0]["retriever"]["step_grads"], ref, "retriever step", 1e-5)
    np.testing.assert_allclose(results[0]["retriever"]["step_metrics"]["loss"], float(mean),
                               rtol=1e-5)


def _losses(root, name):
    import json

    with open(os.path.join(root, name, f"{name}.metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_run_fit_over_the_mesh_equals_one_device_and_resumes_there(mesh_run):
    """`cli.run_fit` of the smoke config over (2, 2) (sequence-sharded LED,
    the store refreshed over the mesh before steps 1 and 2, an eval over
    the mesh at step 3, the checkpoint gathered and written by rank 0)
    against the port's single-device `run_fit` of the same config: every
    step's loss within rtol 1e-4 (the JAX package's mesh-fit tolerance,
    ``tests/test_cli_mesh.py``), the same on every rank, one metrics file
    (rank 0's). Then one device resumes from the mesh's checkpoint for 2
    more steps: their losses within rtol 1e-4 of an uninterrupted
    single-device run's steps 3 and 4 (the resume builds its store from
    the weights after step 3, as the uninterrupted run's refresh before
    step 3 does)."""
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    root, results = mesh_run
    mesh_losses = results[0]["fit_report"]["losses"]
    assert len(mesh_losses) == 3 and results[0]["fit_report"]["refreshes"] == 2
    for r, res in enumerate(results):
        assert res["fit_report"]["losses"] == mesh_losses
        assert res["fit_report"]["placement"] == (r // 2, r % 2, "gloo", 2)
        assert res["fit_report"]["digest"] == results[0]["fit_report"]["digest"]
    assert [x["step"] for x in _losses(root, "mesh_fit") if "loss" in x] == [0, 1, 2]
    assert any("val_rouge1" in x for x in _losses(root, "mesh_fit"))
    rep = {}
    single = config_from_dict(smoke_config(root, "single", False, max_steps=5, ckpt_dir=None))
    cli.run_fit(single, device="cpu", report=rep)
    np.testing.assert_allclose(mesh_losses, rep["losses"][:3], rtol=1e-4)
    ckpt = os.path.join(root, "resume", "ckpt")
    shutil.copytree(os.path.join(root, "mesh_fit", "ckpt"), ckpt)
    resumed = {}
    cli.run_fit(config_from_dict(smoke_config(root, "resume", False, max_steps=5)),
                device="cpu", report=resumed)
    np.testing.assert_allclose(resumed["losses"], rep["losses"][3:], rtol=1e-4)


def test_fit_main_over_the_mesh_prints_on_rank_zero_and_loads_no_jax(mesh_run):
    """`cli.main fit` over the mesh: exit 0 on every rank, rank 0's JSON
    line only; no rank of the launch (train steps, optimizers, retriever,
    `run_fit`, `main`) loaded JAX or the JAX package."""
    import json

    root, results = mesh_run
    assert [r["main"] for r in results] == [0] * 4
    assert all(r["modules"] == [] for r in results), [r["modules"] for r in results]
    lines = []
    for r in range(4):
        with open(os.path.join(root, "ranks", f"rank{r}.log")) as f:
            lines.append([ln for ln in f.read().splitlines() if ln.startswith("{")])
    assert [len(x) for x in lines] == [1, 0, 0, 0], lines
    assert json.loads(lines[0][0])["steps"] == 1


def test_dryrun_over_the_mesh_equals_jax(mesh_run, jax_side):
    """`dryrun` (the counterpart of ``__graft_entry__.dryrun_multichip``:
    the tiny setup's IVF8,SQ8 store split over ``shard``, the LED
    sequence-sharded, batch 2 x data, ZeRO-sharded AdamW) on the (2, 2)
    mesh, given the JAX package's parameters and index: one step, a finite
    loss on every rank, equal to the JAX package's step on the same mesh
    within rtol 1e-4 (the mesh-fit tolerance)."""
    _, results = mesh_run
    for r in results:
        assert r["dryrun"]["mesh"] == MESH and r["dryrun"]["step"] == 1
        assert np.isfinite(r["dryrun"]["loss"])
        np.testing.assert_allclose(r["dryrun"]["loss"], jax_side["dryrun"]["loss"], rtol=1e-4)
