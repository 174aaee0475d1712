"""Parity of the port's 8-bit AdamW with the JAX package, on the CPU: the
quantizers, the superleaf update against the JAX kernel in interpret mode,
the leaf order, `build_optimizer(state_8bit=True)` trajectories against
optax's, checkpoints in both directions, three RAG train steps, and `fit`
with resume.

Inputs are numpy arrays made from a seed and handed to both packages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch import nn

from retrieval_augmented_mds_tpu.ops.adam8bit_update import (
    adam8bit_superleaf_update as jax_kernel,
)
from retrieval_augmented_mds_tpu.train import adam8bit as j8
from retrieval_augmented_mds_tpu.train import optimizer as joptim
from retrieval_augmented_mds_tpu.train import trainer as jtrainer
from retrieval_augmented_mds_tpu.utils import checkpoint as jckpt
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.bridge import adam8bit_state_from_jax, flatten_tree
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import adam8bit_superleaf_update
from retrieval_augmented_mds_tpu_torch.train import adam8bit as t8
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer
from retrieval_augmented_mds_tpu_torch.utils import checkpoint as tckpt
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t
from tests.test_torch_rag import _setup
from tests.test_torch_train import _train_inputs, jrag_init

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B1, B2, EPS = 0.9, 0.999, 1e-8


def _blocks(rng, nb, scale, nvalid):
    """[nb, 128] f32 values with the padding lanes zero, and the mask."""
    x = (rng.standard_normal((nb, t8.BLOCK)) * scale).astype(np.float32)
    mask = np.arange(t8.BLOCK)[None, :] < nvalid
    return np.where(mask, x, 0).astype(np.float32), mask


def _nvalid(nb):
    nv = np.full((nb, 1), t8.BLOCK, np.int32)
    nv[3], nv[5], nv[-1] = 70, 0, 1  # a tail, a padding block, a 1-element tail
    return nv


# ---------------------------------------------------------------------------
# quantizers and the superleaf update
# ---------------------------------------------------------------------------

def test_mu_quantizer_matches_jax():
    """The same int8 codes and scales, and the same dequantised values."""
    rng = np.random.default_rng(0)
    nv = _nvalid(9)
    mu, mask = _blocks(rng, 9, 0.01, nv)
    mu[4] = 0.0  # an all-zero block: scale 0
    jq, js = j8.quantize_mu(jnp.asarray(mu), jnp.asarray(mask))
    tq, ts = t8.quantize_mu(_t(mu), _t(mask))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t8.dequantize_mu(tq, ts).numpy(),
                                  np.asarray(j8.dequantize_mu(jq, js)))


def test_nu_quantizer_matches_jax():
    """uint8 codes and the block's log2 range over 8 decades inside a block,
    with exact zeros, tails and padding: the same codes and lo/hi within
    3e-7 relative (the two packages' log2 may differ in the last bit); the
    JAX codes and range dequantised by both within 4e-6 relative (XLA's
    CPU exp2 rounds x·ln 2 first, which costs ~2e-6 at x ~ -30)."""
    rng = np.random.default_rng(1)
    nv = _nvalid(9)
    mask = np.arange(t8.BLOCK)[None, :] < nv
    nu = np.where(mask, 10.0 ** rng.uniform(-10, -2, (9, t8.BLOCK)), 0).astype(np.float32)
    nu[2, :5] = 0.0
    jq, jlo, jhi = j8.quantize_nu(jnp.asarray(nu), jnp.asarray(mask))
    tq, tlo, thi = t8.quantize_nu(_t(nu), _t(mask))
    assert tq.dtype == torch.uint8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=3e-7)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=3e-7)
    back = t8.dequantize_nu(*(_t(np.asarray(x)) for x in (jq, jlo, jhi)))
    np.testing.assert_allclose(back.numpy(), np.asarray(j8.dequantize_nu(jq, jlo, jhi)),
                               rtol=4e-6)


@pytest.mark.parametrize("wd", [0.0, 0.02])
@pytest.mark.parametrize("in_place", [False, True])
def test_superleaf_update_matches_jax_kernel(wd, in_place):
    """The port's update (its plain version, on the CPU) against the JAX
    kernel in interpret mode on a two-leaf superleaf whose leaves both end
    mid-block, from a warm state (one JAX composite update), with and
    without weight decay, with the clip scale below 1; ``in_place`` writes
    the update over the gradients. Tolerances of tests/test_adam8bit.py:
    update rtol 1e-6 atol 1e-9, codes within 1, mu scales rtol 1e-6, nu
    range rtol = atol = 1e-5."""
    rng = np.random.default_rng(5)
    sizes = {"a": 16384 + 70, "b": 300}
    mk = lambda s: {k: jnp.asarray(rng.standard_normal(n).astype(np.float32) * s)  # noqa: E731
                    for k, n in sizes.items()}
    p, g1, g2 = mk(0.1), mk(0.01), mk(0.01)
    lr = 1e-3
    tx = j8.adamw8bit(lr, b1=B1, b2=B2, eps=EPS, weight_decay=wd, fused=False)
    _, s1 = tx.update(g1, tx.init(p), p)
    c = jnp.asarray(2, jnp.int32).astype(jnp.float32)
    scal = jnp.stack([1.0 - B1 ** c, 1.0 - B2 ** c, jnp.float32(lr),
                      jnp.float32(0.75)]).reshape(1, 4)
    leaves_p = jax.tree_util.tree_leaves(p)
    _, nbs, _, nb = j8._layout(leaves_p, 1)
    gb = j8._concat_blocks(jax.tree_util.tree_leaves(g2), nb)
    pb = j8._concat_blocks(leaves_p, nb) if wd else gb
    ref = jax_kernel(gb, s1.mu_q, s1.mu_scale, s1.nu_q, s1.nu_lo, s1.nu_hi, s1.nvalid,
                     pb, scal, b1=B1, b2=B2, eps=EPS, wd=wd, out_dtype=jnp.float32,
                     tiny=j8._TINY, log_tiny=j8._LOG_TINY, log_range=j8._LOG_RANGE,
                     interpret=True)

    st = adam8bit_state_from_jax(s1)
    assert (st.count, st.mu_q.dtype, st.nu_q.dtype) == (1, torch.int8, torch.uint8)
    g_t = _t(np.asarray(gb))
    got = adam8bit_superleaf_update(
        g_t, st.mu_q, st.mu_scale, st.nu_q, st.nu_lo, st.nu_hi, st.nvalid,
        _t(np.asarray(pb)) if wd else None, _t(np.asarray(scal)),
        b1=B1, b2=B2, eps=EPS, wd=wd, out=g_t if in_place else None)
    if in_place:
        assert got[0] is g_t
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]), rtol=1e-6, atol=1e-9)
    for k in (1, 3):
        assert got[k].dtype == (torch.int8 if k == 1 else torch.uint8)
        assert np.abs(got[k].numpy().astype(np.int32)
                      - np.asarray(ref[k]).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6)
    for k in (4, 5):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)


def test_update_refuses_a_wrong_state():
    """A state the kernel would not take raises on the CPU too: codes of
    the wrong type, and weight decay without the parameters."""
    st = t8.init_state([300])
    g = torch.zeros((st.mu_q.shape[0], t8.BLOCK))
    args = [g, st.mu_q, st.mu_scale, st.nu_q, st.nu_lo, st.nu_hi, st.nvalid, None,
            torch.ones((1, 4))]
    adam8bit_superleaf_update(*args, b1=B1, b2=B2, eps=EPS, wd=0.0)
    with pytest.raises(ValueError, match="p2"):
        adam8bit_superleaf_update(*args, b1=B1, b2=B2, eps=EPS, wd=0.01)
    args[1] = st.mu_q.to(torch.uint8)
    with pytest.raises(ValueError, match="mu_q"):
        adam8bit_superleaf_update(*args, b1=B1, b2=B2, eps=EPS, wd=0.0)


# ---------------------------------------------------------------------------
# the superleaf order and the optimizer
# ---------------------------------------------------------------------------

def _deep_tree(rng):
    """12 list items (so "10" would sort before "2" as a string), dict keys
    out of order, and numeric-looking dict keys."""
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": leaf(3), "layers": [{"w": leaf(2, 2), "b": leaf(2)} for _ in range(12)],
            "a": {"k10": leaf(4), "k2": leaf(5)}}


@pytest.mark.parametrize("tree", ["rag_tiny", "deep"])
def test_leaf_order_matches_tree_flatten(tree):
    if tree == "rag_tiny":
        _, _, jp, _ = _setup(memory_model_fixed=False)
    else:
        jp = _deep_tree(np.random.default_rng(0))
    ref = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
           for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    names = list(flatten_tree(jp))
    np.random.default_rng(1).shuffle(names)
    assert t8.jax_leaf_order(names) == ref


class _Tree(nn.Module):
    """A port module holding a nested dict/list tree's leaves by path."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, _Tree(v))
            elif isinstance(v, list):
                setattr(self, k, nn.ModuleList(_Tree(x) for x in v))
            else:
                setattr(self, k, nn.Parameter(_t(v)))


def _opt_tree():
    rng = np.random.default_rng(3)
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"led": {"w": leaf(4, 130), "b": leaf(5)},
            "copy_head": [{"x": leaf(300)} for _ in range(11)],
            "mips_encoder": {"w": leaf(200)}}


@pytest.mark.parametrize("kw", [
    dict(grad_clip=0.5, weight_decay=0.02),
    dict(grad_clip=None),
    dict(grad_clip=0.5, frozen_groups=("mips_encoder",), accumulate_steps=2),
])
def test_build_optimizer_8bit_matches_jax(kw):
    """4 steps of random gradients, alternately small (the 0.5 clip does not
    trigger) and large (it does), against the JAX package's jitted
    8-bit optimizer: the parameters after every step within 1e-6, and the
    final state under optax's key paths, int8/uint8 kept (codes within 1,
    scales rtol 1e-5)."""
    tree = _opt_tree()
    model = _Tree(tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jtx = joptim.build_optimizer(1e-2, 1, 10, state_8bit=True, params=jp, **kw)
    jupdate = jax.jit(jtx.update)
    jstate = jtx.init(jp)
    ttx = toptim.build_optimizer(1e-2, 1, 10, state_8bit=True, **kw)
    assert isinstance(ttx, t8.AdamW8bit)
    tstate = ttx.init(model)
    rng = np.random.default_rng(4)
    for s in range(4):
        scale = 3.0 if s % 2 else 1e-3
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), tree)
        upd, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update(model, {n: _t(g) for n, g in flatten_tree(grads).items()}, tstate)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), np.asarray(flatten_tree(jp)[n]),
                                       rtol=0, atol=1e-6, err_msg=n)
    ref, _ = jckpt._flatten(jtrainer.TrainState(params=jp, opt_state=jstate,
                                                step=jnp.int32(0)))
    ref = {k: v for k, v in ref.items() if k.startswith(".opt_state")}
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in ttx.state_arrays(model, tstate).items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if got[k].dtype in (np.int8, np.uint8):
            assert np.abs(got[k].astype(np.int32) - ref[k].astype(np.int32)).max() <= 1, k
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints, train steps, fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(grad_clip=1.0),
                                dict(grad_clip=None, accumulate_steps=2,
                                     frozen_groups=("query_encoder",))])
def test_8bit_checkpoints_load_across_packages(tmp_path, kw):
    """A train state with 8-bit moments that the JAX package saved loads
    into the port bit for bit (int8/uint8 codes kept as such), and the
    port's save of it loads into JAX."""
    cfg, jcfg, jp, _ = _setup(seed=8)
    jtx = joptim.build_optimizer(1e-3, 1, 10, params=jp, state_8bit=True, **kw)
    rng = np.random.default_rng(8)
    jstate = jtrainer.TrainState.create(jp, jtx)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), jp)
        upd, opt_state = jtx.update(g, jstate.opt_state, jstate.params)
        jstate = jtrainer.TrainState(params=optax.apply_updates(jstate.params, upd),
                                     opt_state=opt_state, step=jstate.step + 1)
    jckpt.save_train_state(str(tmp_path / "jax"), jstate, 2)

    ttx = toptim.build_optimizer(1e-3, 1, 10, state_8bit=True, **kw)
    state = ttrainer.TrainState.create(trag.init_rag(cfg, torch.Generator().manual_seed(99)),
                                       ttx)
    state, step = tckpt.load_train_state(str(tmp_path / "jax"), state, ttx)
    assert step == 2 and state.step == 2 and state.opt_state.mu_q.dtype == torch.int8
    jflat, _ = jckpt._flatten(jstate)
    got = tckpt.state_arrays(state, ttx)
    assert set(got) == set(jflat)
    for k, ref in jflat.items():
        arr = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert arr.dtype == ref.dtype, k
        np.testing.assert_array_equal(arr, ref, err_msg=k)

    tckpt.save_train_state(str(tmp_path / "torch"), state, ttx, 2)
    saved = np.load(tmp_path / "torch" / "step_2.npz")
    assert {saved[k].dtype for k in saved.files if k.endswith(("mu_q", "nu_q"))} == {
        np.dtype(np.int8), np.dtype(np.uint8)}
    like = jtrainer.TrainState.create(jrag_init(jcfg, 3), jtx)
    back, step = jckpt.load_train_state(str(tmp_path / "torch"), like)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_steps_8bit_match_jax():
    """3 make_train_step steps with the 8-bit optimizer (warmup, decay, the
    folded clip): losses within rtol 1e-4 and every other metric within
    rtol 1e-4 + atol 1e-5, as the bf16-mu three-step test holds them."""
    cfg, jcfg, jp, model = _setup(seed=5)
    hyper = dict(lr=5e-4, warmup_steps=1, total_steps=100, weight_decay=0.01,
                 grad_clip=1.0, adam_8bit=True)
    opt = dict(weight_decay=0.01, grad_clip=1.0, state_8bit=True)
    jtx = joptim.build_optimizer(5e-4, 1, 100, **opt)
    jstep = jtrainer.make_train_step(jcfg, jtx, jtrainer.TrainHyper(**hyper))
    jstate = jtrainer.TrainState.create(jp, jtx)
    ttx = toptim.build_optimizer(5e-4, 1, 100, **opt)
    tstep = ttrainer.make_train_step(cfg, ttx, tconfig.TrainHyper(**hyper))
    tstate = ttrainer.TrainState.create(model, ttx)
    jstore, tstore, batches = _train_inputs(cfg, 5)
    for jb, tb in batches:
        jstate, jm = jstep(jstate, jstore, jb, None)
        tstate, tm = tstep(tstate, tstore, tb)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert tstate.opt_state.count == 3 and int(jstate.opt_state[0].count) == 3


def _smoke_8bit(tmp_path, max_steps) -> str:
    """configs/smoke.yaml with ``train.adam_8bit`` (and the no-op
    ``adam_8bit_fused``), checkpoints and logs under ``tmp_path``."""
    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        d = yaml.safe_load(f)
    d["train"].update(adam_8bit=True, adam_8bit_fused=True)
    d.update(max_steps=max_steps, eval_every=0, ckpt_dir=str(tmp_path / "ckpt"),
             logging={"log_dir": str(tmp_path / "runs"), "run_name": "smoke8"})
    path = tmp_path / "smoke8.yaml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def test_cli_fit_8bit_resume_on_cpu(tmp_path, capsys):
    """`fit` on configs/smoke.yaml with ``train.adam_8bit`` (2 steps, a
    checkpoint with int8/uint8 moments), then a resumed `fit` to step 3
    that loads them."""
    path = _smoke_8bit(tmp_path, 2)
    assert cli.main(["fit", "--config", path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["loss"])
    flat = tckpt.load_arrays(str(tmp_path / "ckpt" / "step_2.npz"))
    assert flat[".opt_state/0/.mu_q"].dtype == torch.int8
    assert flat[".opt_state/0/.nu_q"].dtype == torch.uint8
    assert int(flat[".opt_state/0/.count"]) == 2

    path = _smoke_8bit(tmp_path, 3)
    assert cli.main(["fit", "--config", path, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "resumed from step 2" in lines[0]
    assert json.loads(lines[-1])["steps"] == 3
    flat = tckpt.load_arrays(str(tmp_path / "ckpt" / "step_3.npz"))
    assert int(flat[".opt_state/0/.count"]) == 3
    assert float(flat[".opt_state/0/.mu_scale"].max()) > 0
