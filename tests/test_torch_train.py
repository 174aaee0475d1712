"""Parity of the port's training slice with the JAX package, on the CPU:
the losses, the optimizer against optax, the teacher-forced decoder, the
train step, the store refresh, checkpoints in both directions, and the
`fit`/`validate`/`test` commands.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny)
through `bridge.load_jax_params`; inputs are numpy arrays made from a
seed; everything is f32. Tolerances are rtol=atol=1e-5 unless a test says
otherwise.
"""

import dataclasses
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

from retrieval_augmented_mds_tpu.models import led as jled
from retrieval_augmented_mds_tpu.train import loss as jloss
from retrieval_augmented_mds_tpu.train import optimizer as joptim
from retrieval_augmented_mds_tpu.train import trainer as jtrainer
from retrieval_augmented_mds_tpu.utils import checkpoint as jckpt
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree
from retrieval_augmented_mds_tpu_torch.models import generate as tgen
from retrieval_augmented_mds_tpu_torch.models import led as tled
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.train import loss as tloss
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer
from retrieval_augmented_mds_tpu_torch.utils import checkpoint as tckpt
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t
from tests.test_torch_rag import B, N, _batch, _setup, _stores

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T_DEC = 16


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _lprobs(seed=0, shape=(3, 5, 11)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    target = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    target[0, 3:] = 1  # the pad / ignore id
    return lp, target


@pytest.mark.parametrize("variant,kw", [
    ("copy", dict(ignore_index=1)),
    ("copy", dict(ignore_index=None, sum=False)),
    ("fairseq", dict(ignore_index=1)),
    ("custom", dict(ignore_index=1, reduce="sum")),
    ("custom", dict(ignore_index=1, reduce="mean")),
])
def test_label_smoothed_losses_match_jax(variant, kw):
    lp, target = _lprobs()
    name = f"label_smoothed_nll_loss_{variant}"
    ref = getattr(jloss, name)(jnp.asarray(lp), jnp.asarray(target), 0.1, **kw)
    got = getattr(tloss, name)(_t(lp), _t(target), 0.1, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def test_transformers_loss_and_summarization_loss_match_jax():
    lp, target = _lprobs(1)
    ref = jloss.label_smoothed_nll_loss_transformers(
        -jnp.asarray(lp).reshape(-1, 11), jnp.asarray(target).reshape(-1), 0.1, 1)
    got = tloss.label_smoothed_nll_loss_transformers(
        -_t(lp).reshape(-1, 11), _t(target).reshape(-1), 0.1, 1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        _np(tloss.summarization_loss(_t(lp), _t(target), 0.1, 1)),
        np.asarray(jloss.summarization_loss(jnp.asarray(lp), jnp.asarray(target), 0.1, 1)),
        **TOL)


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

class _Group(nn.Module):
    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


def _tree():
    """A two-group parameter tree in both packages' forms."""
    rng = np.random.default_rng(0)
    jp = {"led": {"bias": rng.standard_normal(3).astype(np.float32),
                  "kernel": rng.standard_normal((4, 3)).astype(np.float32)},
          "query_encoder": [{"kernel": rng.standard_normal((3, 2)).astype(np.float32)}]}
    model = nn.Module()
    model.led = _Group(bias=(3,), kernel=(4, 3))
    model.query_encoder = nn.ModuleList([_Group(kernel=(3, 2))])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(_t(flatten_tree(jp)[n]))
    return jax.tree_util.tree_map(jnp.asarray, jp), model


def _as_f32(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("kw", [
    dict(grad_clip=0.5, frozen_groups=("query_encoder",), accumulate_steps=2),
    dict(grad_clip=None, weight_decay=0.01, mu_dtype=None),
    dict(grad_clip=100.0, weight_decay=0.1, accumulate_steps=3, frozen_groups=("led",)),
])
def test_optimizer_matches_optax(kw):
    """6 steps of random gradients (the 0.5 clip triggers on most): the
    parameters after every step and the final state, leaf for leaf under
    optax's key paths (bf16 mu by default). The optax update is jitted, as
    in the reference's train step: XLA then keeps b1 * mu in f32, where an
    eager update would round it to bf16."""
    jp, model = _tree()
    jtx = joptim.build_optimizer(1e-2, warmup_steps=2, total_steps=10, params=jp, **kw)
    jupdate = jax.jit(jtx.update)
    jstate = jtx.init(jp)
    ttx = toptim.build_optimizer(1e-2, warmup_steps=2, total_steps=10, **kw)
    tstate = ttx.init(model)
    rng = np.random.default_rng(1)
    for _ in range(6):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.update(model, {n: _t(g) for n, g in flatten_tree(grads).items()}, tstate)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), flatten_tree(jp)[n], rtol=1e-6, atol=1e-6,
                                       err_msg=n)
    jflat, bf16 = jckpt._flatten(jtrainer.TrainState(params=jp, opt_state=jstate,
                                                     step=jnp.int32(0)))
    ref = {k: (np.asarray(v).view(jnp.bfloat16) if k in bf16 else v)
           for k, v in jflat.items() if k.startswith(".opt_state")}
    got = ttx.state_arrays(model, tstate)
    assert set(got) == set(ref)
    got, ref = _as_f32(got), _as_f32(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_schedule_matches_jax():
    ref = joptim.linear_warmup_schedule(3e-4, 5, 40)
    got = toptim.linear_warmup_schedule(3e-4, 5, 40)
    for s in (0, 1, 4, 5, 6, 39, 40, 45):
        np.testing.assert_allclose(got(s), np.asarray(ref(s)), rtol=1e-7)


# ---------------------------------------------------------------------------
# the teacher-forced decoder
# ---------------------------------------------------------------------------

def test_teacher_forced_led_decode_matches_jax():
    """Hidden states and the gradients of a loss on them (through the
    decoder's dense attention rows) w.r.t. the encoder states."""
    cfg, jcfg, jp, model = _setup(seed=6)
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((B, 96, cfg.led.d_model)).astype(np.float32)
    mask = np.ones((B, 96), np.int32)
    mask[1, 70:] = 0
    ids = rng.integers(3, cfg.led.vocab_size, (B, T_DEC)).astype(np.int32)
    w = rng.standard_normal((B, T_DEC, cfg.led.d_model)).astype(np.float32)

    def jloss_fn(e):
        h, caches = jled.led_decode(jp["led"], jcfg.led, jnp.asarray(ids), e,
                                    jnp.asarray(mask))
        assert caches is None
        return jnp.sum(h * jnp.asarray(w)), h

    (_, jh), jg = jax.value_and_grad(jloss_fn, has_aux=True)(jnp.asarray(enc))
    te = _t(enc).requires_grad_()
    th, caches = tled.led_decode(model.led, cfg.led, _t(ids), te, _t(mask))
    assert caches is None
    (th * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), **TOL)


def test_remat_and_8bit_adam_raise():
    """Both are ported (tests/test_torch_remat.py, test_torch_adam8bit.py);
    what still raises: a remat policy the port does not have, and an 8-bit
    state whose superleaf does not fit the parameters."""
    cfg, _, _, model = _setup()
    with pytest.raises(ValueError, match="remat"):
        tled.led_decode(model.led, cfg.led, torch.zeros((1, 4), dtype=torch.int32),
                        torch.zeros((1, 8, cfg.led.d_model)), torch.ones((1, 8)),
                        remat="nothing_saveable")
    tx = toptim.build_optimizer(1e-3, state_8bit=True)
    state = tx.init(model.led.decoder)
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="superleaf row count"):
        tx.update(model, grads, state)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _train_inputs(cfg, seed, n_batches=3):
    """Flat stores with per-row article ids, and batches with labels and
    gold ids, in both packages' forms."""
    jstore, tstore = _stores(cfg, seed)
    rng = np.random.default_rng(seed)
    aids = rng.integers(0, 20, (N, 3)).astype(np.int32)
    jstore = dataclasses.replace(jstore, row_aids=jnp.asarray(
        np.concatenate([aids, np.full((jstore.token_ids.shape[0] - N, 3), -1, np.int32)])))
    tstore = dataclasses.replace(tstore, row_aids=_t(aids))
    batches = []
    for i in range(n_batches):
        host = _batch(cfg, seed + 10 + i)
        labels = rng.integers(3, cfg.led.vocab_size, (B, T_DEC)).astype(np.int32)
        labels[0, 11:] = cfg.led.pad_id
        host.update(labels=labels, gold_aid=rng.integers(0, 20, B).astype(np.int32),
                    aid_counts=rng.integers(1, 4, B).astype(np.int32))
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        jb["decoder_input_ids"] = jled.shift_tokens_right(jb["labels"], cfg.led.pad_id, 2)
        tb = {k: _t(v) for k, v in host.items()}
        tb["decoder_input_ids"] = tled.shift_tokens_right(tb["labels"], cfg.led.pad_id, 2)
        batches.append((jb, tb))
    return jstore, tstore, batches


def test_train_steps_match_jax():
    """3 make_train_step steps (AdamW with warmup, decay, clip, bf16 mu):
    losses within rtol 1e-4, every metric key equal, every other metric
    within rtol 1e-4 + atol 1e-5 (`mips_score_mean` is a mean of cosines
    near 0), and the parameters after the 3 steps within atol 1e-5.

    One parameter is held to Adam's own bound instead: the copy head's
    `beta_bias` shifts every logit of a softmax alike, so its gradient is
    zero in exact arithmetic and roundoff in either package (XLA's fusion
    happens to give exactly 0, PyTorch ~1e-9). Adam divides such a
    gradient by its own size (eps = 1e-8), so each package moves it by up
    to lr per update, in no shared direction."""
    cfg, jcfg, jp, model = _setup(seed=5)
    hyper = dict(lr=5e-4, warmup_steps=1, total_steps=100, weight_decay=0.01,
                 grad_clip=1.0, grad_group_norms=True)
    opt = dict(weight_decay=0.01, grad_clip=1.0)
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
        assert {"loss", "copy_gate_mean", "copy_probs_mass", "mips_score_mean",
                "retriever_recall", "grad_norm", "grad_norm_led"} <= set(tm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert tstate.step == 3 and int(jstate.step) == 3
    ref = flatten_tree(jstate.params)
    # schedule(0) = 0: two of the three updates move the parameters
    adam_bound = 2 * hyper["lr"]
    for n, p in model.named_parameters():
        atol = adam_bound if n.endswith("beta_bias") else 1e-5
        np.testing.assert_allclose(_np(p), ref[n], rtol=0, atol=atol, err_msg=n)


def test_refresh_store_matches_jax_and_a_fresh_build():
    """After a refresh under new weights: the same corpus embeddings as the
    JAX refresh (whose index keeps padding rows and columns) and as a fresh
    build, the same token arrays, and equal search results."""
    cfg, jcfg, jp, model = _setup(seed=7)
    jstore, tstore = _stores(cfg, 7)
    jnew = jtrainer.refresh_store(jp, jcfg, jstore, batch_size=16)
    tnew = ttrainer.refresh_store(model, cfg, tstore, batch_size=16)
    assert tnew.token_ids is tstore.token_ids and tnew.index.n == N
    d = cfg.mips_enc.d_model
    np.testing.assert_allclose(_np(tnew.index.embeddings),
                               np.asarray(jnew.index.embeddings)[:N, :d], **TOL)
    fresh = ttrainer.build_memory_store(
        model, cfg, ttrainer._index_cfg_from_store(tstore),
        token_ids=tstore.token_ids, token_mask=tstore.token_mask, batch_size=16)
    assert torch.equal(fresh.index.embeddings, tnew.index.embeddings)
    q = np.random.default_rng(0).standard_normal((3, cfg.mips_enc.d_model)).astype(np.float32)
    from retrieval_augmented_mds_tpu.index import flat as jflat
    from retrieval_augmented_mds_tpu_torch.index import flat as tflat

    np.testing.assert_array_equal(tflat.search(tnew.index, _t(q), k=4)[1].numpy(),
                                  np.asarray(jflat.search(jnew.index, jnp.asarray(q), k=4)[1]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(grad_clip=1.0),
                                dict(grad_clip=None, accumulate_steps=2,
                                     frozen_groups=("query_encoder",))])
def test_checkpoints_load_across_packages(tmp_path, kw):
    """A train state the JAX package saved loads into the port (parameters,
    optimizer state, step), and one the port saved loads into JAX."""
    cfg, jcfg, jp, _ = _setup(seed=8)
    jtx = joptim.build_optimizer(1e-3, 1, 10, params=jp, **kw)
    rng = np.random.default_rng(8)
    jstate = jtrainer.TrainState.create(jp, jtx)
    for _ in range(2):  # fill the optimizer state
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), jp)
        upd, opt_state = jtx.update(g, jstate.opt_state, jstate.params)
        jstate = jtrainer.TrainState(params=optax.apply_updates(jstate.params, upd),
                                     opt_state=opt_state, step=jstate.step + 1)
    jckpt.save_train_state(str(tmp_path / "jax"), jstate, 2)

    other = trag.init_rag(cfg, torch.Generator().manual_seed(99))
    ttx = toptim.build_optimizer(1e-3, 1, 10, **kw)
    state = ttrainer.TrainState.create(other, ttx)
    state, step = tckpt.load_train_state(str(tmp_path / "jax"), state, ttx)
    assert step == 2 and state.step == 2
    jflat, bf16 = jckpt._flatten(jstate)
    ref = _as_f32({k: (np.asarray(v).view(jnp.bfloat16) if k in bf16 else v)
                   for k, v in jflat.items()})
    got = _as_f32(tckpt.state_arrays(state, ttx))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    tckpt.save_train_state(str(tmp_path / "torch"), state, ttx, 2)
    like = jtrainer.TrainState.create(jrag_init(jcfg, 3), jtx)
    back, step = jckpt.load_train_state(str(tmp_path / "torch"), like)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def jrag_init(jcfg, seed):
    from retrieval_augmented_mds_tpu.models import retriever_generator as jrag

    return jrag.init_rag(jax.random.PRNGKey(seed), jcfg)


# ---------------------------------------------------------------------------
# serving builds no autograd graph; the fit / validate / test commands
# ---------------------------------------------------------------------------

def _tiny_cfg(tmp_path, **over) -> str:
    d = {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": T_DEC,
                 "memory_len": 64, "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 1},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
        "max_steps": 2, "eval_every": 2, "eval_max_batches": 1,
        "ckpt_dir": str(tmp_path / "ckpt"),
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "t"},
    }
    d.update(over)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def test_serving_builds_no_autograd_graph(tmp_path, monkeypatch):
    """`predict` and the eval loop: every tensor `rag_encode` and
    `generate` return has requires_grad False."""
    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.append(out)
            return out
        return wrapped

    monkeypatch.setattr(trag, "rag_encode", spy(trag.rag_encode))
    monkeypatch.setattr(tgen, "generate", spy(tgen.generate))
    cfg = tconfig.load_config(_tiny_cfg(tmp_path))
    report = {}
    cli.run_predict(cfg, device="cpu", report=report)
    dm, tok = cli.build_data(cfg)
    cli.run_eval_loop(cfg, report["params"], report["store"], dm, tok, max_batches=1,
                      device=torch.device("cpu"))
    assert len(seen) == 4
    tensors = [seen[1], seen[3]] + [
        v for enc in (seen[0], seen[2]) for v in vars(enc).values()
        if isinstance(v, torch.Tensor)]
    assert len(tensors) > 10
    assert not any(t.requires_grad for t in tensors)


def test_cli_fit_resume_validate_test_on_cpu(tmp_path, capsys):
    """`fit` (2 steps, a store refresh, an eval, a best checkpoint), a
    resumed `fit` to step 3, then `validate` and `test` from the
    checkpoint."""
    path = _tiny_cfg(tmp_path)
    assert cli.main(["fit", "--config", path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["loss"]) and "grad_norm" in out
    ckpt = tmp_path / "ckpt"
    assert json.loads((ckpt / "latest.json").read_text())["step"] == 2
    assert (ckpt / "best.json").exists()
    rows = [json.loads(x) for x in (tmp_path / "runs" / "t.metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [0, 1]
    assert any("val_rouge1" in r for r in rows)

    path = _tiny_cfg(tmp_path, max_steps=3, eval_every=0)
    assert cli.main(["fit", "--config", path, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "resumed from step 2" in lines[0]
    assert json.loads(lines[-1])["steps"] == 3
    for cmd in ("validate", "test"):
        assert cli.main([cmd, "--config", path, "--device", "cpu"]) == 0
        assert "rouge1" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
