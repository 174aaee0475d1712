"""Parity of the port's training slice with the JAX package, on the CPU:
the losses, the optimizer against optax, the teacher-forced decoder, the
train step, the store refresh, checkpoints in both directions, and the
`fit`/`validate`/`test` commands.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny)
through `bridge.load_jax_params`; inputs are numpy arrays made from a
seed; everything is f32. Tolerances are rtol=atol=1e-5 unless a test says
otherwise.
"""

import copy
import dataclasses
import json
import os
import re

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

from tests.test_torch_models import _np, _t, port_params
from tests.test_torch_rag import LM, B, N, _batch, _setup, _stores

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
    what still raises: a remat name the port has no policy for, and an 8-bit
    state whose superleaf does not fit the parameters."""
    cfg, _, _, model = _setup()
    with pytest.raises(ValueError, match="remat"):
        tled.led_decode(model.led, cfg.led, torch.zeros((1, 4), dtype=torch.int32),
                        torch.zeros((1, 8, cfg.led.d_model)), torch.ones((1, 8)),
                        remat="save_from_both_policies")
    tx = toptim.build_optimizer(1e-3, state_8bit=True)
    state = tx.init(model.led.decoder)
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="superleaf row count"):
        tx.update(model, grads, state)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _train_inputs(cfg, seed, n_batches=3, with_target=False):
    """Flat stores with per-row article ids, and batches with labels and
    gold ids (with ``with_target``, also target_memory_ids/mask, drawn
    apart so the other arrays stay those of the seed), in both packages'
    forms."""
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
        if with_target:
            host.update(target_memory(cfg, seed + 100 + i))
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        jb["decoder_input_ids"] = jled.shift_tokens_right(jb["labels"], cfg.led.pad_id, 2)
        tb = {k: _t(v) for k, v in host.items()}
        tb["decoder_input_ids"] = tled.shift_tokens_right(tb["labels"], cfg.led.pad_id, 2)
        batches.append((jb, tb))
    return jstore, tstore, batches


def target_memory(cfg, seed) -> dict[str, np.ndarray]:
    """target_memory_ids/mask [B, LM]: the gold target at memory length
    (<s> first, padding after a ragged end), as the data pipeline emits it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.mips_enc.vocab_size, (B, LM)).astype(np.int32)
    ids[:, 0] = cfg.mips_enc.bos_id
    mask = np.ones((B, LM), np.int32)
    mask[1, 37:] = 0
    ids[mask == 0] = cfg.mips_enc.pad_id
    return {"target_memory_ids": ids, "target_memory_mask": mask}


# Leaves whose gradient is zero in exact arithmetic: a bias added to every
# key of an attention row (`k`, and `kg` of the Longformer's global rows)
# adds q . b to all of that row's logits, and the copy head's `beta_bias`
# shifts every logit of its softmax alike. Their gradients are roundoff in
# both packages, and Adam divides a gradient by its own size.
_ZERO_GRADIENT = re.compile(r"\.(k|kg)\.bias$|\.beta_bias$")


def zero_gradient_leaves(model: nn.Module) -> list[str]:
    return [n for n, _ in model.named_parameters() if _ZERO_GRADIENT.search(n)]


def _outputs(model, cfg, store, batch) -> dict[str, torch.Tensor]:
    out, aux, enc = trag.rag_forward(model, cfg, store, batch)
    loss = tloss.summarization_loss(out, batch["labels"], 0.1, cfg.led.pad_id)
    return {"loss": loss, "out": out, "copy_gate": aux["copy_gate"],
            "copy_probs": aux["copy_probs"], "mips_scores": enc.mips_scores}


@torch.no_grad()
def check_zero_gradient_leaves(model, cfg, store, batch) -> list[str]:
    """Prove the set: each leaf of `zero_gradient_leaves`, shifted by a
    standard normal vector, moves the loss and every output of
    `rag_forward` by roundoff only (TOL); a leaf whose gradient is not zero
    moves them by orders of magnitude more. Returns the set."""
    names = zero_gradient_leaves(model)
    assert any(n.endswith(".k.bias") for n in names)
    assert any(n.endswith(".kg.bias") for n in names)
    assert any(n.endswith(".beta_bias") for n in names)
    base = _outputs(model, cfg, store, batch)
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(0)
    for n in names:
        kept = params[n].clone()
        params[n].add_(torch.randn(kept.shape, generator=gen))
        moved = _outputs(model, cfg, store, batch)
        params[n].copy_(kept)
        for k, v in base.items():
            np.testing.assert_allclose(_np(moved[k]), _np(v), err_msg=f"{n}: {k}", **TOL)
    return names


def _keep_gradients_tx() -> optax.GradientTransformation:
    """Moves nothing and keeps the last gradients as its state: the JAX
    train step with it gives the step's gradients."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


class _KeepGradients:
    """A stand-in optimizer for the port's train step: it keeps each step's
    gradients in ``self.grads`` and, given an optimizer, runs it."""

    def __init__(self, tx=None):
        self.tx, self.grads = tx, []

    def update(self, params, grads, state):
        self.grads.append({n: g.detach().clone() for n, g in grads.items()})
        if self.tx is not None:
            self.tx.update(params, grads, state)


def _jax_tree(like, flat: dict):
    """``flat`` ({"a.b.0.c": array}) in the structure of the JAX tree ``like``."""
    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(np.asarray(flat[name(path)])), like)


def _state_arrays(jstate) -> dict[str, torch.Tensor]:
    """A JAX train state's leaves under the checkpoint key paths, copied
    (the JAX step donates its state), bf16 kept."""
    flat, bf16 = jckpt._flatten(jstate)
    return {k: tckpt._from_numpy(np.array(v), k in bf16) for k, v in flat.items()}


def _check_gradients(step: int, port: dict, jax_: dict, port64: dict, jax64: dict,
                     rel: float = 2.0 ** -22, rel_of: dict[str, float] | None = None):
    """The port's f32 gradients against the JAX package's, leaf by leaf:
    ||g_port - g_jax|| <= 3 (r_port + r_jax) + 2^-22 ||g_jax||, r being a
    package's own roundoff, ||g - g64||, against its own f64 run from the
    same state. In exact arithmetic g64_port = g64_jax, so by the triangle
    inequality the gap is at most r_port + r_jax. The JAX package's f64 run
    keeps its loss in f32 (its metrics come back f32), so r_jax misses the
    roundoff of the loss's cotangent, which reaches every leaf near the
    logits (measured: a gap of 1.9 (r_port + r_jax) at `led.dec_pos.table`;
    3 leaves room for it). The last term, ``rel`` of the leaf's norm, is a
    few roundings of the leaf itself (an f32 gradient that both f64 runs
    give exactly). Each
    leaf is held to its own roundoff, so that a fault in a leaf whose
    gradient is far below the tree's largest (the query encoder's are
    below 1e-6 of it) still shows. ``rel_of`` gives a leaf its own ``rel``."""
    rel_of = rel_of or {}
    for n, g in port.items():
        g = g.double().numpy()
        gap = float(np.linalg.norm(g - jax_[n]))
        r_port = float(np.linalg.norm(g - port64[n].numpy()))
        r_jax = float(np.linalg.norm(np.asarray(jax_[n], np.float64) - jax64[n]))
        allowed = 3 * (r_port + r_jax) + rel_of.get(n, rel) * float(np.linalg.norm(jax_[n]))
        assert gap <= allowed, f"step {step}: {n} gradient {gap:.3g} apart, {allowed:.3g} allowed"


def steps_from_jax(seed: int, hyper: dict, opt: dict, check_state, *,
                   model_kw: dict | None = None, copy_force=(None,) * 3,
                   rel_of: dict[str, float] | None = None) -> tuple:
    """Three train steps of both packages from the JAX package's
    trajectory, each step begun by both from the same point: the JAX
    parameters and optimizer state are loaded into the port first. At each
    step:

    * every metric key equal, the loss within rtol 1e-4, every metric
      within rtol 1e-4 + atol 1e-5 (`mips_score_mean` is a mean of cosines
      near 0);
    * every gradient held to the two packages' own roundoff, leaf by leaf
      (`_check_gradients`; the JAX gradients come from the same jitted
      step, its optimizer swapped for one that keeps them, in f32 and in
      f64, the port's from its step in f64 beside its f32 one);
    * the update: the port's parameters after the step within rtol = atol
      = 1e-6 of the JAX optimizer's (jitted, as in the reference's step)
      applied to the PORT's gradients from the same state, the tolerance of
      the optimizer tests that feed both packages the same gradients, and
      ``check_state(got, ref, start, clipped)`` on the two optimizer states
      (the port's `state_arrays` and the JAX state under the same keys),
      given the state both began from and the port's clipped gradients.

    Comparing the updates on one set of gradients keeps f32 roundoff in
    the gradients out of the update, where Adam would amplify it: an
    element whose gradient is far below eps = 1e-8 moves by lr * mhat / eps,
    linear in a gradient that is roundoff where the terms of its sum
    cancel. Beside this, a copy of the port runs the three steps on its own
    (the reference's free-running comparison): its loss within rtol 1e-4 of
    the JAX package's at every step. Returns (the port's config, the
    free-running port model, the JAX parameters after the three steps,
    the port's store, the first batch, and per step the JAX package's
    gradients on its own trajectory and the free-running port's on its own,
    each scaled by its clip). ``model_kw`` goes to both packages' configs
    (with ``memory_forcing: target_in`` the batches carry the target
    memory); ``copy_force`` is each step's flag, passed to every step;
    ``rel_of`` goes to `_check_gradients`."""
    model_kw = model_kw or {}
    cfg, jcfg, jp, model = _setup(seed=seed, **model_kw)
    free = port_params(cfg, jp)
    jtx = joptim.build_optimizer(hyper["lr"], hyper["warmup_steps"], hyper["total_steps"],
                                 **opt)
    jstep = jtrainer.make_train_step(jcfg, jtx, jtrainer.TrainHyper(**hyper))
    jgrad_step = jtrainer.make_train_step(jcfg, _keep_gradients_tx(),
                                          jtrainer.TrainHyper(**hyper))
    jupdate = jax.jit(jtx.update)
    jstate = jtrainer.TrainState.create(jp, jtx)

    def port_step(tx, dtype=torch.float32):
        kept = _KeepGradients(tx)
        return kept, ttrainer.make_train_step(cfg, kept, tconfig.TrainHyper(**hyper),
                                              dtype=dtype)

    def optimizer():
        return toptim.build_optimizer(hyper["lr"], hyper["warmup_steps"],
                                      hyper["total_steps"], **opt)

    ttx, ftx = optimizer(), optimizer()
    tkept, tstep = port_step(ttx)
    fkept, fstep = port_step(ftx)
    exact, exact_step = port_step(None, torch.float64)
    tstate = ttrainer.TrainState.create(model, ttx)
    fstate = ttrainer.TrainState.create(free, ftx)
    jstore, tstore, batches = _train_inputs(
        cfg, seed, with_target=model_kw.get("memory_forcing") == "target_in")
    required = {"loss", "copy_gate_mean", "copy_probs_mass", "mips_score_mean",
                "retriever_recall", "grad_norm"}
    if hyper.get("grad_group_norms"):
        required.add("grad_norm_led")
    trace = []
    for i, ((jb, tb), force) in enumerate(zip(batches, copy_force)):
        start = jax.tree_util.tree_map(jnp.array, jstate)  # the step donates jstate
        flat = _state_arrays(start)
        tckpt.load_params(model, flat)
        tstate.opt_state = ttx.load_state_arrays(model, flat)
        jgrads = {}
        for dtype in (jnp.float32, jnp.float64):
            with jax.enable_x64(dtype == jnp.float64):
                params = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype), start.params)
                kept = jtrainer.TrainState(params=params,
                                           opt_state=_keep_gradients_tx().init(params),
                                           step=jnp.array(start.step))
                jgrads[dtype] = flatten_tree(jgrad_step(kept, jstore, jb, force)[0].opt_state)
        exact_step(ttrainer.TrainState(copy.deepcopy(model).double(), None, 0), tstore, tb,
                   force)
        jstate, jm = jstep(jstate, jstore, jb, force)
        tstate, tm = tstep(tstate, tstore, tb, force)
        fstate, fm = fstep(fstate, tstore, tb, force)
        assert set(tm) == set(jm)
        assert required <= set(tm)
        for m in (tm, fm):
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4,
                                       err_msg=f"step {i}")
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i}: {k}")
        g = tkept.grads[-1]
        assert set(g) == set(jgrads[jnp.float32]) == set(fkept.grads[-1])
        _check_gradients(i, g, jgrads[jnp.float32], exact.grads[-1], jgrads[jnp.float64],
                         rel_of=rel_of)
        upd, ref_opt = jupdate(_jax_tree(start.params, {n: _np(x) for n, x in g.items()}),
                               start.opt_state, start.params)
        ref_params = optax.apply_updates(start.params, upd)
        ref = flatten_tree(ref_params)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), ref[n], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i}: {n}")
        ref_state = _state_arrays(jtrainer.TrainState(params=ref_params, opt_state=ref_opt,
                                                      step=jnp.int32(0)))
        got = ttx.state_arrays(model, tstate.opt_state)
        ref_state = {k: v for k, v in ref_state.items() if k.startswith(".opt_state")}
        assert set(got) == set(ref_state)
        clip = _clip_scale(hyper, tm)
        check_state(got, ref_state, flat, {n: x * clip for n, x in g.items()})
        jclip, fclip = _clip_scale(hyper, jm), _clip_scale(hyper, fm)
        trace.append(({n: np.abs(x) * jclip for n, x in jgrads[jnp.float32].items()},
                      {n: np.abs(_np(x)) * fclip for n, x in fkept.grads[-1].items()}))
    assert tstate.step == fstate.step == 3 and int(jstate.step) == 3
    return cfg, free, jstate.params, tstore, batches[0][1], trace


def _clip_scale(hyper: dict, metrics: dict) -> float:
    return hyper["grad_clip"] / max(float(metrics["grad_norm"]), hyper["grad_clip"])


def _adam_bound(hyper: dict, steps: int, b1_mu: float) -> float:
    """The most two Adam trajectories can part on a leaf whose gradients
    are arbitrary (roundoff): each update moves an element by lr_t times
    |mhat| / (sqrt(vhat) + eps) plus the decay, and by Cauchy-Schwarz over
    the bias-corrected weights of the gradients in mhat (a_j, decay b1_mu,
    the mu dtype's b1) and in vhat (c_j), |mhat| <= sqrt(sum a_j^2 / c_j)
    sqrt(vhat); a bf16 mu is rounded once a step (relative 2^-9). So the
    two differ by at most 2 lr_t R_t on top of the decayed earlier gap."""
    sched = joptim.linear_warmup_schedule(hyper["lr"], hyper["warmup_steps"],
                                          hyper["total_steps"])
    gap = 0.0
    for count in range(1, steps + 1):
        lr = float(sched(count - 1))
        bc1, bc2 = 1 - 0.9 ** count, 1 - 0.999 ** count
        r2 = sum(((1 - 0.9) * b1_mu ** (count - j) / bc1) ** 2
                 / ((1 - 0.999) * 0.999 ** (count - j) / bc2) for j in range(1, count + 1))
        gap = gap * (1 + lr * hyper["weight_decay"]) \
            + 2 * lr * np.sqrt(r2) * (1 + 2.0 ** -9) ** count
    return gap


BF16_MU_HYPER = dict(lr=5e-4, warmup_steps=1, total_steps=100, weight_decay=0.01,
                     grad_clip=1.0, grad_group_norms=True)
B1_BF16 = float(torch.tensor(0.9, dtype=torch.bfloat16))  # the mu decay, as rounded


def check_bf16_mu_state(got, ref, prev, clipped):
    """`steps_from_jax`'s optimizer-state check for AdamW with a bf16 mu:
    nu within rtol 1e-5 + atol 1e-7, as `test_optimizer_matches_optax`
    holds it; mu within one bf16 step of the result plus the f32 roundoff
    of its terms."""
    for k, r in ref.items():
        if "/.mu/" in k:
            # mu = bf16(b1 mu_prev + 0.1 g): one bf16 step at the result
            # (a half-way point rounded either way), and f32 roundoff of
            # the terms: 2^-23 in the sum, and the clip scales of the
            # two packages, each a norm over n < 2^21 squares summed
            # pairwise (log2(n) 2^-24 apiece): 2^-18 of the terms
            assert got[k].dtype == r.dtype == torch.bfloat16, k
            n = k.split("/.mu/")[1].replace("/", ".")
            terms = B1_BF16 * prev[k].float().abs() + 0.1 * clipped[n].abs()
            bound = r.float().abs() * 2.0 ** -7 + terms * 2.0 ** -18
            assert ((got[k].float() - r.float()).abs() <= bound).all(), k
        else:
            np.testing.assert_allclose(*_as_f32({"g": got[k], "r": r}).values(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_steps_match_jax():
    """Three make_train_step steps (AdamW with warmup, decay, clip, bf16
    mu), held step by step from the JAX trajectory (`steps_from_jax`; nu
    within rtol 1e-5 + atol 1e-7, as `test_optimizer_matches_optax` holds
    it, and the bf16 mu within one bf16 step of the result plus the f32
    roundoff of its terms: where b1 mu_prev and 0.1 g cancel, a roundoff
    of the terms is many bf16 steps of the small result), with a
    free-running copy of the port whose loss follows the JAX package's. On
    that copy, after the three steps:

    * the leaves whose gradient is zero in exact arithmetic
      (`zero_gradient_leaves`, each proven so by
      `check_zero_gradient_leaves`) are held to Adam's bound
      (`_adam_bound`): their gradients are roundoff in both packages, so
      each package moves them by up to lr per update in no shared
      direction;
    * every other leaf is held to the JAX package's parameters at atol
      1e-5, element by element, wherever Adam's step is set by the
      gradient and not by eps: elements whose clipped gradient is at least
      eps = 1e-8 in both packages at every step, or exactly 0 in both (a
      token row no batch holds). Below eps Adam moves an element by
      lr g / eps, so a roundoff of g moves it by as much; those elements
      (most of the query encoder's, whose gradients are ~1e-9) are held on
      shared gradients above.
    """
    cfg, free, jparams, tstore, tb, trace = steps_from_jax(
        5, BF16_MU_HYPER, dict(weight_decay=0.01, grad_clip=1.0), check_bf16_mu_state)
    names = check_zero_gradient_leaves(free, cfg, tstore, tb)
    bound = _adam_bound(BF16_MU_HYPER, 3, B1_BF16)
    ref = flatten_tree(jparams)
    for n, p in free.named_parameters():
        if n in names:
            np.testing.assert_allclose(_np(p), ref[n], rtol=0, atol=bound, err_msg=n)
            continue
        held = np.ones(p.shape, bool)
        for jg, fg in trace:
            held &= ((jg[n] == 0) & (fg[n] == 0)) | ((jg[n] >= 1e-8) & (fg[n] >= 1e-8))
        np.testing.assert_allclose(_np(p)[held], ref[n][held], rtol=0, atol=1e-5, err_msg=n)


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
