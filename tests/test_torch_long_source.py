"""Parity of the port's long-source attention route with the JAX package,
on the CPU: `dense_rows_blocked_plain` / `dense_blocked_backward_plain`
(what a CPU tensor takes in place of kernels K6/K7) against the JAX
package's blocked Pallas kernels in interpret mode and its composite
`_dense_xla`; `DenseRows` routing S > 4096 to them; and train steps of a
tiny model whose sources are 4608 tokens long against the JAX train step.

The same numpy inputs go to both packages. Tolerances: 2e-5 on the
forward and 2e-4 on the gradients (the JAX package's own blocked tests),
1e-4 on the LSE; the train steps as `test_torch_train.py`'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.models import led as jled
from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu.ops.flash_dense import (
    _dense_xla,
    flash_dense_blocked as jax_blocked,
    flash_dense_blocked_backward as jax_blocked_backward,
)
from retrieval_augmented_mds_tpu.train import optimizer as joptim
from retrieval_augmented_mds_tpu.train import trainer as jtrainer
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree
from retrieval_augmented_mds_tpu_torch.models import led as tled
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.ops import flash_dense as tdense
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
    MAX_S,
    dense_blocked_backward_plain,
    dense_rows,
    dense_rows_blocked_plain,
    flash_dense_blocked,
    flash_dense_blocked_backward,
)
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t, port_params
from tests.test_torch_rag import LQ, N, _stores
from tests.test_torch_train import T_DEC

torch.set_num_threads(1)
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
LONG = 4608  # > MAX_S: the blocked route; a multiple of the tiny LED's window


def _inputs(t, s, lengths, seed=0, nh=2, dh=8):
    """q/k/v/g f32 and a key bias with batch i's source `lengths[i]` long
    (0: all padding, every row of that batch fully masked)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, g = (rng.standard_normal((b, nh, t, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(2))
    kb = np.where(np.arange(s)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, k, v, kb.astype(np.float32), g


# the JAX package's blocked shapes (tests/test_flash_dense.py): cross-
# attention with padded sources (nk = 3), and causal self-attention
SHAPES = [(False, 32, 384, [192, 288]), (True, 384, 384, [384, 384])]


@pytest.mark.parametrize("causal,t,s,lengths", SHAPES)
def test_blocked_forward_matches_jax_kernel(causal, t, s, lengths):
    """out and lse against `flash_dense_blocked` in interpret mode."""
    q, k, v, kb, _ = _inputs(t, s, lengths)
    ref, ref_lse = jax_blocked(*map(jnp.asarray, (q, k, v, kb)), causal=causal,
                               interpret=True)
    out, lse = dense_rows_blocked_plain(*map(_t, (q, k, v, kb)), causal)
    assert lse.shape == (len(lengths) * 2, 1, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("causal,t,s,lengths", SHAPES)
def test_blocked_backward_matches_jax_kernels(causal, t, s, lengths, merged):
    """dq, dk, dv from the same out and lse against the merged and the
    dq/dkv-split blocked kernels, on rows that each have an open key."""
    q, k, v, kb, g = _inputs(t, s, lengths, seed=1)
    jq, jk, jv, jkb, jg = map(jnp.asarray, (q, k, v, kb, g))
    out, lse = jax_blocked(jq, jk, jv, jkb, causal=causal, interpret=True)
    ref = jax_blocked_backward(jq, jk, jv, jkb, out, lse, jg, causal=causal,
                               interpret=True, merged=merged)
    got = dense_blocked_backward_plain(*map(_t, (q, k, v, kb)), _t(out), _t(lse), _t(g),
                                       causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD)


@pytest.mark.parametrize("merged", [True, False])
def test_all_padding_row_follows_the_composite_not_the_jax_kernel(merged):
    """A source of length 0: every logit of its rows is -1e9 and its LSE
    rounds to -1e9. `_dense_xla`'s VJP (p = 1/S on every key) is the
    truth; the port's backward matches it on every row. The JAX blocked
    backward takes p = exp(s - lse) = 1 per key there and departs from it
    by orders of magnitude more than the tolerance, on that batch only."""
    q, k, v, kb, g = _inputs(32, 384, [0, 288], seed=2)
    jq, jk, jv, jkb, jg = map(jnp.asarray, (q, k, v, kb, g))
    ref_out, vjp = jax.vjp(lambda a, b_, c: _dense_xla(a, b_, c, jkb, False), jq, jk, jv)
    truth = [np.asarray(x) for x in vjp(jg)]

    out, lse = dense_rows_blocked_plain(*map(_t, (q, k, v, kb)), False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD)
    assert (lse.numpy()[:2] <= tdense.LSE_DEGENERATE).all()  # batch 0's heads
    assert (lse.numpy()[2:] > tdense.LSE_DEGENERATE).all()
    got = dense_blocked_backward_plain(*map(_t, (q, k, v, kb)), out, lse, _t(g), False)
    for a, r in zip(got, truth):
        np.testing.assert_allclose(a.numpy(), r, **GRAD)

    jout, jlse = jax_blocked(jq, jk, jv, jkb, causal=False, interpret=True)
    jgot = [np.asarray(x) for x in jax_blocked_backward(
        jq, jk, jv, jkb, jout, jlse, jg, causal=False, interpret=True, merged=merged)]
    for a, r in zip(jgot, truth):
        np.testing.assert_allclose(a[1], r[1], **GRAD)  # the open source agrees
        assert np.abs(a[0] - r[0]).max() > 100 * (GRAD["atol"] + GRAD["rtol"] * np.abs(r[0]).max())


@pytest.mark.parametrize("causal,t,s,lengths", [
    (False, 16, MAX_S + 128, [0, 3000]),  # S = 4224: an all-padding source
    (True, MAX_S + 128, MAX_S + 128, [MAX_S + 128]),
])
def test_dense_rows_routes_long_sources_to_the_blocked_route(causal, t, s, lengths,
                                                             monkeypatch):
    """Above MAX_S, `dense_rows` on CPU tensors saves out and one LSE per
    row (not m and l), runs the blocked plain versions, and gives the
    composite's output and gradients; the key bias gets none."""
    calls = []
    for name in ("dense_rows_blocked_plain", "dense_blocked_backward_plain"):
        fn = getattr(tdense, name)
        monkeypatch.setattr(tdense, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    nh = 2 if not causal else 1
    q, k, v, kb, g = _inputs(t, s, lengths, seed=3, nh=nh)
    jkb = jnp.asarray(kb)
    ref, vjp = jax.vjp(lambda a, b_, c: _dense_xla(a, b_, c, jkb, causal),
                       *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))

    leaves = [_t(x).requires_grad_() for x in (q, k, v, kb)]
    out = dense_rows(*leaves, causal)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6
    lse = saved[-1]
    assert lse.shape == (len(lengths) * nh, 1, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    out.backward(_t(g))
    for x, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **GRAD)
    assert not leaves[3].grad.any()
    assert calls == ["dense_rows_blocked_plain", "dense_blocked_backward_plain"]
    assert flash_dense_blocked.launches == flash_dense_blocked_backward.launches == 0


def test_dense_rows_keeps_row_statistics_up_to_max_s():
    """At S = MAX_S the single-pass route saves m and l, as before."""
    q, k, v, kb, _ = _inputs(8, MAX_S, [MAX_S, 100], seed=4)
    out = dense_rows(*(_t(x).requires_grad_() for x in (q, k, v)), _t(kb), False)
    assert len(out.grad_fn.saved_tensors) == 7


def test_blocked_kernels_want_cuda_tensors():
    q, k, v, kb, g = map(_t, _inputs(8, 256, [256, 10]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_dense_blocked(q, k, v, kb, causal=False)
    out, lse = dense_rows_blocked_plain(q, k, v, kb, False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dense_blocked_backward(q, k, v, kb, out, lse, g, causal=False)


# ---------------------------------------------------------------------------
# the long-source train step
# ---------------------------------------------------------------------------

B = 2


def _long_setup(seed):
    from retrieval_augmented_mds_tpu.models import config as jmc
    from retrieval_augmented_mds_tpu_torch.models import config as tmc

    cfg = trag.RAGConfig.tiny(led=tmc.Seq2SeqConfig.tiny(max_src_len=LONG))
    jcfg = jrag.RAGConfig.tiny(led=jmc.Seq2SeqConfig.tiny(max_src_len=LONG))
    jp = jrag.init_rag(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, port_params(cfg, jp)


def _long_batches(cfg, seed, n):
    """Sources of LONG tokens: one filled to 3000, one only to 40 (the
    rest padding), with labels and gold ids, in both packages' forms."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, cfg.led.vocab_size - 2, (B, LONG)).astype(np.int32)
        ids[:, 0] = cfg.led.bos_id
        ids[:, 20] = cfg.led.doc_sep_id
        mask = np.zeros((B, LONG), np.int32)
        mask[0, :3000], mask[1, :40] = 1, 1
        ids[mask == 0] = cfg.led.pad_id
        ignore = np.full((B, 8), -1, np.int32)
        ignore[:, :2] = rng.integers(0, N, (B, 2))
        labels = rng.integers(3, cfg.led.vocab_size, (B, T_DEC)).astype(np.int32)
        labels[0, 11:] = cfg.led.pad_id
        host = {"input_ids": ids, "attention_mask": mask,
                "query_input_ids": rng.integers(4, cfg.query_enc.vocab_size,
                                                (B, LQ)).astype(np.int32),
                "query_attention_mask": np.ones((B, LQ), np.int32),
                "mips_ignore": ignore, "labels": labels,
                "gold_aid": rng.integers(0, 20, B).astype(np.int32),
                "aid_counts": rng.integers(1, 4, B).astype(np.int32)}
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        jb["decoder_input_ids"] = jled.shift_tokens_right(jb["labels"], cfg.led.pad_id, 2)
        tb = {k: _t(v) for k, v in host.items()}
        tb["decoder_input_ids"] = tled.shift_tokens_right(tb["labels"], cfg.led.pad_id, 2)
        out.append((jb, tb))
    return out


def test_long_source_train_steps_match_jax(monkeypatch):
    """Two train steps of the tiny model on 4608-token sources (the
    decoder's cross-attention takes the blocked route, once per decoder
    layer and step, forward and backward), each from the same state in
    both packages: losses within rtol 1e-4, every metric (the per-group
    gradient norms among them) within rtol 1e-4 + atol 1e-5, and every
    gradient the optimizer receives within 1e-4 x the largest magnitude of
    its leaf + 1e-7 (f32 sums in another order)."""
    import optax

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tdense.dense_rows_blocked_plain, tdense.dense_blocked_backward_plain

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tdense, "dense_rows_blocked_plain", count("fwd", fwd))
    monkeypatch.setattr(tdense, "dense_blocked_backward_plain", count("bwd", bwd))

    cfg, jcfg, jp, model = _long_setup(seed=6)
    hyper = dict(lr=5e-4, warmup_steps=1, total_steps=100, grad_clip=1.0,
                 grad_group_norms=True)
    jgrads, tgrads = [], []
    jtx = joptim.build_optimizer(5e-4, 1, 100, grad_clip=1.0)

    def jupdate(g, s, p=None):  # the gradients the jitted step hands the optimizer
        jax.debug.callback(lambda x: jgrads.append(x), g)
        return jtx.update(g, s, p)

    jstep = jtrainer.make_train_step(jcfg, optax.GradientTransformation(jtx.init, jupdate),
                                     jtrainer.TrainHyper(**hyper))
    jstate = jtrainer.TrainState.create(jp, jtx)
    ttx = toptim.build_optimizer(5e-4, 1, 100, grad_clip=1.0)

    class Spy:
        def update(self, params, grads, state):
            tgrads.append({n: g.clone() for n, g in grads.items()})
            return ttx.update(params, grads, state)

    tstep = ttrainer.make_train_step(cfg, Spy(), tconfig.TrainHyper(**hyper))
    tstate = ttrainer.TrainState.create(model, ttx)
    jstore, tstore = _stores(cfg, 6)
    rng = np.random.default_rng(6)
    aids = rng.integers(0, 20, (N, 3)).astype(np.int32)
    jstore = dataclasses.replace(jstore, row_aids=jnp.asarray(
        np.concatenate([aids, np.full((jstore.token_ids.shape[0] - N, 3), -1, np.int32)])))
    tstore = dataclasses.replace(tstore, row_aids=_t(aids))
    for jb, tb in _long_batches(cfg, 6, 2):
        jstate, jm = jstep(jstate, jstore, jb, None)
        tstate, tm = tstep(tstate, tstore, tb)
        assert set(tm) == set(jm) and "grad_norm_led" in tm
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        # the parameters move alike, so the next step starts from one state
        ref = flatten_tree(jstate.params)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(_t(ref[n]))
    jax.effects_barrier()
    assert calls == {"fwd": 2 * cfg.led.dec_layers, "bwd": 2 * cfg.led.dec_layers}
    assert len(jgrads) == len(tgrads) == 2
    for jg, tg in zip(jgrads, tgrads):
        ref = flatten_tree(jg)
        assert set(ref) == set(tg)
        for n, g in tg.items():
            bound = 1e-4 * np.abs(ref[n]).max() + 1e-7
            np.testing.assert_allclose(_np(g), ref[n], rtol=0, atol=bound, err_msg=n)


def test_fit_on_long_sources_on_cpu(tmp_path, monkeypatch):
    """`cli.run_fit` of the tiny preset with `model.led.max_src_len` and
    `data.max_length` at 4608: two finite steps with a store refresh,
    the decoder's cross-attention on the blocked route."""
    calls = []
    fwd = tdense.dense_rows_blocked_plain
    monkeypatch.setattr(tdense, "dense_rows_blocked_plain",
                        lambda *a: calls.append(a[2].shape[2]) or fwd(*a))
    cfg = tconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64,
                  "led": {"max_src_len": LONG}},
        "data": {"source": "synthetic", "n_synthetic": 24, "max_length": LONG,
                 "query_max_length": 64, "decoder_max_length": T_DEC,
                 "memory_len": 64, "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 1},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10},
        "max_steps": 2, "eval_every": 0, "ckpt_dir": None,
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "long"},
    })
    report = {}
    out = cli.run_fit(cfg, device="cpu", report=report)
    assert out["steps"] == 2 and len(report["refresh_s"]) == 1
    assert all(np.isfinite(report["losses"]))
    assert calls == [LONG] * (2 * cfg.model.led.dec_layers)
