"""Parity of the port's sampled decoding and copy traces with the JAX
package, on the CPU: `copy_trace` (all five keys), `_sample_filter` over a
grid of temperature, top-k (ties at the k-th value, and top-k above V) and
top-p, sampled `generate` given the JAX package's Gumbel noise, top-k 1
sampling against greedy, sampling with beams against beam search, and
`predict` with ``generation.output_copy_probs``.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny)
through `bridge.load_jax_params`; inputs are numpy arrays made from a
seed. Tolerances: f32 rtol=atol=1e-5 (summation order); ids, positions
and masks exactly.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.models import generate as jgen
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.models import generate as tgen
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t
from tests.test_torch_rag import REPO, TOL, B, _encode_both, _setup

torch.set_num_threads(1)
TRACE_KEYS = ["copy_gate", "copy_mass", "top_mem_pos", "top_mem_tok", "top_mem_prob"]


@pytest.mark.parametrize("use_own_decoder", [True, False])
def test_copy_trace_matches_jax(use_own_decoder):
    """The copy traces of the JAX package's greedy ids, from both packages'
    `copy_trace` on the same encoder outputs: gate, mass and the top-4
    probabilities within TOL, their memory positions and token ids equal
    (the token copy head has no copy distribution: {} in both)."""
    cfg, jcfg, jp, model = _setup(seed=12, use_own_decoder=use_own_decoder)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=12)
    jids = jgen.generate(jp, jcfg, jenc, jgen.GenerationOptions(max_new_tokens=12))
    ref = jgen.copy_trace(jp, jcfg, jenc, jids, decoder_start_id=2)
    got = tgen.copy_trace(model, cfg, tenc, _t(np.asarray(jids)), decoder_start_id=2)
    if not use_own_decoder:
        assert got == {} and ref == {}
        return
    assert list(got) == TRACE_KEYS and set(ref) == set(TRACE_KEYS)
    assert got["top_mem_pos"].shape == (B, 12, 4)
    for k in ("copy_gate", "copy_mass", "top_mem_prob"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), err_msg=k, **TOL)
    for k in ("top_mem_pos", "top_mem_tok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_copy_trace_ties_take_the_lowest_position():
    """Equal copy probabilities (a memory whose slots repeat one row) rank
    by position, as `jax.lax.top_k` ranks them."""
    cfg, jcfg, jp, model = _setup(seed=13)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=13)
    half = tenc.memory.shape[1] // 2
    twins = {}
    for f in ("memory", "memory_mask", "memory_bias", "copy_seq"):
        x = getattr(tenc, f)
        twins[f] = torch.cat([x[:, :half], x[:, :half]], dim=1)
    tenc = dataclasses.replace(tenc, **twins)
    jenc = dataclasses.replace(jenc, **{f: jnp.asarray(_np(x)) for f, x in twins.items()})
    ids = np.random.default_rng(13).integers(4, cfg.led.vocab_size, (B, 6)).astype(np.int32)
    ref = jgen.copy_trace(jp, jcfg, jenc, jnp.asarray(ids), top_positions=6)
    got = tgen.copy_trace(model, cfg, tenc, _t(ids), top_positions=6)
    pos = got["top_mem_pos"].numpy()
    np.testing.assert_array_equal(pos, np.asarray(ref["top_mem_pos"]))
    # each top position's twin half a memory on comes right after it
    np.testing.assert_array_equal(pos[..., 1::2], pos[..., 0::2] + half)


def _logits(seed, b=3, v=40):
    """Log-probs with planted ties: rows 0 and 1 repeat their 5th and 6th
    largest values, row 2 is flat over its top 8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32)
    srt = np.argsort(-x, axis=1)
    for i in (0, 1):
        x[i, srt[i, 5]] = x[i, srt[i, 4]]
    x[2, srt[2, :8]] = x[2, srt[2, 0]]
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_k", [0, 1, 5, 6, 40, 43])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
def test_sample_filter_matches_jax(temperature, top_k, top_p):
    """Temperature, top-k (ties at the k-th value kept; k = V and above keep
    everything) and top-p: the same kept set as the JAX package's
    `_sample_filter`, the kept values within TOL, the rest NEG."""
    x = _logits(int(temperature * 10) + top_k)
    ref = np.asarray(jgen._sample_filter(jnp.asarray(x), top_k, top_p, temperature))
    got = tgen._sample_filter(_t(x), top_k, top_p, temperature).numpy()
    np.testing.assert_array_equal(got == tgen.NEG, ref == jgen.NEG)
    np.testing.assert_allclose(got, ref, **TOL)
    kept = (got > tgen.NEG).sum(-1)
    if top_k >= 40 and top_p == 1.0:
        assert (kept == 40).all()
    if top_k == 5 and top_p == 1.0:
        assert (kept[:2] == 6).all() and kept[2] == 8  # the ties kept


def _jax_noise(generator, t, shape, dtype):
    """The Gumbel noise `jax.random.categorical` adds at step t of the JAX
    package's sampled `_greedy` (its key folds in t, from PRNGKey(0))."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), t)
    return torch.from_numpy(np.array(jax.random.gumbel(key, tuple(shape), jnp.float32)))


@pytest.mark.parametrize("opts", [
    dict(top_k=20, top_p=0.9, temperature=0.8),
    dict(top_k=0, top_p=1.0, temperature=1.3, no_repeat_ngram_size=2),
    dict(top_k=5, top_p=0.95, temperature=1.0, repetition_penalty=1.2, min_length=8),
], ids=["topk_topp_temp", "plain_ngram", "rep_minlen"])
def test_sampled_ids_equal_jax_given_its_noise(monkeypatch, opts):
    """With the port's noise swapped for the JAX package's draw, sampled
    `generate` gives the JAX package's ids: the filter and the
    argmax(logp + g) draw of `jax.random.categorical` are the same."""
    cfg, jcfg, jp, model = _setup(seed=14)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=14)
    o = dict(max_new_tokens=12, do_sample=True, **opts)
    jids = jgen.generate(jp, jcfg, jenc, jgen.GenerationOptions(**o))
    monkeypatch.setattr(tgen, "_gumbel_noise", _jax_noise)
    tids = tgen.generate(model, cfg, tenc, tgen.GenerationOptions(**o))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_sampling_draws_from_the_generator():
    """The noise comes from the generator given: one seed gives one set of
    ids, the default is seed 0, other seeds give other ids, and the noise
    is standard Gumbel (mean 0.5772, variance pi^2/6, within 3%)."""
    cfg, jcfg, jp, model = _setup(seed=15)
    _, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=15)
    opts = tgen.GenerationOptions(max_new_tokens=10, do_sample=True)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    ids = tgen.generate(model, cfg, tenc, opts, generator=gen(5))
    assert torch.equal(ids, tgen.generate(model, cfg, tenc, opts, generator=gen(5)))
    assert torch.equal(tgen.generate(model, cfg, tenc, opts),
                       tgen.generate(model, cfg, tenc, opts, generator=gen(0)))
    assert not all(torch.equal(ids, tgen.generate(model, cfg, tenc, opts, generator=gen(s)))
                   for s in (6, 7, 8))
    g = tgen._gumbel_noise(gen(1), 0, (200, 1000), torch.float32).double()
    np.testing.assert_allclose(float(g.mean()), 0.5772156649, rtol=0.03)
    np.testing.assert_allclose(float(g.var()), np.pi ** 2 / 6, rtol=0.03)


def test_top_k_1_sampling_equals_greedy():
    """Top-k 1 keeps only each row's largest score, so sampling picks it
    whatever the noise: the greedy ids, at any temperature and top-p."""
    cfg, jcfg, jp, model = _setup(seed=16)
    _, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=16)
    o = dict(max_new_tokens=12, no_repeat_ngram_size=2, min_length=4)
    greedy = tgen.generate(model, cfg, tenc, tgen.GenerationOptions(**o))
    for temperature, top_p in ((1.0, 1.0), (0.5, 0.9), (2.0, 0.5)):
        sampled = tgen.generate(model, cfg, tenc, tgen.GenerationOptions(
            do_sample=True, top_k=1, temperature=temperature, top_p=top_p, **o))
        assert torch.equal(sampled, greedy)


@pytest.mark.parametrize("beams", [2, 4])
def test_do_sample_with_beams_runs_beam_search(beams):
    """With more than one beam the flag is ignored, as in the JAX package:
    the beam-search ids, which equal the JAX package's."""
    cfg, jcfg, jp, model = _setup(seed=17)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=17)
    o = dict(max_new_tokens=10, num_beams=beams, no_repeat_ngram_size=3)
    beam = tgen.generate(model, cfg, tenc, tgen.GenerationOptions(**o))
    sampled = tgen.generate(model, cfg, tenc, tgen.GenerationOptions(
        do_sample=True, top_k=5, temperature=0.7, **o))
    assert torch.equal(sampled, beam)
    jids = jgen.generate(jp, jcfg, jenc, jgen.GenerationOptions(do_sample=True, **o))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(jids))


def test_predict_returns_copy_traces_as_lists(capsys):
    """`predict --device cpu` on configs/smoke.yaml with
    ``output_copy_probs`` and sampling: the traces are nested lists under
    the five keys ([B][T] and [B][T][4]), equal to `copy_trace` of the
    run's own encoder outputs and ids, and they serialise without
    ``default=``."""
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(
        cfg.generation, output_copy_probs=True, do_sample=True, num_beams=1, top_k=10,
        max_new_tokens=6))
    rep = {}
    out = cli.run_predict(cfg, device="cpu", report=rep)
    traces = out["copy_traces"]
    assert list(traces) == TRACE_KEYS
    b, t = rep["ids"].shape
    assert all(isinstance(v, list) and len(v) == b and len(v[0]) == t for v in traces.values())
    assert len(traces["top_mem_pos"][0][0]) == 4
    ref = tgen.copy_trace(rep["params"], cfg.model, rep["enc"], rep["ids"],
                          decoder_start_id=cfg.generation.decoder_start_id)
    for k in TRACE_KEYS:
        assert traces[k] == ref[k].tolist(), k
    assert json.loads(json.dumps(out)) == out
