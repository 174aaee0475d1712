"""Parity of the port's model modules with the JAX package, on the CPU.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny: two
layers, width 64) through `bridge.load_jax_params`; inputs are numpy
arrays made from a seed. Tolerances are f32 rtol=atol=1e-5 unless a test
says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from retrieval_augmented_mds_tpu.models import copy_decoder as jcopy
from retrieval_augmented_mds_tpu.models import core as jcore
from retrieval_augmented_mds_tpu.models import led as jled
from retrieval_augmented_mds_tpu.models import longformer as jlong
from retrieval_augmented_mds_tpu.models.config import EncoderConfig
from retrieval_augmented_mds_tpu.models.longformer import (
    init_longformer as jax_init_longformer,
    longformer_encode as jax_longformer_encode,
)
from retrieval_augmented_mds_tpu.models.retriever_generator import (
    RAGConfig as JaxRAGConfig,
    init_rag as jax_init_rag,
)
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree, load_jax_params
from retrieval_augmented_mds_tpu_torch.models import copy_decoder as tcopy
from retrieval_augmented_mds_tpu_torch.models import core as tcore
from retrieval_augmented_mds_tpu_torch.models import led as tled
from retrieval_augmented_mds_tpu_torch.models.core import Dense, causal_mask
from retrieval_augmented_mds_tpu_torch.models.longformer import (
    Longformer,
    cls_pool,
    longformer_encode,
)
from retrieval_augmented_mds_tpu_torch.models.retriever_generator import (
    RAGConfig,
    init_rag,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.detach().float().numpy()


def port_params(cfg: RAGConfig, jax_params):
    """The port's model holding the JAX package's parameter values."""
    model = init_rag(cfg, torch.Generator().manual_seed(0))
    return load_jax_params(model, jax_params)


@pytest.fixture(scope="module")
def tiny():
    cfg = RAGConfig.tiny()
    jparams = jax_init_rag(jax.random.PRNGKey(0), JaxRAGConfig.tiny())
    return cfg, jparams, port_params(cfg, jparams)


@pytest.mark.parametrize(
    "kw", [{}, {"memory_model_fixed": False}, {"use_own_decoder": False},
           {"gates_mode": "onlycopy", "copy_decoder_layers": 2}],
)
def test_init_matches_jax_tree(kw):
    """Same key paths and shapes as `init_rag`, and the same distributions:
    N(0, 0.02²) kernels and tables, zero biases, unit LayerNorm scales and
    copy-head betas."""
    jflat = flatten_tree(jax_init_rag(jax.random.PRNGKey(0), JaxRAGConfig.tiny(**kw)))
    model = init_rag(RAGConfig.tiny(**kw), torch.Generator().manual_seed(1))
    tflat = {k: _np(v) for k, v in model.named_parameters()}
    assert sorted(tflat) == sorted(jflat)
    for name, arr in tflat.items():
        assert arr.shape == jflat[name].shape, name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "table"):
            assert abs(arr.std() - 0.02) < 0.004 and abs(arr.mean()) < 0.004, name
        elif leaf.endswith("bias"):
            assert (arr == 0).all(), name
        else:  # LayerNorm scale, beta
            assert (arr == 1).all(), name


def test_init_is_seeded_by_the_generator():
    cfg = RAGConfig.tiny()
    a = init_rag(cfg, torch.Generator().manual_seed(3))
    b = init_rag(cfg, torch.Generator().manual_seed(3))
    for (_, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y)


def test_bridge_rejects_mismatched_trees(tiny):
    cfg, jparams, _ = tiny
    model = init_rag(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(KeyError):
        load_jax_params(model, {"led": jparams["led"]})


@pytest.mark.parametrize("adapter_dim", [0, 16])
def test_longformer_encode_matches_jax(adapter_dim):
    cfg = EncoderConfig.tiny(adapter_dim=adapter_dim)
    jp = jax_init_longformer(jax.random.PRNGKey(1), cfg)
    mod = load_jax_params(Longformer(cfg), jp)
    rng = np.random.default_rng(0)
    b, t = 3, 128
    ids = rng.integers(4, cfg.vocab_size, (b, t)).astype(np.int32)
    pad = np.ones((b, t), np.int32)
    pad[1, 90:] = 0
    pad[2, 40:] = 0
    ref = jax_longformer_encode(jp, cfg, jnp.asarray(ids), jnp.asarray(pad))
    got = longformer_encode(mod, cfg, _t(ids), _t(pad))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("helper", ["cls_pool", "cls_pool_proj", "shift_tokens_right",
                                    "causal_mask"])
def test_small_helpers_match_jax(helper):
    rng = np.random.default_rng(8)
    if helper.startswith("cls_pool"):
        hidden = rng.standard_normal((3, 5, 16)).astype(np.float32)
        jproj = tproj = None
        if helper == "cls_pool_proj":
            jproj = jlong.init_projection(jax.random.PRNGKey(4), 16, 8)
            tproj = nn.Module()
            tproj.proj = Dense(16, 8)
            load_jax_params(tproj, jproj)
        ref = jlong.cls_pool(jnp.asarray(hidden), jproj)
        got = cls_pool(_t(hidden), tproj)
    elif helper == "shift_tokens_right":
        ids = rng.integers(4, 50, (3, 7)).astype(np.int32)
        ids[1, 3] = ids[2, 6] = -100
        ref = jled.shift_tokens_right(jnp.asarray(ids), 1, 2)
        got = tled.shift_tokens_right(_t(ids), 1, 2)
    else:
        ref = jcore.causal_mask(3, 9, 4)
        got = causal_mask(3, 9, 4)
    if helper == "cls_pool_proj":  # a matmul: summation-order noise
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    else:
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


def test_dense_rounds_once_like_jax():
    """bf16 inputs and kernel, an f32 bias with fractional parts: the port's
    `dense` accumulates in f32, adds the f32 bias and rounds once, as JAX's
    does, and equals it on all but a tiny share of outputs (< 0.5%), which
    sit on a bf16 rounding boundary that the two packages' f32 summation
    orders put on either side (one bf16 ulp apart). Rounding the product to
    bf16 first and again after the bias (the port's earlier form) misses
    JAX on many more outputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    jp = {"kernel": jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32) * 0.1),
          "bias": jnp.asarray((rng.standard_normal(96) * 0.37).astype(np.float32))}
    mod = load_jax_params(Dense(64, 96), jp)
    ref = np.asarray(jcore.dense(jp, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = tcore.dense(mod, _t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = _np(got)
    with torch.no_grad():
        twice = torch.matmul(_t(x).bfloat16(), mod.kernel.bfloat16()).float() + mod.bias
    twice = _np(twice.bfloat16())
    ulp = np.abs(ref) * 2.0 ** -7  # the bf16 spacing at each |ref| (upper bound)
    assert (got != ref).mean() < 0.005
    assert (np.abs(got - ref) <= ulp).all()
    assert (twice != ref).mean() > 10 * max((got != ref).mean(), 1e-3)


def _led_inputs(cfg, seed=0, b=2, s=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.led.vocab_size - 2, (b, s)).astype(np.int32)
    ids[:, 0] = cfg.led.bos_id
    ids[:, 40] = cfg.led.doc_sep_id
    pad = np.ones((b, s), np.int32)
    pad[1, 100:] = 0
    glob = np.zeros((b, s), np.int32)
    glob[:, 0] = 1
    glob[:, 40] = 1
    return ids, pad, glob


def test_led_encode_matches_jax(tiny):
    cfg, jp, model = tiny
    ids, pad, glob = _led_inputs(cfg)
    ref = jled.led_encode(jp["led"], cfg.led, jnp.asarray(ids), jnp.asarray(pad),
                          jnp.asarray(glob))
    got = tled.led_encode(model.led, cfg.led, _t(ids), _t(pad), _t(glob))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_cached_led_decode_matches_jax_over_steps(tiny):
    """Six incremental steps against precomputed cross K/V: hidden states,
    logits and the self-attention caches match at every step."""
    cfg, jp, model = tiny
    ids, pad, _ = _led_inputs(cfg, seed=1)
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 128, cfg.led.d_model)).astype(np.float32)
    steps = rng.integers(4, cfg.led.vocab_size, (2, 6)).astype(np.int32)
    jc = jled.init_decode_caches(jp["led"], cfg.led, 2, 8, enc_hidden=jnp.asarray(enc))
    tc = tled.init_decode_caches(model.led, cfg.led, 2, 8, enc_hidden=_t(enc))
    for t in range(steps.shape[1]):
        jh, jc = jled.led_decode(jp["led"], cfg.led, jnp.asarray(steps[:, t:t + 1]),
                                 jnp.asarray(enc), jnp.asarray(pad), caches=jc,
                                 pos_offset=t)
        th, tc = tled.led_decode(model.led, cfg.led, _t(steps[:, t:t + 1]), _t(enc),
                                 _t(pad), caches=tc, pos_offset=t)
        np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
        np.testing.assert_allclose(
            _np(tled.led_lm_logits(model.led, th)),
            np.asarray(jled.led_lm_logits(jp["led"], jh)), **TOL)
    for jl, tl in zip(jc, tc):
        assert tl["pos"] == int(jl["pos"])
        np.testing.assert_allclose(_np(tl["k"]), np.asarray(jl["k"]), **TOL)


def test_teacher_forced_decode_is_pending(tiny):
    """The teacher-forced decoder runs (its parity is in
    test_torch_train.py), with gradient checkpointing too (the same hidden
    states; tests/test_torch_remat.py holds its gradients); what stays
    pending is a name the port has no policy for (here a factory of
    jax.checkpoint_policies), which raises."""
    cfg, _, model = tiny
    x = torch.zeros((1, 4), dtype=torch.int32)
    hid, caches = tled.led_decode(model.led, cfg.led, x, torch.zeros(1, 64, 64),
                                  torch.ones(1, 64))
    assert hid.shape == (1, 4, cfg.led.d_model) and caches is None
    again, _ = tled.led_decode(model.led, cfg.led, x, torch.zeros(1, 64, 64),
                               torch.ones(1, 64), remat="full")
    assert torch.equal(again, hid)
    with pytest.raises(ValueError, match="remat"):
        tled.led_decode(model.led, cfg.led, x, torch.zeros(1, 64, 64),
                        torch.ones(1, 64), remat="save_only_these_names")


def _memory(cfg, b, seed=3, m=128):
    rng = np.random.default_rng(seed)
    h = cfg.led.d_model
    memory = rng.standard_normal((b, m, h)).astype(np.float32)
    mask = (rng.random((b, m)) > 0.2).astype(np.int32)
    bias = rng.standard_normal((b, m)).astype(np.float32)
    seq = rng.integers(4, cfg.led.vocab_size, (b, m)).astype(np.int32)
    return memory, mask, bias, seq


@pytest.mark.parametrize("beams", [1, 3])
def test_copy_head_a_matches_jax(tiny, beams):
    """Head A with precomputed memory K/V; with beams the decoder rows are
    a multiple of the (un-expanded) memory batch and fold into it."""
    cfg, jp, model = tiny
    b = 2
    memory, mask, bias, seq = _memory(cfg, b)
    hid = np.random.default_rng(4).standard_normal(
        (b * beams, 3, cfg.led.d_model)).astype(np.float32)
    nh = cfg.led.n_heads
    jkv = jcopy.precompute_copy_kv(jp["copy_head"], jnp.asarray(memory), nh)
    tkv = tcopy.precompute_copy_kv(model.copy_head, _t(memory), nh)
    ref = jcopy.copy_decoder_forward(
        jp["copy_head"], jnp.asarray(hid), jnp.asarray(memory), jnp.asarray(mask),
        jnp.asarray(bias), n_heads=nh, copy_kv=jkv)
    got = tcopy.copy_decoder_forward(
        model.copy_head, _t(hid), _t(memory), _t(mask), _t(bias), n_heads=nh,
        copy_kv=tkv)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)
    lm = np.random.default_rng(5).standard_normal(
        (b * beams, 3, cfg.led.vocab_size)).astype(np.float32)
    mixed = tcopy.mix_copy_probs(_t(lm), got[0], got[2], _t(seq))
    np.testing.assert_allclose(
        _np(mixed),
        np.asarray(jcopy.mix_copy_probs(jnp.asarray(lm), ref[0], ref[2],
                                        jnp.asarray(seq))), **TOL)
    np.testing.assert_allclose(_np(mixed.exp().sum(-1)), 1.0, rtol=1e-4)


@pytest.mark.parametrize("beams", [1, 2])
def test_copy_head_b_matches_jax(beams):
    cfg = RAGConfig.tiny(use_own_decoder=False)
    jp = jax_init_rag(jax.random.PRNGKey(2), JaxRAGConfig.tiny(use_own_decoder=False))
    model = port_params(cfg, jp)
    b = 2
    memory, mask, bias, seq = _memory(cfg, b, seed=6)
    hid = np.random.default_rng(7).standard_normal(
        (b * beams, 3, cfg.led.d_model)).astype(np.float32)
    table = jp["led"]["shared_emb"]["table"]
    ref = jcopy.copy_token_decoder_forward(
        jp["copy_head"], jnp.asarray(hid), jnp.asarray(memory), jnp.asarray(mask),
        jnp.asarray(bias), jnp.asarray(seq), table)
    got = tcopy.copy_token_decoder_forward(
        model.copy_head, _t(hid), _t(memory), _t(mask), _t(bias), _t(seq),
        model.led.shared_emb.table)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_config_dataclasses_mirror_jax():
    """The port's RAGConfig has the JAX package's fields and defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxRAGConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RAGConfig)}
    assert jf == tf
