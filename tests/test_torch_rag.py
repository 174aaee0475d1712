"""Parity of the port's serving slice with the JAX package, on the CPU:
flat search and index files, `rag_encode`, `rag_decode`, `generate`, the
config schema, `predict`, and the port's independence from JAX (the IVF
index has its own file, `test_torch_ivf.py`).

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny)
through `bridge.load_jax_params`; inputs are numpy arrays made from a
seed. Tolerances are f32 rtol=atol=1e-5 unless a test says otherwise.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.index import flat as jflat
from retrieval_augmented_mds_tpu.models import generate as jgen
from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu.utils import config as jconfig
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.index import flat as tflat
from retrieval_augmented_mds_tpu_torch.models import generate as tgen
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.models.led import init_decode_caches
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t, port_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, LQ, LM, N = 2, 128, 64, 64, 64


# ---------------------------------------------------------------------------
# flat index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "metric,normalize,dtype",
    [("ip", False, "float32"), ("ip", True, "bfloat16"), ("l2", False, "float32"),
     ("ip", False, "int8")],
)
def test_flat_search_with_self_exclusion_matches_jax(metric, normalize, dtype):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((300, 48)).astype(np.float32)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    ignore = rng.integers(-1, 300, (5, 6)).astype(np.int32)
    ignore[:, 0] = np.argmax(q @ emb.T, axis=1)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}[dtype]
    jidx = jflat.build_flat_index(emb, metric=metric, normalize=normalize, dtype=jdt)
    tidx = tflat.build_flat_index(emb, metric=metric, normalize=normalize, dtype=dtype)
    jv, ji = jflat.search(jidx, jnp.asarray(q), k=8, ignore=jnp.asarray(ignore))
    tv, ti = tflat.search(tidx, _t(q), k=8, ignore=_t(ignore))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert not ((ti.numpy()[:, :, None] == ignore[:, None, :]) & (ignore[:, None, :] >= 0)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_files_load_in_either_package(tmp_path, dtype, writer):
    """An index saved by one package loads in the other and searches the
    same (the JAX index keeps its tile padding; the port's has none)."""
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((100, 40)).astype(np.float32)
    q = rng.standard_normal((4, 40)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}[dtype]
    path = str(tmp_path / "idx")
    if writer == "jax":
        jflat.save_flat_index(jflat.build_flat_index(emb, metric="l2", dtype=jdt), path)
    else:
        tflat.save_flat_index(tflat.build_flat_index(emb, metric="l2", dtype=dtype), path)
    jidx = jflat.load_flat_index(path)
    tidx = tflat.load_flat_index(path)
    assert (tidx.n, tidx.metric, tidx.dim) == (100, "l2", jidx.dim)
    jv, ji = jflat.search(jidx, jnp.asarray(q), k=5)
    tv, ti = tflat.search(tidx, _t(q), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_ivf_factory_is_pending():
    """The IVF factory specs, once pending, build an IVF index (SQ8: an
    int8 payload); what stays unsupported raises as in the JAX package."""
    from retrieval_augmented_mds_tpu_torch.index import IVFIndex, build_index_from_factory

    x = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    idx = build_index_from_factory(x, "IVF4,SQ8")
    assert isinstance(idx, IVFIndex) and idx.clustered.dtype == torch.int8
    assert idx.n_clusters == 4 and idx.n == 64
    with pytest.raises(ValueError, match="unsupported"):
        build_index_from_factory(x, "IVF4,PQ16")


# ---------------------------------------------------------------------------
# the RAG model
# ---------------------------------------------------------------------------

def _stores(cfg, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((N, cfg.query_enc.d_model)).astype(np.float32)
    ids = rng.integers(4, cfg.mips_enc.vocab_size, (N, LM)).astype(np.int32)
    ids[:, 0] = cfg.mips_enc.bos_id
    mask = np.ones((N, LM), np.int32)
    mask[::3, 50:] = 0
    jstore = jrag.MemoryStore(
        index=jflat.build_flat_index(emb, dtype=jnp.float32, row_align=64),
        token_ids=jnp.asarray(ids), token_mask=jnp.asarray(mask))
    tstore = trag.MemoryStore(
        index=tflat.build_flat_index(emb, dtype="float32"),
        token_ids=_t(ids), token_mask=_t(mask))
    return jstore, tstore


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    v = cfg.led.vocab_size
    input_ids = rng.integers(4, v - 2, (B, S)).astype(np.int32)
    input_ids[:, 0] = cfg.led.bos_id
    input_ids[:, 40] = cfg.led.doc_sep_id
    mask = np.ones((B, S), np.int32)
    mask[1, 110:] = 0
    qids = rng.integers(4, cfg.query_enc.vocab_size, (B, LQ)).astype(np.int32)
    ignore = np.full((B, 8), -1, np.int32)
    ignore[:, :2] = rng.integers(0, N, (B, 2))
    return {"input_ids": input_ids, "attention_mask": mask,
            "query_input_ids": qids, "query_attention_mask": np.ones((B, LQ), np.int32),
            "mips_ignore": ignore}


def _setup(seed=0, **kw):
    cfg = trag.RAGConfig.tiny(**kw)
    jcfg = jrag.RAGConfig.tiny(**kw)
    jp = jrag.init_rag(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, port_params(cfg, jp)


def _encode_both(cfg, jcfg, jp, model, seed=0):
    jstore, tstore = _stores(cfg, seed)
    batch = _batch(cfg, seed + 1)
    jenc = jrag.rag_encode(jp, jcfg, jstore,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tenc = trag.rag_encode(model, cfg, tstore, {k: _t(v) for k, v in batch.items()})
    return jenc, tenc, batch


@pytest.mark.parametrize(
    "kw", [{}, {"memory_forcing": "retrieved_forcing"}, {"memory_model_fixed": False}],
)
def test_rag_encode_matches_jax(kw):
    cfg, jcfg, jp, model = _setup(**kw)
    jenc, tenc, batch = _encode_both(cfg, jcfg, jp, model)
    np.testing.assert_array_equal(tenc.retrieved_idx.numpy(),
                                  np.asarray(jenc.retrieved_idx))
    for name in ("enc_hidden", "memory", "memory_bias", "mips_scores",
                 "faiss_scores", "query_cls"):
        np.testing.assert_allclose(_np(getattr(tenc, name)),
                                   np.asarray(getattr(jenc, name)), err_msg=name, **TOL)
    for name in ("memory_mask", "copy_seq"):
        np.testing.assert_array_equal(getattr(tenc, name).numpy(),
                                      np.asarray(getattr(jenc, name)), err_msg=name)
    if not kw:  # self-exclusion holds
        ign = batch["mips_ignore"]
        idx = tenc.retrieved_idx.numpy()
        assert not ((idx[:, :, None] == ign[:, None, :]) & (ign[:, None, :] >= 0)).any()


def test_encode_corpus_matches_jax():
    """The store's corpus embeddings: 50 rows in batches of 16 (the last
    one ragged here, padded in the JAX package)."""
    from retrieval_augmented_mds_tpu.train import trainer as jtrainer
    from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer

    cfg, jcfg, jp, model = _setup(seed=4)
    rng = np.random.default_rng(4)
    ids = rng.integers(4, cfg.mips_enc.vocab_size, (50, LM)).astype(np.int32)
    ids[:, 0] = cfg.mips_enc.bos_id
    mask = np.ones((50, LM), np.int32)
    mask[::4, 40:] = 0
    ref = jtrainer.encode_corpus(jp["mips_encoder"], jcfg.mips_enc, jnp.asarray(ids),
                                 jnp.asarray(mask), batch_size=16)
    got = ttrainer.encode_corpus(model.mips_encoder, cfg.mips_enc, _t(ids), _t(mask),
                                 batch_size=16)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_pending_memory_modes_raise():
    """The memory modes, once pending, run (their parity is in
    test_torch_memory_modes.py): ``target_in`` puts its target slot before
    the k retrieved ones; what still raises is a mode neither package has."""
    cfg, _, _, model = _setup(memory_forcing="target_in", copy_forcing=0.5)
    _, tstore = _stores(cfg)
    batch = _batch(cfg)
    batch["target_memory_ids"] = batch["query_input_ids"]
    batch["target_memory_mask"] = batch["query_attention_mask"]
    enc = trag.rag_encode(model, cfg, tstore, {k: _t(v) for k, v in batch.items()})
    assert cfg.memory_slots == cfg.mips_topk + 1
    assert enc.memory.shape == (B, cfg.memory_slots * LM, cfg.led.d_model)
    np.testing.assert_array_equal(enc.copy_seq[:, :LM].numpy(), batch["query_input_ids"])
    with pytest.raises(ValueError, match="memory_forcing"):
        trag.RAGConfig.tiny(memory_forcing="target_first")


@pytest.mark.parametrize("use_own_decoder", [True, False])
def test_rag_decode_matches_jax(use_own_decoder):
    """Three cached decode steps through the copy mixture (log-probs)."""
    cfg, jcfg, jp, model = _setup(seed=1, use_own_decoder=use_own_decoder)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=1)
    from retrieval_augmented_mds_tpu.models.led import (
        init_decode_caches as jax_init_caches,
    )

    jc = jax_init_caches(jp["led"], jcfg.led, B, 4, enc_hidden=jenc.enc_hidden)
    tc = init_decode_caches(model.led, cfg.led, B, 4, enc_hidden=tenc.enc_hidden)
    toks = np.array([[2, 17, 33], [2, 5, 400]], np.int32)
    for t in range(3):
        jo, _, jc = jrag.rag_decode(jp, jcfg, jenc, jnp.asarray(toks[:, t:t + 1]),
                                    caches=jc, pos_offset=t)
        to, _, tc = trag.rag_decode(model, cfg, tenc, _t(toks[:, t:t + 1]),
                                    caches=tc, pos_offset=t)
        np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)


@pytest.mark.parametrize(
    "opts",
    [
        dict(num_beams=1),
        dict(num_beams=1, no_repeat_ngram_size=2, repetition_penalty=1.3),
        dict(num_beams=2, no_repeat_ngram_size=3),
        dict(num_beams=3, no_repeat_ngram_size=2, min_length=6),
        dict(num_beams=4, no_repeat_ngram_size=3, length_penalty=0.8,
             early_stopping=True),
    ],
    ids=["greedy", "greedy_ngram_rep", "beam2", "beam3_minlen", "beam4_early"],
)
def test_generate_ids_equal_jax(opts):
    """The same token ids as the JAX package, greedy and beam search."""
    cfg, jcfg, jp, model = _setup(seed=2)
    jenc, tenc, _ = _encode_both(cfg, jcfg, jp, model, seed=2)
    jids = jgen.generate(jp, jcfg, jenc,
                         jgen.GenerationOptions(max_new_tokens=10, **opts))
    tids = tgen.generate(model, cfg, tenc,
                         tgen.GenerationOptions(max_new_tokens=10, **opts))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_generate_without_memory_equals_jax():
    cfg, jcfg, jp, model = _setup(seed=3, mips_disabled=True)
    batch = _batch(cfg, 4)
    jenc = jrag.rag_encode(jp, jcfg, None, {k: jnp.asarray(v) for k, v in batch.items()})
    tenc = trag.rag_encode(model, cfg, None, {k: _t(v) for k, v in batch.items()})
    o = dict(max_new_tokens=8, num_beams=2, no_repeat_ngram_size=2)
    np.testing.assert_array_equal(
        tgen.generate(model, cfg, tenc, tgen.GenerationOptions(**o)).numpy(),
        np.asarray(jgen.generate(jp, jcfg, jenc, jgen.GenerationOptions(**o))))


def test_sampling_is_pending():
    """Sampling, once pending, runs (its parity with the JAX package's draw
    is in test_torch_generate_modes.py): one seed gives the same ids, and
    no generator means seed 0."""
    cfg, _, _, model = _setup(seed=3, mips_disabled=True)
    tenc = trag.rag_encode(model, cfg, None, {k: _t(v) for k, v in _batch(cfg).items()})
    opts = tgen.GenerationOptions(do_sample=True, max_new_tokens=6, top_k=20)
    ids = tgen.generate(model, cfg, tenc, opts)
    assert ids.shape == (B, 6)
    again = tgen.generate(model, cfg, tenc, opts, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ids, again)


# ---------------------------------------------------------------------------
# config, predict, and independence from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "configs"))))
def test_yaml_configs_parse_like_jax(name):
    path = os.path.join(REPO, "configs", name)
    assert (dataclasses.asdict(tconfig.load_config(path))
            == dataclasses.asdict(jconfig.load_config(path)))


def test_predict_on_cpu_smoke_config(capsys):
    assert cli.main(["predict", "--config", os.path.join(REPO, "configs", "smoke.yaml"),
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert list(out) == ["predictions"]
    assert len(out["predictions"]) == 4 and all(p.strip() for p in out["predictions"])


def test_predict_refuses_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.resolve_device("cuda")


def test_predict_loads_an_index_built_by_jax(tmp_path):
    """`predict --index` on a directory written by the JAX package."""
    cfg = tconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 32,
                 "memory_len": 64, "batch_size": 2},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
    })
    dm, _ = cli.build_data(cfg)
    n = dm.corpus_size
    emb = np.random.default_rng(0).standard_normal((n, 64)).astype(np.float32)
    jflat.save_flat_index(jflat.build_flat_index(emb, dtype=jnp.bfloat16), str(tmp_path))
    np.savez(tmp_path / "corpus_tokens.npz", **dm.store_arrays)
    report = {}
    out = cli.run_predict(cfg, str(tmp_path), device="cpu", report=report)
    assert len(out["predictions"]) == 2
    assert report["store"].index.n == n
    assert ((report["enc"].retrieved_idx >= 0) & (report["enc"].retrieved_idx < n)).all()


def test_port_imports_no_jax():
    """Every module of the port, the training slice's and the IVF index's
    included, imports with JAX made unimportable, and loads nothing of the
    JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import retrieval_augmented_mds_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert 'jax' not in loaded\n"
        "assert not [k for k in loaded if k.split('.')[0] == 'retrieval_augmented_mds_tpu']\n"
        "print(' '.join(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = res.stdout.split()
    assert len(mods) >= 30
    for m in ("ops.flash_dense", "ops.flash_sliding_bwd", "train.loss", "train.optimizer",
              "train.trainer", "utils.checkpoint", "retriever.metrics", "index.ivf",
              "data.pipeline", "obs.logging"):
        assert f"retrieval_augmented_mds_tpu_torch.{m}" in mods
