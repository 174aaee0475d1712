"""Parity of the port's retriever pretraining with the JAX package, on the
CPU: the contrastive loss and its gradients, both metric variants, the
full-KB validation (the ``ip`` and ``l2`` routes, and the corrected gold
of a duplicated positive), three train steps, and ``pretrain-retriever``
in its train, test and predict modes.

Parameters come from the JAX package's `init_retriever` (tiny encoders:
two layers, width 64, window 16) through `bridge.load_jax_params`; inputs
are numpy arrays made from a seed; everything is f32. Tolerances are
stated at each test.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from retrieval_augmented_mds_tpu import cli as jcli
from retrieval_augmented_mds_tpu.models.config import EncoderConfig as JEncoderConfig
from retrieval_augmented_mds_tpu.retriever import contrastive as jcon
from retrieval_augmented_mds_tpu.retriever import metrics as jmetrics
from retrieval_augmented_mds_tpu.retriever import validate as jvalidate
from retrieval_augmented_mds_tpu.train import optimizer as joptim
from retrieval_augmented_mds_tpu.train import trainer as jtrainer
from retrieval_augmented_mds_tpu.utils import checkpoint as jckpt
from retrieval_augmented_mds_tpu.utils import config as jconfig
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree, load_jax_params
from retrieval_augmented_mds_tpu_torch.models.config import EncoderConfig
from retrieval_augmented_mds_tpu_torch.retriever import contrastive as tcon
from retrieval_augmented_mds_tpu_torch.retriever import metrics as tmetrics
from retrieval_augmented_mds_tpu_torch.retriever import validate as tvalidate
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer
from retrieval_augmented_mds_tpu_torch.utils import checkpoint as tckpt
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np, _t
from tests.test_torch_train import (
    _check_gradients,
    _jax_tree,
    _KeepGradients,
    _state_arrays,
)

torch.set_num_threads(1)
ENC = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ffn=128, max_len=128,
           window=16, max_globals=4)
B, LQ, LM = 4, 64, 32


def _configs(**kw):
    """(port RetrieverConfig, JAX RetrieverConfig) of the tiny encoders."""
    return (tcon.RetrieverConfig(query_enc=EncoderConfig(**ENC), mips_enc=EncoderConfig(**ENC),
                                 **kw),
            jcon.RetrieverConfig(query_enc=JEncoderConfig(**ENC),
                                 mips_enc=JEncoderConfig(**ENC), **kw))


def _params(rcfg, jrcfg, seed=0):
    jp = jcon.init_retriever(jax.random.PRNGKey(seed), jrcfg)
    model = tcon.init_retriever(rcfg, torch.Generator().manual_seed(0))
    return jp, load_jax_params(model, jp)


def _side(rng, n, length, vocab):
    """Token ids [n, length]: random tokens, eos, then padding (id 1, mask
    0) after a random length, with a bos (id 0) inside. The first token is
    random, not bos: the CLS state then differs from row to row as much as
    the token table does, so the in-batch softmax is well conditioned
    (with one first token for all rows, random weights give nearly equal
    CLS states, and the loss's gradient on them is a difference of nearly
    equal vectors, mostly roundoff)."""
    ids = rng.integers(4, vocab, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    for i in range(n):
        cut = int(rng.integers(length // 3, length + 1))
        ids[i, 1], ids[i, cut - 1] = 0, 2
        ids[i, cut:], mask[i, cut:] = 1, 0
    return ids, mask


def _pairs(seed, n, vocab=512):
    rng = np.random.default_rng(seed)
    q, qm = _side(rng, n, LQ, vocab)
    m, mm = _side(rng, n, LM, vocab)
    return {"query_input_ids": q, "query_attention_mask": qm,
            "mips_input_ids": m, "mips_attention_mask": mm}


def _jax_grads(params, jrcfg, batch):
    """The JAX package's loss, metrics and gradients ({"a.b": array}) from
    ``params``, in f32 and again with the parameters and the compute in f64
    (x64 on; each package's run keeps the same casts to f32)."""
    out = []
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            p = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype), params)
            (loss, m), g = jax.value_and_grad(
                lambda p: jcon.contrastive_loss(
                    p, jrcfg, {k: jnp.asarray(v) for k, v in batch.items()}, dtype=dtype),
                has_aux=True)(p)
            out.append((loss, m, {n: np.asarray(x, np.float64)
                                  for n, x in flatten_tree(g).items()}))
    return out


def _check_grads(step: int, port: dict, jax_: dict, port64: dict, jax64: dict):
    """`test_torch_train._check_gradients` with a last term of 2^-18 of the
    leaf's norm (32 f32 roundings) in place of 2^-22: both packages' f64
    runs keep the retriever's head in f32 (the CLS is cast to f32, and the
    JAX package's `dense` keeps f32 outputs), so their own roundoff r is
    about 0 on the head's leaves (the projections and the BOW heads), and
    the last term holds those leaves. Measured on these tests: every gap
    within 0.47 of its bound."""
    _check_gradients(step, port, jax_, port64, jax64, rel=2.0 ** -18)


def _port_grads(model, rcfg, batch, dtype=torch.float32):
    """The port's loss, metrics and gradients (by name) of ``model``, or of
    an f64 copy of it with ``dtype`` f64."""
    if dtype == torch.float64:
        model = copy.deepcopy(model).double()
    loss, m = tcon.contrastive_loss(model, rcfg, {k: _t(v) for k, v in batch.items()},
                                    dtype=dtype)
    model.zero_grad(set_to_none=True)
    loss.backward()
    g = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), m, g


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(pooling_dim=16, temperature=0.05),
                                dict(token_loss=True)])
def test_contrastive_loss_and_gradients_match_jax(kw):
    """Loss and metrics within rtol 1e-5 (`train_accuracy` equal); the
    gradient of every leaf held to the two packages' own roundoff, each
    against its own f64 run (`_check_grads`), so that a
    fault in a leaf far below the tree's largest gradient still shows. With
    ``token_loss`` the token tables get gradient through the encoder and
    the tied BOW logits, and are held leaf by leaf like the rest."""
    rcfg, jrcfg = _configs(**kw)
    jp, model = _params(rcfg, jrcfg, seed=1)
    batch = _pairs(2, B)
    (jloss, jm, jg), (_, _, jg64) = _jax_grads(jp, jrcfg, batch)
    loss, tm, got = _port_grads(model, rcfg, batch)
    got64 = _port_grads(model, rcfg, batch, torch.float64)[2]
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["train_accuracy"]) == float(jm["train_accuracy"])
    assert set(got) == set(jg)
    _check_grads(0, got, jg, got64, jg64)
    ref = jg
    if kw.get("token_loss"):
        # the BOW route alone reaches rows of the table that no input holds
        # (the encoder's gradient is zero there)
        table = ref["mips_encoder.tok_emb.table"]
        unseen = np.setdiff1d(np.arange(512), np.concatenate(
            [batch["mips_input_ids"].ravel(), batch["query_input_ids"].ravel()]))
        assert np.abs(table[unseen]).max() > 0
        assert np.abs(_np(got["mips_encoder.tok_emb.table"])[unseen]).max() > 0


def test_gather_axis_raises():
    rcfg, jrcfg = _configs()
    _, model = _params(rcfg, jrcfg)
    batch = {k: _t(v) for k, v in _pairs(0, 2).items()}
    with pytest.raises(NotImplementedError, match="one device"):
        tcon.contrastive_loss(model, rcfg, batch, gather_axis="data")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["retriever_metrics", "retriever_metrics_fixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(name, seed):
    """Random hit matrices with rank-1 hits and rows with no hit: equal to
    the JAX package's within rtol 1e-6. The quirk-exact variant gives both
    a rank-1 hit and a row with no hit a reciprocal rank of 0."""
    rng = np.random.default_rng(seed)
    pred = rng.random((40, 10)) < 0.15
    pred[0] = False
    pred[1] = False
    pred[1, 0] = True
    pred[2, 3] = True
    counts = rng.integers(0, 4, 40).astype(np.int32)
    got = getattr(tmetrics, name)(torch.from_numpy(pred), torch.from_numpy(counts))
    ref = getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(counts))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    one = {k: float(v) for k, v in getattr(tmetrics, name)(
        torch.from_numpy(pred[:2]), torch.ones(2, dtype=torch.int32)).items()}
    # row 0 has no hit, row 1 a rank-1 hit
    assert one["reciprocal_rank"] == (0.0 if name == "retriever_metrics" else 0.5)


def test_hits_from_aids_matches_jax():
    rng = np.random.default_rng(3)
    aids = rng.integers(-1, 6, (5, 4, 3)).astype(np.int32)
    gold = rng.integers(0, 6, 5).astype(np.int32)
    np.testing.assert_array_equal(
        tmetrics.hits_from_aids(torch.from_numpy(aids), torch.from_numpy(gold)).numpy(),
        np.asarray(jmetrics.hits_from_aids(jnp.asarray(aids), jnp.asarray(gold))))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("pooling_dim", [None, 16])
def test_validate_retriever_matches_jax(metric, pooling_dim):
    """70 queries over 70 distinct positives (two batches of 64, the second
    padded): the same ranking and metrics as the JAX package, scores within
    rtol 1e-5 + atol 1e-5; the l2 route searches a 65-column (φ-augmented)
    index."""
    rcfg, jrcfg = _configs(pooling_dim=pooling_dim)
    jp, model = _params(rcfg, jrcfg, seed=4)
    pairs = _pairs(5, 70)
    corpus = {"token_ids": pairs["mips_input_ids"], "token_mask": pairs["mips_attention_mask"]}
    queries = {k: pairs[k] for k in ("query_input_ids", "query_attention_mask")}
    aids = np.arange(70, dtype=np.int32)[:, None]
    gold, counts = np.arange(70, dtype=np.int32), np.ones(70, np.int32)
    args = (rcfg.query_enc, rcfg.mips_enc, corpus, aids, queries, gold, counts)
    jargs = (jrcfg.query_enc, jrcfg.mips_enc, corpus, aids, queries, gold, counts)
    got, det = tvalidate.validate_retriever(model, *args, k=10, metric=metric,
                                            return_details=True)
    ref, jdet = jvalidate.validate_retriever(jp, *jargs, k=10, metric=metric,
                                             return_details=True)
    np.testing.assert_array_equal(det["indices"], jdet["indices"])
    np.testing.assert_array_equal(det["hits"], jdet["hits"])
    np.testing.assert_allclose(det["scores"], jdet["scores"], rtol=1e-5, atol=1e-5)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    emb = tvalidate.encode_texts(model.mips_encoder, rcfg.mips_enc, pairs["mips_input_ids"],
                                 pairs["mips_attention_mask"],
                                 proj=getattr(model, "mips_proj", None))
    jemb = jvalidate.encode_texts(jp["mips_encoder"], jrcfg.mips_enc, pairs["mips_input_ids"],
                                  pairs["mips_attention_mask"], proj=jp.get("mips_proj"))
    assert tuple(emb.shape) == (70, pooling_dim or 64)
    np.testing.assert_allclose(_np(emb), jemb, rtol=1e-5, atol=1e-5)


def _full_kb(pairs, rcfg, jrcfg, model, jp, monkeypatch=None, emb=None):
    """The full-KB validation of both packages → ((port metrics, details),
    JAX metrics). With ``emb`` = (positives [n, H], queries [n, H]), both
    packages' `encode_texts` return those embeddings instead of encoding."""
    if emb is not None:
        def fake(params, cfg, ids, mask, *a, **k):
            return emb[0] if ids.shape[1] == LM else emb[1]

        monkeypatch.setattr(tvalidate, "encode_texts",
                            lambda *a, **k: torch.from_numpy(fake(*a, **k).copy()))
        monkeypatch.setattr(jvalidate, "encode_texts", fake)
    got = cli._pretrain_full_kb_validation(model, rcfg, pairs, 10, return_details=True)
    ref = jcli._pretrain_full_kb_validation(jp, jrcfg, pairs, 10)
    return got, ref


def test_full_kb_validation_on_distinct_positives_equals_jax():
    """Every positive distinct: each class is one row, so the corrected
    gold is the JAX package's identity gold and the metrics are equal
    (rtol 1e-6)."""
    rcfg, jrcfg = _configs()
    jp, model = _params(rcfg, jrcfg, seed=6)
    pairs = _pairs(7, 50)
    assert len(set(cli.positive_classes(pairs).tolist())) == 50
    (got, _), ref = _full_kb(pairs, rcfg, jrcfg, model, jp)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("copies", ["equal", "apart"])
def test_full_kb_validation_corrects_the_gold_of_a_duplicated_positive(monkeypatch, copies):
    """Row 9's positive is a copy of row 5's (equal ids and mask), as the
    2000-example fixture's positives repeat: both rows get one class,
    counted as one document. The embeddings are exact in f32 (no roundoff
    in any order of summation): positive j is 4 e_j + (j / 32) e_63 and
    query i is 4 e_i + e_63 (query 9 equal to query 5), so query i scores
    its positive 16 + j / 32 and every other row j / 32. With ``equal``
    copies row 9's embedding is row 5's: the distinct-value search returns
    row 5 alone for both queries, which the JAX package's identity gold
    scores a miss for query 9 (recall and average precision 11/12,
    reciprocal rank 11/12). With copies ``apart`` (row 9 raised by 1/64 on
    e_63, as if the two had encoded apart) both rows come back, 9 then 5,
    and the class still counts once, at rank 1. Pinned in both: the class
    gold scores every query a rank-1 hit, so recall, average precision and
    reciprocal rank are 12/12."""
    rcfg, jrcfg = _configs()
    jp, model = _params(rcfg, jrcfg)
    pairs = _pairs(8, 12)
    for k in ("mips_input_ids", "mips_attention_mask"):
        pairs[k][9] = pairs[k][5]
    gold = cli.positive_classes(pairs)
    assert gold[9] == gold[5] and len(set(gold.tolist())) == 11
    pos = 4 * np.eye(12, 64, dtype=np.float32)
    pos[:, 63] = np.arange(12) / 32
    query = 4 * np.eye(12, 64, dtype=np.float32)
    query[:, 63] = 1
    pos[9], query[9] = pos[5], query[5]
    if copies == "apart":
        pos[9, 63] += 1 / 64
    (got, det), ref = _full_kb(pairs, rcfg, jrcfg, model, jp, monkeypatch, (pos, query))
    top = [5] if copies == "equal" else [9, 5]
    for i in (5, 9):
        assert det["indices"][i, :len(top)].tolist() == top
    assert det["hits"][:, 0].all() and det["hits"].sum() == 12
    for k in ("recall", "average_precision", "reciprocal_rank"):
        np.testing.assert_allclose(got[k], 1.0, rtol=1e-6, err_msg=k)
    if copies == "equal":
        for k in ("recall", "average_precision", "reciprocal_rank"):
            np.testing.assert_allclose(ref[k], 11 / 12, rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(token_loss=True), dict(pooling_dim=16)])
def test_retriever_train_steps_match_jax(kw):
    """Three `make_retriever_train_step` steps (AdamW with warmup, clip and
    a bf16 first moment, built as the JAX package's ``pretrain-retriever``
    builds it), each begun by both packages from the JAX trajectory's state:
    the metrics within rtol 1e-5 (`train_accuracy` equal), every gradient
    held to the two packages' own roundoff (`_check_grads`), and the port's parameters after the step
    within rtol = atol = 1e-6 of the JAX optimizer applied to the port's
    gradients."""
    rcfg, jrcfg = _configs(**kw)
    jp, model = _params(rcfg, jrcfg, seed=9)
    hyper = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=1.0, mu_dtype="bfloat16")
    jtx = joptim.build_optimizer(hyper["lr"], hyper["warmup_steps"], hyper["total_steps"],
                                 grad_clip=hyper["grad_clip"], mu_dtype=hyper["mu_dtype"])
    jstep = jtrainer.make_retriever_train_step(jrcfg, jtx)
    jupdate = jax.jit(jtx.update)
    jstate = jtrainer.TrainState.create(jp, jtx)
    ttx = toptim.build_optimizer(hyper["lr"], hyper["warmup_steps"], hyper["total_steps"],
                                 grad_clip=hyper["grad_clip"], mu_dtype=hyper["mu_dtype"])
    kept = _KeepGradients(ttx)
    tstep = ttrainer.make_retriever_train_step(rcfg, kept)
    tstate = ttrainer.TrainState.create(model, ttx)
    pairs = _pairs(10, 24)
    for i in range(3):
        sel = np.random.default_rng(i).choice(24, size=B, replace=False)
        batch = {k: v[sel] for k, v in pairs.items()}
        start = jax.tree_util.tree_map(jnp.array, jstate)  # the JAX step donates its state
        flat = _state_arrays(start)
        tckpt.load_params(model, flat)
        tstate.opt_state = ttx.load_state_arrays(model, flat)
        (_, _, jg), (_, _, jg64) = _jax_grads(start.params, jrcfg, batch)
        g64 = _port_grads(model, rcfg, batch, torch.float64)[2]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i}: {k}")
        assert float(tm["train_accuracy"]) == float(jm["train_accuracy"])
        g = kept.grads[-1]
        _check_grads(i, g, jg, g64, jg64)
        upd, _ = jupdate(_jax_tree(start.params, {n: _np(x) for n, x in g.items()}),
                         start.opt_state, start.params)
        ref = flatten_tree(optax.apply_updates(start.params, upd))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), ref[n], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i}: {n}")
    assert tstate.step == 3 and int(jstate.step) == 3


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def _cli_dict(tmp_path, tag):
    return {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64,
                  "query_enc": {"window": 16}, "mips_enc": {"window": 16},
                  "memory_enc": {"window": 16}},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16, "memory_len": 32,
                 "batch_size": 4},
        "retriever": {"token_loss": True, "eval_k": 5},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10, "grad_clip": 1.0},
        "max_steps": 3, "eval_every": 2,
        "ckpt_dir": str(tmp_path / tag / "ckpt"),
        "logging": {"log_dir": str(tmp_path / tag / "logs"), "run_name": "r"},
    }


def _rows(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def test_pretrain_retriever_train_test_predict_match_jax(tmp_path, monkeypatch):
    """``pretrain-retriever`` on 40 synthetic examples (distinct positives),
    3 steps with a validation after step 2 and at the end, from the same
    seeded JAX init in both packages (the port's `init_retriever` swapped
    for the JAX draw): the same batches, each step's loss and metrics
    within rtol 1e-4, each validation's metrics within rtol 1e-5, and the
    same output keys. The port's ``encoders.npz`` holds the weights of its
    best validation and loads in the JAX package's `import_encoders`;
    ``--mode test`` gives that validation's metrics; ``--mode predict``
    dumps one ranking per query whose hits give those metrics."""
    d = _cli_dict(tmp_path, "jax")
    jcfg = jconfig.config_from_dict(d)
    cfg = tconfig.config_from_dict(_cli_dict(tmp_path, "port"))
    jp0 = jcon.init_retriever(jax.random.PRNGKey(cfg.seed), jcon.RetrieverConfig(
        query_enc=jcfg.model.query_enc, mips_enc=jcfg.model.mips_enc,
        token_loss=True))
    monkeypatch.setattr(tcon, "init_retriever", lambda rcfg, gen, device=None:
                        load_jax_params(tcon.Retriever(rcfg), jp0))
    ref = jcli.run_pretrain_retriever(jcfg)
    report = {}
    got = cli.run_pretrain_retriever(cfg, device="cpu", report=report)
    assert set(got) == set(ref)
    gold = cli.positive_classes(report["pairs"])
    assert len(set(gold.tolist())) == len(gold)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    jrows = _rows(tmp_path / "jax" / "logs" / "r_retriever.metrics.jsonl")
    trows = _rows(tmp_path / "port" / "logs" / "r_retriever.metrics.jsonl")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [0, 1, 2, 2, 3]
    for jr, tr in zip(jrows, trows):
        assert set(jr) == set(tr)
        for k in jr:
            if k not in ("step", "time"):
                np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, err_msg=k)
    # the port's export: the weights of its best validation, which load in
    # the JAX package; --mode test scores them as that validation did
    assert report["export_step"] in (2, 3)
    path = str(tmp_path / "port" / "ckpt" / "encoders.npz")
    back = jckpt.import_encoders(path, jp0)
    for g in ("query_encoder", "mips_encoder"):
        for n, a in flatten_tree(back[g]).items():
            np.testing.assert_array_equal(a, _np(report["exported"][f"{g}.{n}"]), err_msg=n)
    test = cli.run_pretrain_retriever_test(cfg, device="cpu")
    assert test["n_queries"] == len(gold)
    best = report["val"][[2, 3].index(report["export_step"])]
    for k, v in best.items():
        assert test[f"test_{k}"] == v
    pred = cli.run_pretrain_retriever_predict(cfg, device="cpu")
    dump = json.load(open(tmp_path / "port" / "logs" / "retriever_predictions.json"))
    assert len(dump) == pred["n_queries"] == len(gold)
    hits = torch.tensor([r["hits"] for r in dump])
    recall = float(tmetrics.retriever_metrics_fixed(hits, torch.ones(len(dump)))["recall"])
    assert recall == pytest.approx(pred["recall"]) and pred["recall"] == test["test_recall"]


def test_pretrain_retriever_exports_hf_directories(tmp_path):
    """With ``retriever.hf_export`` the run ends by writing
    ``ckpt_dir/hf_query_encoder`` and ``hf_mips_encoder``, which read back
    (`load_encoder_from_pretrained`) into the final encoders exactly."""
    from retrieval_augmented_mds_tpu_torch.models.hf_import import (
        load_encoder_from_pretrained,
    )

    d = _cli_dict(tmp_path, "hf")
    d["retriever"]["hf_export"] = True
    d["max_steps"] = 1
    cfg = tconfig.config_from_dict(d)
    report = {}
    cli.run_pretrain_retriever(cfg, device="cpu", report=report)
    params = dict(report["state"].params.named_parameters())
    for g, enc in (("query_encoder", cfg.model.query_enc), ("mips_encoder", cfg.model.mips_enc)):
        tree = load_encoder_from_pretrained(str(tmp_path / "hf" / "ckpt" / f"hf_{g}"), enc)
        assert not tree.pop("type_emb")["table"].any()  # exported as a zero row
        for n, a in flatten_tree(tree).items():
            np.testing.assert_array_equal(a, _np(params[f"{g}.{n}"]), err_msg=n)


def test_pretrain_retriever_refuses_hf_export_without_transformers(tmp_path, monkeypatch):
    """``retriever.hf_export`` without ``transformers`` raises before the
    set-up and the first step, and writes nothing."""
    import builtins

    real = builtins.__import__

    def no_transformers(name, *a, **k):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("no transformers here")
        return real(name, *a, **k)

    d = _cli_dict(tmp_path, "nohf")
    d["retriever"]["hf_export"] = True
    cfg = tconfig.config_from_dict(d)
    monkeypatch.setattr(cli, "_pretrain_setup", lambda *a: pytest.fail("set-up ran"))
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="hf_export.*transformers"):
        cli.run_pretrain_retriever(cfg, device="cpu")
    assert not (tmp_path / "nohf").exists()


def test_pretrain_retriever_defaults_to_cuda(monkeypatch):
    """Every mode wants CUDA unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.config_from_dict({"model": {"preset": "tiny"}})
    for run in (cli.run_pretrain_retriever, cli.run_pretrain_retriever_test,
                cli.run_pretrain_retriever_predict):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(cfg)


def test_pretrain_retriever_from_main(tmp_path, capsys):
    """The command line: train, then test and predict on its export."""
    import yaml

    path = tmp_path / "r.yaml"
    d = _cli_dict(tmp_path, "main")
    d["max_steps"] = 1
    path.write_text(yaml.safe_dump(d))
    for mode in ("train", "test", "predict"):
        assert cli.main(["pretrain-retriever", "--mode", mode, "--config", str(path),
                         "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out
    assert (tmp_path / "main" / "ckpt" / "encoders.npz").exists()
    assert os.path.exists(tmp_path / "main" / "logs" / "retriever_predictions.json")
