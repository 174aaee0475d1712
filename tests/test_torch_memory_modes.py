"""Parity of the port's memory modes with the JAX package, on the CPU:
`rag_encode` under ``target_only``, ``target_in`` (copy-forcing flag
True, False and None, at ``copy_forcing`` 0 and 0.5) and dual memory
(``input_memory_ids``: counts of 0, 1 and at least k, fewer input documents
than k, and with ``retrieved_forcing``), each over a Flat store and over an
IVF store on its per-query route; ``target_in`` train steps against the JAX
train step with the flag; `run_fit`'s seeded flags; and `fit`, `validate`
and `predict` on the CPU in each mode.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny)
through `bridge.load_jax_params`; inputs are numpy arrays made from a seed.
Tolerances: f32 rtol=atol=1e-5 (summation order); ids, masks and the copy
sequence exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.index import ivf as jivf
from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.index import ivf as tivf
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_ivf import port_ivf
from tests.test_torch_models import _np, _t
from tests.test_torch_rag import LM, N, TOL, B, _batch, _setup, _stores
from tests.test_torch_train import (
    BF16_MU_HYPER,
    check_bf16_mu_state,
    steps_from_jax,
    target_memory,
)

torch.set_num_threads(1)
NPROBE = 4  # B * NPROBE = 8 < 16 clusters: the per-query route


@pytest.fixture(scope="module", autouse=True)
def _jax_per_query_route():
    """The JAX IVF search takes its per-query route (its kernel in interpret
    mode) in this module, as the port's does: the switch is read when
    `ivf_search` is traced, so its cache is cleared around the module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RAMDS_IVF_SERVING", "1")
    jivf.ivf_search.clear_cache()
    yield
    mp.undo()
    jivf.ivf_search.clear_cache()


def _ivf_stores(cfg, seed):
    """One IVF index (16 clusters, SQ8, no flat sibling) built by the JAX
    package over the Flat stores' corpus, in both packages' stores."""
    jflat, tflat = _stores(cfg, seed)
    emb = np.random.default_rng(seed).standard_normal(
        (N, cfg.query_enc.d_model)).astype(np.float32)  # `_stores`' draw
    j = jivf.build_ivf_index(emb, 16, dtype="int8", seed=4, keep_flat=False)
    jstore = jrag.MemoryStore(index=j, token_ids=jflat.token_ids[:N],
                              token_mask=jflat.token_mask[:N], nprobe=NPROBE)
    tstore = trag.MemoryStore(index=port_ivf(j), token_ids=tflat.token_ids,
                              token_mask=tflat.token_mask, nprobe=NPROBE)
    assert tivf.ivf_route(tstore.index, B, cfg.mips_topk, NPROBE, 8) == "per_query"
    return jstore, tstore


def _dual_memory(cfg, d_in, counts, seed):
    """input_memory_ids/mask [B, d_in, LM] and input_memory_count [B], as the
    data pipeline lays them out (documents past the count all padding)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.mips_enc.vocab_size, (B, d_in, LM)).astype(np.int32)
    ids[:, :, 0] = cfg.mips_enc.bos_id
    mask = np.ones((B, d_in, LM), np.int32)
    mask[:, :, 45:] = rng.integers(0, 2, (B, d_in, 1))
    counts = np.asarray(counts, np.int32)
    mask[np.arange(d_in)[None, :] >= counts[:, None]] = 0
    ids[mask == 0] = cfg.mips_enc.pad_id
    return {"input_memory_ids": ids, "input_memory_mask": mask,
            "input_memory_count": counts}


# (name, model config, copy_force, dual memory (d_in, counts) or None)
CASES = [
    ("target_only", dict(memory_forcing="target_only"), None, None),
    ("target_in_forced", dict(memory_forcing="target_in", copy_forcing=0.5), True, None),
    ("target_in_unforced", dict(memory_forcing="target_in", copy_forcing=0.5), False, None),
    ("target_in_default_0.5", dict(memory_forcing="target_in", copy_forcing=0.5), None, None),
    ("target_in_default_0", dict(memory_forcing="target_in", copy_forcing=0.0), None, None),
    ("target_in_forced_0", dict(memory_forcing="target_in", copy_forcing=0.0), True, None),
    ("target_in_unforced_0", dict(memory_forcing="target_in", copy_forcing=0.0), False, None),
    ("dual_counts_0_1", {}, None, (3, [0, 1])),
    ("dual_counts_at_least_k", {}, None, (3, [2, 3])),
    ("dual_fewer_docs_than_k", {}, None, (1, [1, 0])),
    ("dual_retrieved_forcing", dict(memory_forcing="retrieved_forcing"), None, (3, [1, 0])),
]


@pytest.mark.parametrize("store", ["flat", "ivf"])
@pytest.mark.parametrize("name,kw,force,dual", CASES, ids=[c[0] for c in CASES])
def test_memory_modes_encode_like_jax(store, name, kw, force, dual):
    """`rag_encode` of both packages on the same parameters, store and
    batch: equal retrieved ids (None under ``target_only``), memory masks
    and copy sequences; memory, its bias, the rescoring scores, the search
    scores and the encoder states within TOL. The slot layout is checked
    against the batch too: the target slot first (masked off when the flag
    is off), input documents before retrieved rows."""
    cfg, jcfg, jp, model = _setup(seed=7, **kw)
    jstore, tstore = (_stores if store == "flat" else _ivf_stores)(cfg, 7)
    batch = _batch(cfg, 8)
    batch.update(target_memory(cfg, 9))
    if dual is not None:
        batch.update(_dual_memory(cfg, *dual, seed=10))
    jforce = None if force is None else jnp.asarray(force)
    jenc = jrag.rag_encode(jp, jcfg, jstore, {k: jnp.asarray(v) for k, v in batch.items()},
                           copy_force=jforce)
    tenc = trag.rag_encode(model, cfg, tstore, {k: _t(v) for k, v in batch.items()},
                           copy_force=force)

    if cfg.memory_forcing == "target_only":
        assert tenc.retrieved_idx is None and jenc.retrieved_idx is None
        assert tenc.faiss_scores is None and jenc.faiss_scores is None
    else:
        np.testing.assert_array_equal(tenc.retrieved_idx.numpy(),
                                      np.asarray(jenc.retrieved_idx))
        np.testing.assert_allclose(_np(tenc.faiss_scores), np.asarray(jenc.faiss_scores),
                                   **TOL)
    for f in ("memory", "memory_bias", "mips_scores", "enc_hidden", "query_cls"):
        np.testing.assert_allclose(_np(getattr(tenc, f)), np.asarray(getattr(jenc, f)),
                                   err_msg=f, **TOL)
    for f in ("memory_mask", "copy_seq"):
        np.testing.assert_array_equal(getattr(tenc, f).numpy(), np.asarray(getattr(jenc, f)),
                                      err_msg=f)

    slots = tenc.copy_seq.numpy().reshape(B, -1, LM)
    masks = tenc.memory_mask.numpy().reshape(B, -1, LM)
    assert slots.shape[1] == (1 if name == "target_only" else cfg.memory_slots)
    if cfg.memory_forcing in ("target_only", "target_in"):
        np.testing.assert_array_equal(slots[:, 0], batch["target_memory_ids"])
        on = force if force is not None else cfg.copy_forcing > 0
        assert masks[:, 0].any() == bool(on or name == "target_only")
    if dual is not None:
        d_in, counts = dual
        rows = tenc.retrieved_idx.numpy()
        for i in range(B):
            for j in range(cfg.mips_topk):
                want = (batch["input_memory_ids"][i, min(j, d_in - 1)] if j < counts[i]
                        else tstore.token_ids[rows[i, max(j - counts[i], 0)]].numpy())
                np.testing.assert_array_equal(slots[i, j], want, err_msg=f"{i}, {j}")


@pytest.mark.parametrize("forces", [(True, False, True), (None, None, None)],
                         ids=["flags", "default"])
def test_target_in_train_steps_match_jax(forces):
    """Three ``target_in`` train steps (copy_forcing 0.5), each given its
    flag (True, False, True; or None, which reads copy_forcing > 0), held
    to the JAX train step given the same flag as `test_train_steps_match_jax`
    holds the standing steps (`steps_from_jax`): every metric, each
    gradient leaf to the two packages' own roundoff, the update and the
    optimizer state from the same point, and a free-running copy's loss.

    One leaf gets its own ``rel``: the copy head's scalar ``beta``, which
    scales the retrieval score on every copy-attention logit. Its gradient
    sums B·T·nh·M = 12288 products of a logit's cotangent and its slot's
    score; the cotangents sum to zero over each softmax row, so the sum
    cancels to 1/590-1/4300 of the sum of its terms' magnitudes (measured
    on this test's first step, forced and not). Both packages form those
    logits in f32 in their f64 runs as well (f32 casts of q, k and the
    scores), so neither run's own roundoff sees the f32 roundings of the
    terms, up to 2^-24 of that magnitude sum: 2^-24 x 4300 x 4 (the other
    leaves' factor 3, and a margin) ~ 2^-10 of the leaf."""
    cfg = steps_from_jax(11, BF16_MU_HYPER, dict(weight_decay=0.01, grad_clip=1.0),
                         check_bf16_mu_state,
                         model_kw=dict(memory_forcing="target_in", copy_forcing=0.5),
                         copy_force=forces, rel_of={"copy_head.layers.0.beta": 2.0 ** -10})[0]
    assert cfg.memory_slots == cfg.mips_topk + 1


def _tiny_config(tmp_path, **model):
    return tconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64, **model},
        "data": {"source": "synthetic", "n_synthetic": 48, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 32, "memory_len": 64,
                 "batch_size": 4},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
        "max_steps": 6, "eval_every": 0, "seed": 3,
        "logging": {"log_dir": str(tmp_path / "logs"), "run_name": "t"},
    })


def test_run_fit_draws_copy_force_per_step_and_resumes(tmp_path):
    """`run_fit` under ``target_in`` gives step s the flag
    ``default_rng([seed, s]).random() < copy_forcing`` (both values occur in
    the 6 steps), and a run resumed from a checkpoint at step 3 draws the
    flags of steps 3-5 again, with the uninterrupted run's losses. Without
    ``target_in`` the flag is None."""
    cfg = _tiny_config(tmp_path, memory_forcing="target_in", copy_forcing=0.5)
    want = [bool(np.random.default_rng([cfg.seed, s]).random() < 0.5) for s in range(6)]
    assert True in want and False in want
    whole = {}
    cli.run_fit(cfg, device="cpu", report=whole)
    assert whole["copy_force"] == want

    ckpt = str(tmp_path / "ckpt")
    first, resumed = {}, {}
    cli.run_fit(dataclasses.replace(cfg, max_steps=3, ckpt_dir=ckpt), device="cpu",
                report=first)
    cli.run_fit(dataclasses.replace(cfg, ckpt_dir=ckpt), device="cpu", report=resumed)
    assert first["copy_force"] + resumed["copy_force"] == want
    np.testing.assert_allclose(first["losses"] + resumed["losses"], whole["losses"],
                               rtol=1e-5)

    plain = {}
    cli.run_fit(dataclasses.replace(_tiny_config(tmp_path), max_steps=2), device="cpu",
                report=plain)
    assert plain["copy_force"] == [None, None]


@pytest.mark.parametrize("mode", ["target_only", "target_in", "dual"])
def test_fit_validate_predict_run_in_each_mode(tmp_path, mode):
    """`fit` (2 steps and an eval of one batch), `validate` and `predict` on
    the CPU over the committed fixture, in each memory mode: finite losses,
    a ROUGE score, one prediction per example, and the memory the mode
    lays out (one target slot; k + 1 slots; k slots holding the batch's
    first input documents)."""
    model = {"dual": {}, "target_only": {"memory_forcing": "target_only"},
             "target_in": {"memory_forcing": "target_in", "copy_forcing": 0.5}}[mode]
    cfg = tconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64, **model},
        "data": {"source": "fixture", "max_length": 128, "query_max_length": 64,
                 "decoder_max_length": 32, "memory_len": 64, "batch_size": 4,
                 "dataset_mode": "dual" if mode == "dual" else "original"},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
        "max_steps": 2, "eval_every": 2, "eval_max_batches": 1, "seed": 0,
        "logging": {"log_dir": str(tmp_path / "logs"), "run_name": mode},
    })
    rep = {}
    out = cli.run_fit(cfg, device="cpu", report=rep)
    assert out["steps"] == 2 and all(np.isfinite(rep["losses"]))
    assert (rep["retrieved"] == []) == (mode == "target_only")
    ev = cli.run_validate(cfg, device="cpu")
    assert 0.0 <= ev["rouge1"] <= 100.0
    pred = {}
    res = cli.run_predict(cfg, device="cpu", report=pred)
    assert len(res["predictions"]) == cfg.data.batch_size
    enc, batch = pred["enc"], pred["batch"]
    slots = enc.copy_seq.reshape(cfg.data.batch_size, -1, 64)
    if mode == "target_only":
        assert enc.retrieved_idx is None
        assert torch.equal(slots[:, 0], batch["target_memory_ids"])
    elif mode == "target_in":
        assert slots.shape[1] == 3 and torch.equal(slots[:, 0], batch["target_memory_ids"])
    else:
        count = batch["input_memory_count"]
        assert slots.shape[1] == 2 and bool((count > 0).all())
        assert torch.equal(slots[:, 0], batch["input_memory_ids"][:, 0])
