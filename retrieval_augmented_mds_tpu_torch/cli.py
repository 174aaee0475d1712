"""Command-line entry point of the port:

    python -m retrieval_augmented_mds_tpu_torch.cli \
        {fit,validate,test,predict,pretrain-retriever,build-index,bench-index} \
        --config <yaml> [--index DIR] [--out DIR] [--mode train|test|predict] \
        [--device cuda|cpu]

The subcommands do what the JAX package's ``run_fit``, ``run_validate``,
``run_predict`` and ``run_pretrain_retriever*`` do, on one device:

* ``fit``: build the data and the parameters (seeded, with the pretrained
  weights the config names loaded over them: ``*_weights`` and
  ``encoder_state_path``, `models.hf_import`), resume from
  ``ckpt_dir/latest.json`` when there is one, build the memory store, and
  take ``max_steps`` train steps, refreshing the store every
  ``index.rebuild_every`` steps, evaluating every ``eval_every`` steps and
  checkpointing as the reference does. Metrics go to
  ``<log_dir>/<run_name>.metrics.jsonl``, the resolved config to
  ``<log_dir>/config_resolved.yaml``. A config that sets ``baseline``, a
  ``mesh`` over more than one device or ``logging.teams_webhook`` raises:
  those parts are not ported yet.
* ``validate`` / ``test``: generate over the whole val / test split and
  score it with ROUGE, from the checkpoint ``best.json`` marks (else
  ``latest.json``) when ``ckpt_dir`` has one.
* ``predict``: generate for the first batch of the test split.
* ``pretrain-retriever``: contrastive pretraining of the query and mips
  encoders on the config's positive pairs (``--mode train``), exporting
  ``ckpt_dir/encoders.npz``, the file ``model.encoder_state_path`` reads;
  ``--mode test`` scores that file over the full pair corpus, ``--mode
  predict`` dumps its per-query ranking.
* ``build-index``: embed the corpus, build the configured index and save
  it with the tokenized corpus (``corpus_tokens.npz``) under ``--out``, in
  the JAX package's layout; ``--index DIR`` loads such a directory.
* ``bench-index``: flat and IVF index build times and recall@10 on a
  seeded Gaussian-mixture corpus shaped like the config.

Serving runs under ``torch.no_grad()``. Everything runs on CUDA by default
and raises when CUDA is missing, unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

_BATCH_KEYS = ("input_ids", "attention_mask", "query_input_ids",
               "query_attention_mask", "mips_ignore")
# what a train or eval batch carries to the device (the reference's
# _device_batch); decoder_input_ids are derived from the labels
_TRAIN_KEYS = _BATCH_KEYS + (
    "labels", "gold_aid", "aid_counts", "target_memory_ids", "target_memory_mask",
    "input_memory_ids", "input_memory_mask", "input_memory_count",
)


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU"
        )
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32


def build_data(cfg):
    """The host data pipeline (pandas): the module, and the tokenizer."""
    from .data import (
        RAGDataModule,
        aggregate_by_aid,
        load_fixture,
        load_multi_x_science,
        load_tokenizer,
        synthetic_multi_x_science,
    )

    d = cfg.data
    if d.source == "synthetic":
        df = synthetic_multi_x_science(d.n_synthetic)
    elif d.source == "fixture" or d.source.endswith((".json", ".json.gz")):
        df = load_fixture(None if d.source == "fixture" else d.source)
    else:
        import pandas as pd

        hf = load_multi_x_science(
            d.source if d.source != "multi_x_science" else "multi_x_science_sum"
        )
        df = pd.concat([v.to_pandas() for v in hf.values()], ignore_index=True)
    if d.dataset_mode == "aggregated":
        df = aggregate_by_aid(df)
    tok = load_tokenizer(d.tokenizer, vocab_size=cfg.model.led.vocab_size,
                         doc_sep=d.doc_sep, fallback=d.tokenizer_fallback)
    qtok = load_tokenizer(d.tokenizer, vocab_size=cfg.model.query_enc.vocab_size,
                          doc_sep=d.doc_sep, fallback=d.tokenizer_fallback)
    dm = RAGDataModule(
        df, tok, qtok, corpus_column=d.corpus_column,
        mips_dataset=d.mips_dataset, arxiv_path=d.mips_arxiv_path,
        max_length=d.max_length, query_max_length=d.query_max_length,
        decoder_max_length=d.decoder_max_length, memory_len=d.memory_len,
        source_memory=d.source_memory, doc_sep=d.doc_sep,
        dual_memory=d.dataset_mode == "dual", cache_dir=d.cache_dir,
    ).prepare()
    if d.mips_db_max_size:
        for k in dm.store_arrays:
            dm.store_arrays[k] = dm.store_arrays[k][: d.mips_db_max_size]
    return dm, tok


def build_params(cfg, device: torch.device):
    """The seeded init, drawn on the CPU and then moved (one seed gives the
    same weights on every device, so a CPU run is a reference for a CUDA
    run), with the pretrained weights the config names loaded over it."""
    from .models.retriever_generator import init_rag_pretrained

    return init_rag_pretrained(cfg.model, torch.Generator().manual_seed(cfg.seed)).to(device)


def build_store(params, cfg, dm, device: torch.device):
    from .train.trainer import build_memory_store

    arr = dm.store_arrays
    aids = arr.get("row_aids")
    return build_memory_store(
        params, cfg.model, cfg.index,
        token_ids=torch.from_numpy(arr["token_ids"]).to(device),
        token_mask=torch.from_numpy(arr["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
        seed=cfg.seed, compute_dtype=compute_dtype(cfg),
    )


def load_store(index_dir: str, cfg, device: torch.device):
    """A MemoryStore from a persisted ``build-index`` directory (either
    package's, flat or IVF), with no re-embedding; ``cfg.index.nprobe``
    sets the probe width."""
    from .index import load_index
    from .models.retriever_generator import MemoryStore

    tok = np.load(os.path.join(index_dir, "corpus_tokens.npz"))
    aids = tok["row_aids"] if "row_aids" in tok.files else None
    return MemoryStore(
        index=load_index(index_dir, device=device),
        token_ids=torch.from_numpy(tok["token_ids"]).to(device),
        token_mask=torch.from_numpy(tok["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
        nprobe=cfg.index.nprobe,
    )


def device_batch(host: dict, cfg, device: torch.device) -> dict[str, torch.Tensor]:
    """Host batch → device tensors, with the teacher-forcing decoder inputs."""
    from .models.led import shift_tokens_right

    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in host.items() if k in _TRAIN_KEYS}
    out["decoder_input_ids"] = shift_tokens_right(
        out["labels"], cfg.model.led.pad_id, cfg.generation.decoder_start_id)
    return out


def build_tx(cfg, params):
    """The one optimizer construction: ``fit`` and every command that loads
    a train state must build the same one, or its state will not load."""
    from .train.optimizer import build_optimizer

    t = cfg.train
    return build_optimizer(
        t.lr, t.warmup_steps, t.total_steps, weight_decay=t.weight_decay,
        grad_clip=t.grad_clip,
        frozen_groups=tuple(t.frozen_groups) + cfg.model.frozen_groups(),
        accumulate_steps=t.accumulate_steps, mu_dtype=t.adam_mu_dtype,
        state_8bit=t.adam_8bit,
    )


def check_fit_config(cfg) -> None:
    """Raise on what ``fit`` does not run yet, rather than train something
    else without a word."""
    if cfg.baseline:
        raise NotImplementedError(
            f"baseline {cfg.baseline!r}: the baselines (models/bart.py, models/t5.py, "
            "run_fit_baseline) are not ported yet (ROADMAP queue 1, item 8)"
        )
    if max(cfg.mesh.data or 0, cfg.mesh.shard or 0) > 1:
        raise NotImplementedError(
            f"mesh data={cfg.mesh.data} shard={cfg.mesh.shard}: training over several "
            "devices is not ported yet (ROADMAP queue 1, item 9); leave both unset or "
            "at most 1"
        )
    if cfg.logging.teams_webhook:
        raise NotImplementedError(
            "logging.teams_webhook: TeamsNotifier is not ported yet (ROADMAP queue 1, "
            "item 10); unset it"
        )


def run_fit(cfg, *, device: str = "cuda", report: dict[str, Any] | None = None
            ) -> dict[str, Any]:
    """Train for ``cfg.max_steps`` steps → the last step's metrics and
    ``steps``. With ``report``, also fills in per-step wall times (seconds,
    synchronised) and phase times, the losses, each step's retrieved row
    ids, the store builds' and refreshes' times, and the objects the run
    made. The resolved config goes to ``<log_dir>/config_resolved.yaml``."""
    from .obs import MetricsLogger
    from .train.trainer import TrainState, make_train_step, refresh_store
    from .utils.checkpoint import load_train_state, mark_best, save_train_state
    from .utils.config import save_config

    check_fit_config(cfg)
    dev = resolve_device(device)
    dm, tok = build_data(cfg)
    params = build_params(cfg, dev)
    tx = build_tx(cfg, params)
    state = TrainState.create(params, tx)
    start_step = 0
    if cfg.ckpt_dir and os.path.exists(os.path.join(cfg.ckpt_dir, "latest.json")):
        state, start_step = load_train_state(cfg.ckpt_dir, state, tx)
        print(f"resumed from step {start_step}")
    dtype = compute_dtype(cfg)
    t0 = time.perf_counter()
    # built from the current (possibly resumed) weights, as the reference
    store = None if cfg.model.mips_disabled else build_store(state.params, cfg, dm, dev)
    _sync(dev)
    rep = report if report is not None else {}
    rep.update(store_s=time.perf_counter() - t0, step_s=[], phase_s=[], losses=[],
               refresh_s=[], retrieved=[])
    step_fn = make_train_step(cfg.model, tx, cfg.train, dtype=dtype,
                              remat=cfg.train.remat,
                              phase_times=rep["phase_s"] if report is not None else None,
                              retrieved=rep["retrieved"] if report is not None else None)

    log = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name,
                        tensorboard=cfg.logging.tensorboard, mlflow=cfg.logging.mlflow)
    log.log_hyperparams(dataclasses.asdict(cfg))
    save_config(cfg, os.path.join(cfg.logging.log_dir, "config_resolved.yaml"))
    step, metrics, best_rouge1 = start_step, {}, -1.0
    # a resumed run starts "saved" at start_step
    last_saved = start_step if start_step else -1
    # the batch order is a function of (seed, step): epoch e shuffles with
    # seed + e, so a resumed run re-enters the same permutation
    steps_per_epoch = max(1, len(dm.split_indices("train")) // cfg.data.batch_size)
    try:
        while step < cfg.max_steps:
            epoch, skip = divmod(step, steps_per_epoch)
            for bi, batch in enumerate(dm.batches(cfg.data.batch_size,
                                                  seed=cfg.seed + epoch, split="train")):
                if bi < skip:
                    continue
                if step >= cfg.max_steps:
                    break
                if (store is not None and cfg.index.rebuild_every > 0 and step > 0
                        and step % cfg.index.rebuild_every == 0):
                    t0 = time.perf_counter()
                    store = refresh_store(state.params, cfg.model, store,
                                          index_cfg=cfg.index, dtype=dtype,
                                          seed=cfg.seed)
                    _sync(dev)
                    rep["refresh_s"].append(time.perf_counter() - t0)
                dbatch = device_batch(batch, cfg, dev)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, store, dbatch)
                loss = float(metrics["loss"])  # waits for the device
                sec = time.perf_counter() - t0
                rep["step_s"].append(sec)
                rep["losses"].append(loss)
                metrics["steps_per_s"] = 1.0 / max(sec, 1e-9)
                metrics["tokens_per_s"] = dbatch["input_ids"].numel() / max(sec, 1e-9)
                log.log(step, metrics)
                step += 1
                if cfg.ckpt_dir and cfg.train.save_every and step % cfg.train.save_every == 0:
                    save_train_state(cfg.ckpt_dir, state, tx, step)
                    last_saved = step
                if cfg.eval_every and step % cfg.eval_every == 0:
                    ev = run_eval_loop(cfg, state.params, store, dm, tok,
                                       max_batches=cfg.eval_max_batches, device=dev)
                    log.log(step, ev, prefix="val_")
                    # keep the checkpoint of the best rouge1
                    if cfg.ckpt_dir and ev.get("rouge1", 0) > best_rouge1:
                        best_rouge1 = ev["rouge1"]
                        path = save_train_state(cfg.ckpt_dir, state, tx, step)
                        mark_best(cfg.ckpt_dir, step, path, best_rouge1)
                        last_saved = step
        if cfg.ckpt_dir and last_saved != step:
            save_train_state(cfg.ckpt_dir, state, tx, step)
    finally:
        log.close()
    rep.update(state=state, store=store, tx=tx)
    out = {k: float(v) for k, v in metrics.items()}
    out["steps"] = step
    return out


def run_eval_loop(cfg, params, store, dm, tok, max_batches: int | None = None,
                  dump_name: str | None = None, split: str = "val", *,
                  device: torch.device) -> dict[str, float]:
    """Generate for every batch of ``split`` (at most ``max_batches``) and
    score the outputs with ROUGE; with ``dump_name``, also write them to
    ``<log_dir>/<dump_name>.json``. Runs without autograd. The ragged last
    batch is padded to ``data.batch_size`` with copies of its first row and
    only its real rows are scored, as the JAX package does: the batch size
    picks the IVF search's route, so a smaller batch could retrieve other
    rows."""
    from .eval import RougeAccumulator
    from .models.generate import generate
    from .models.retriever_generator import rag_encode

    dtype = compute_dtype(cfg)
    acc = RougeAccumulator()
    outputs = []
    with torch.no_grad():
        for bi, batch in enumerate(dm.batches(cfg.data.batch_size, shuffle=False,
                                              drop_last=False, split=split)):
            if max_batches is not None and bi >= max_batches:
                break
            n_real = len(batch["input_ids"])
            if n_real < cfg.data.batch_size:
                reps = cfg.data.batch_size - n_real
                batch = {k: np.concatenate([v, np.repeat(v[:1], reps, axis=0)])
                         for k, v in batch.items()}
            dbatch = device_batch(batch, cfg, device)
            enc = rag_encode(params, cfg.model, store, dbatch, dtype=dtype)
            ids = generate(params, cfg.model, enc, cfg.generation, dtype=dtype)
            preds = tok.batch_decode(ids.cpu().numpy())[:n_real]
            refs = tok.batch_decode(np.asarray(batch["labels"]))[:n_real]
            acc.add_batch(preds, refs)
            outputs.extend({"prediction": p, "reference": r} for p, r in zip(preds, refs))
    if dump_name:
        from .obs import MetricsLogger

        logger = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name)
        logger.dump_outputs(dump_name, outputs)
        logger.close()
    return acc.compute()


def run_validate(cfg, split: str = "val", index_dir: str | None = None, *,
                 device: str = "cuda") -> dict[str, float]:
    """ROUGE over the whole ``split``, from the checkpoint of ``ckpt_dir``
    (the best-marked one, else the latest) when there is one."""
    from .utils.checkpoint import checkpoint_path, load_arrays, load_params

    dev = resolve_device(device)
    dm, tok = build_data(cfg)
    params = build_params(cfg, dev)
    if cfg.ckpt_dir and os.path.exists(os.path.join(cfg.ckpt_dir, "latest.json")):
        load_params(params, load_arrays(checkpoint_path(cfg.ckpt_dir, prefer="best")))
    if cfg.model.mips_disabled:
        store = None
    elif index_dir:
        store = load_store(index_dir, cfg, dev)
    else:
        store = build_store(params, cfg, dm, dev)
    return run_eval_loop(cfg, params, store, dm, tok,
                         dump_name=f"{split}_outputs_{int(time.time())}", split=split,
                         device=dev)


def run_predict(cfg, index_dir: str | None = None, *, device: str = "cuda",
                report: dict[str, Any] | None = None) -> dict[str, Any]:
    """Predictions for the first test batch. With ``report``, also fills in the
    wall times (seconds, synchronised) of the store build, `rag_encode` and
    `generate`, and the objects they produced."""
    from .models.generate import copy_trace, generate
    from .models.retriever_generator import rag_encode

    dev = resolve_device(device)
    dm, tok = build_data(cfg)
    params = build_params(cfg, dev)
    t0 = time.perf_counter()
    if cfg.model.mips_disabled:
        store = None
    elif index_dir:
        store = load_store(index_dir, cfg, dev)
    else:
        store = build_store(params, cfg, dm, dev)
    _sync(dev)
    t1 = time.perf_counter()
    # the first batch of the held-out test split (the JAX package's
    # run_predict draws from the unsplit set, train examples included)
    host = next(dm.batches(cfg.data.batch_size, shuffle=False, split="test",
                           drop_last=False))
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in _BATCH_KEYS if k in host}
    dtype = compute_dtype(cfg)
    with torch.no_grad():
        enc = rag_encode(params, cfg.model, store, batch, dtype=dtype)
    _sync(dev)
    t2 = time.perf_counter()
    ids = generate(params, cfg.model, enc, cfg.generation, dtype=dtype)
    _sync(dev)
    t3 = time.perf_counter()
    out: dict[str, Any] = {"predictions": tok.batch_decode(ids.cpu().numpy())}
    if cfg.generation.output_copy_probs and store is not None:
        out["copy_traces"] = copy_trace(params, cfg.model, enc, ids)
    if report is not None:
        report.update(store_s=t1 - t0, encode_s=t2 - t1, generate_s=t3 - t2,
                      params=params, store=store, batch=batch, enc=enc, ids=ids)
    return out


def run_build_index(cfg, out_dir: str, *, device: str = "cuda") -> dict[str, Any]:
    """Embed the corpus, build the configured index and save it, with the
    tokenized corpus, in the JAX package's layout (either package loads
    it with ``--index``)."""
    from .index import save_index

    dev = resolve_device(device)
    dm, _ = build_data(cfg)
    store = build_store(build_params(cfg, dev), cfg, dm, dev)
    save_index(store.index, out_dir)
    arrays = {"token_ids": store.token_ids.cpu().numpy(),
              "token_mask": store.token_mask.cpu().numpy()}
    if store.row_aids is not None:
        arrays["row_aids"] = store.row_aids.cpu().numpy()
    np.savez(os.path.join(out_dir, "corpus_tokens.npz"), **arrays)
    return {"n": store.index.n, "out": out_dir}


def gaussian_mixture(n: int, d: int, b: int, seed: int):
    """The index benchmark's corpus and queries (numpy, from ``seed``; the
    draws of the JAX package's ``bench-index``): an anisotropic Gaussian
    mixture with power-law component masses, since encoder embeddings are
    strongly clustered and isotropic noise flatters IVF recall, and
    queries that are perturbed corpus rows → (x [n, d], q [b, d]) f32."""
    rng = np.random.default_rng(seed)
    n_comp = max(32, n // 512)
    centers = 3.0 * rng.standard_normal((n_comp, d)).astype(np.float32)
    w = 1.0 / np.arange(1, n_comp + 1)
    comp = rng.choice(n_comp, size=n, p=w / w.sum())
    scales = (0.5 + rng.random((n_comp, d))).astype(np.float32)
    x = centers[comp] + scales[comp] * rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    return x, q


def recall(ids: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of the reference's ids found in ``ids``, row by row."""
    ids, ref = ids.cpu().tolist(), ref.cpu().tolist()
    return sum(len(set(a) & set(r)) for a, r in zip(ids, ref)) / max(1, sum(map(len, ref)))


def run_bench_index(cfg, *, device: str = "cuda") -> dict[str, Any]:
    """Index build times and recall@10 of the flat and IVF indexes (64
    queries) on `gaussian_mixture` data of ``data.mips_db_max_size`` rows
    (65536 by default) at the mips encoder's width. Recall is against an
    exact top-10 over the f32 corpus by the plain MIPS search on the CPU;
    the IVF queries go in batches of 4, so that B·nprobe < C and the
    probed route runs (a batch of 64 would scan every cluster). Times are
    host seconds with the device synchronised."""
    from .index import build_flat_index, build_ivf_index, ivf_search, search
    from .ops.mips_topk import mips_topk_plain

    dev = resolve_device(device)
    n = cfg.data.mips_db_max_size or 65536
    d = cfg.model.mips_enc.d_model
    b, k = 64, 10
    x, q = gaussian_mixture(n, d, b, cfg.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    out: dict[str, Any] = {"n": n, "d": d, "device": str(dev)}

    t0 = time.perf_counter()
    flat = build_flat_index(x, dtype=dtype, device=dev)
    _sync(dev)
    out["flat_build_s"] = round(time.perf_counter() - t0, 3)
    nc = min(256, max(1, n // 64))
    # keep_flat=False: the recall below measures the probed routes (with the
    # flat sibling, B·nprobe >= C batches are exact flat searches)
    for name in ("ivf_build_cold_s", "ivf_rebuild_warm_s"):
        t0 = time.perf_counter()
        ivf = build_ivf_index(x, nc, dtype=dtype, train_size=min(n, 16384), iters=5,
                              keep_flat=False, device=dev)
        _sync(dev)
        out[name] = round(time.perf_counter() - t0, 3)

    _, ref = mips_topk_plain(torch.from_numpy(q), torch.from_numpy(x), k)
    qt = torch.from_numpy(q).to(dev)
    out["flat_recall"] = round(recall(search(flat, qt, k=k)[1], ref), 4)
    for nprobe in (8, 32):
        ids = torch.cat([ivf_search(ivf, qt[i:i + 4], k=k, nprobe=nprobe)[1]
                         for i in range(0, b, 4)])
        out[f"ivf_recall_nprobe{nprobe}"] = round(recall(ids, ref), 4)
    return out


def _pretrain_setup(cfg, device: torch.device):
    """Shared set-up of ``pretrain-retriever`` (train, test and predict):
    the retriever config, the seeded dual encoder (drawn on the CPU, then
    moved) with the pretrained encoders the config names loaded under the
    load policy, and the tokenized positive pairs."""
    from .data import load_tokenizer, synthetic_multi_x_science
    from .data.pipeline import prepare_pretrain_pairs
    from .models.hf_import import encoder_from_tree, load_encoder_from_pretrained, load_with_policy
    from .retriever.contrastive import RetrieverConfig, init_retriever

    rcfg = RetrieverConfig(
        query_enc=cfg.model.query_enc, mips_enc=cfg.model.mips_enc,
        temperature=cfg.retriever.temperature, pooling_dim=cfg.retriever.pooling_dim,
        token_loss=cfg.retriever.token_loss)
    params = init_retriever(rcfg, torch.Generator().manual_seed(cfg.seed))
    for field, group, enc_cfg in (("query_encoder_weights", "query_encoder", rcfg.query_enc),
                                  ("mips_encoder_weights", "mips_encoder", rcfg.mips_enc)):
        module = load_with_policy(
            field, getattr(cfg.model, field), group,
            lambda n, c=enc_cfg: encoder_from_tree(load_encoder_from_pretrained(
                n, c, adapter_name=cfg.model.adapter_name), c))
        if module is not None:
            setattr(params, group, module)
    params = params.to(device)

    if cfg.data.source == "synthetic":
        df = synthetic_multi_x_science(cfg.data.n_synthetic)
    else:
        df = build_data(cfg)[0].df
    tok = load_tokenizer(cfg.data.tokenizer, vocab_size=cfg.model.query_enc.vocab_size,
                         fallback=cfg.data.tokenizer_fallback)
    pairs = prepare_pretrain_pairs(
        df, tok, tok, mode=cfg.retriever.pair_mode,
        query_max_length=cfg.data.query_max_length, mips_max_length=cfg.data.memory_len,
        seed=cfg.seed)
    return rcfg, params, pairs


def positive_classes(pairs: dict) -> np.ndarray:
    """Each pair's gold for the full-KB validation → class [n] int32: rows
    whose positive (``mips_input_ids`` and mask) is the same get one class,
    so a query's positive counts as found in any of its copies. (The JAX
    package gives row i the gold i, so a query whose positive also sits at
    a lower row can never score a rank-1 hit: a distinct-value search
    returns the lowest of equal rows.)"""
    rows = np.concatenate([np.asarray(pairs["mips_input_ids"]),
                           np.asarray(pairs["mips_attention_mask"])], axis=1)
    return np.unique(rows, axis=0, return_inverse=True)[1].reshape(-1).astype(np.int32)


def _pretrain_full_kb_validation(params, rcfg, pairs, k: int, *, return_details=False):
    """Every query ranks the COMPLETE encoded pair corpus; its gold is the
    class of its own positive (`positive_classes`), counted as one
    document: a query's one hit is the first rank that holds its class, so
    a perfect retriever scores 1. (Copies of a positive encode to equal
    rows, whose equal scores the distinct-value search returns once
    anyway.)"""
    from .retriever.metrics import retriever_metrics_fixed
    from .retriever.validate import validate_retriever

    n = len(pairs["query_input_ids"])
    gold = positive_classes(pairs)
    corpus = {"token_ids": np.asarray(pairs["mips_input_ids"]),
              "token_mask": np.asarray(pairs["mips_attention_mask"])}
    queries = {"query_input_ids": np.asarray(pairs["query_input_ids"]),
               "query_attention_mask": np.asarray(pairs["query_attention_mask"])}
    _, details = validate_retriever(params, rcfg.query_enc, rcfg.mips_enc, corpus,
                                    gold[:, None], queries, gold_aid=gold,
                                    gold_counts=np.ones(n, np.int32), k=min(k, n),
                                    return_details=True)
    hits = details["hits"]
    details["hits"] = hits & (np.cumsum(hits, -1) == 1)
    vm = {key: float(v) for key, v in retriever_metrics_fixed(
        torch.from_numpy(details["hits"]), torch.ones(n)).items()}
    return (vm, details) if return_details else vm


def run_pretrain_retriever(cfg, *, device: str = "cuda",
                           report: dict[str, Any] | None = None) -> dict[str, Any]:
    """Contrastive pretraining of the dual encoder for ``max_steps`` steps
    (f32, AdamW as ``build_optimizer`` builds it), a full-KB validation
    every ``eval_every`` steps and at the end, and ``ckpt_dir/encoders.npz``
    exported on each better ``average_precision`` (and at the end if none
    was). With ``retriever.hf_export``, also ``ckpt_dir/hf_query_encoder``
    and ``hf_mips_encoder``; that needs ``transformers``, which is checked
    before the first step. With ``report``, also fills in each step's and
    each validation's wall seconds (synchronised), the losses, the
    validations' metrics, the final state, and the step and the encoder
    weights (copies on the CPU) of the last export."""
    from .obs import MetricsLogger
    from .train.optimizer import build_optimizer
    from .train.trainer import TrainState, make_retriever_train_step
    from .utils.checkpoint import ENCODER_GROUPS, export_encoders

    dev = resolve_device(device)
    hf_export = bool(cfg.ckpt_dir and cfg.retriever.hf_export)
    if hf_export:
        try:
            import transformers  # noqa: F401
        except ImportError as e:
            raise RuntimeError("retriever.hf_export writes transformers directories and "
                               "needs the transformers package; unset it or install "
                               "transformers") from e
    rcfg, params, pairs = _pretrain_setup(cfg, dev)
    t = cfg.train
    tx = build_optimizer(t.lr, t.warmup_steps, t.total_steps, grad_clip=t.grad_clip,
                         mu_dtype=t.adam_mu_dtype)
    state = TrainState.create(params, tx)
    step_fn = make_retriever_train_step(rcfg, tx)
    n = len(pairs["query_input_ids"])
    rep = report if report is not None else {}
    rep.update(step_s=[], losses=[], val_s=[], val=[])
    log = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name + "_retriever",
                        tensorboard=cfg.logging.tensorboard, mlflow=cfg.logging.mlflow)
    enc_path = os.path.join(cfg.ckpt_dir, "encoders.npz") if cfg.ckpt_dir else None
    best_ap, exported, metrics = -1.0, False, {}

    def export(step: int) -> None:
        nonlocal exported
        export_encoders(enc_path, state.params)
        exported = True
        if report is not None:
            rep.update(export_step=step, exported={
                f"{g}.{n}": p.detach().to("cpu", copy=True) for g in ENCODER_GROUPS
                for n, p in getattr(state.params, g).named_parameters()})

    def validate_and_maybe_export(step: int) -> dict:
        nonlocal best_ap
        t0 = time.perf_counter()
        vm = _pretrain_full_kb_validation(state.params, rcfg, pairs, cfg.retriever.eval_k)
        rep["val_s"].append(time.perf_counter() - t0)
        rep["val"].append(vm)
        log.log(step, vm, prefix="val_")
        if enc_path and vm["average_precision"] > best_ap:
            export(step)
        best_ap = max(best_ap, vm["average_precision"])
        return vm

    try:
        for step in range(cfg.max_steps):
            # (seed, step) fixes the draw, as in the JAX package
            sel = np.random.default_rng(cfg.seed + step).choice(
                n, size=min(cfg.data.batch_size, n), replace=False)
            batch = {k: torch.from_numpy(np.asarray(v)[sel]).to(dev) for k, v in pairs.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the device
            rep["step_s"].append(time.perf_counter() - t0)
            rep["losses"].append(loss)
            log.log(step, metrics)
            if (cfg.eval_every and (step + 1) % cfg.eval_every == 0
                    and step + 1 < cfg.max_steps):
                validate_and_maybe_export(step + 1)
        out = {k: float(v) for k, v in metrics.items()}
        vm = validate_and_maybe_export(cfg.max_steps)
    finally:
        log.close()
    if enc_path and not exported:
        export(cfg.max_steps)
    if hf_export:
        from .models.hf_export import save_encoder_pretrained

        for group, enc_cfg in (("query_encoder", rcfg.query_enc),
                               ("mips_encoder", rcfg.mips_enc)):
            save_encoder_pretrained(getattr(state.params, group), enc_cfg,
                                    os.path.join(cfg.ckpt_dir, f"hf_{group}"))
            print(f"[export] {group} -> {cfg.ckpt_dir}/hf_{group}")
    out.update({f"val_{k}": v for k, v in vm.items()})
    out["best_average_precision"] = best_ap
    rep.update(state=state, pairs=pairs)
    return out


def _saved_encoders(cfg, params):
    """Load ``ckpt_dir/encoders.npz`` into ``params`` when there is one."""
    from .utils.checkpoint import import_encoders

    path = os.path.join(cfg.ckpt_dir, "encoders.npz") if cfg.ckpt_dir else None
    if path and os.path.exists(path):
        import_encoders(path, params)
        print(f"[weights] query/mips encoders <- {path}")
        return True
    return False


def run_pretrain_retriever_test(cfg, *, device: str = "cuda") -> dict[str, Any]:
    """``pretrain-retriever --mode test``: the full-KB metrics of the saved
    ``ckpt_dir/encoders.npz`` (else of the pretrained or seeded encoders),
    with no training."""
    from .obs import MetricsLogger

    rcfg, params, pairs = _pretrain_setup(cfg, resolve_device(device))
    if not _saved_encoders(cfg, params):
        print("[weights] no encoders.npz found; evaluating the pretrained/seed-initialized "
              "encoders")
    vm = _pretrain_full_kb_validation(params, rcfg, pairs, cfg.retriever.eval_k)
    log = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name + "_retriever")
    log.log(0, vm, prefix="test_")
    log.close()
    out = {f"test_{k}": float(v) for k, v in vm.items()}
    out["n_queries"] = len(pairs["query_input_ids"])
    return out


def run_pretrain_retriever_predict(cfg, *, device: str = "cuda") -> dict[str, Any]:
    """``pretrain-retriever --mode predict``: the full-KB search with the
    saved encoders (when there are), its per-query ranking dumped to
    ``<log_dir>/retriever_predictions.json`` → the metrics and
    ``n_queries``."""
    from .obs import MetricsLogger

    rcfg, params, pairs = _pretrain_setup(cfg, resolve_device(device))
    _saved_encoders(cfg, params)
    vm, details = _pretrain_full_kb_validation(params, rcfg, pairs, cfg.retriever.eval_k,
                                               return_details=True)
    dump = [{"query": i, "retrieved": details["indices"][i].tolist(),
             "scores": [round(float(s), 6) for s in details["scores"][i]],
             "hits": details["hits"][i].astype(int).tolist()}
            for i in range(len(details["indices"]))]
    log = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name + "_retriever")
    log.dump_outputs("retriever_predictions", dump)
    log.close()
    out = dict(vm)
    out["n_queries"] = len(dump)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="retrieval_augmented_mds_tpu_torch")
    p.add_argument("command", choices=["fit", "validate", "test", "predict",
                                       "pretrain-retriever", "build-index", "bench-index"])
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="./index_out",
                   help="build-index: the directory to save the index in")
    p.add_argument("--index", default=None, metavar="DIR",
                   help="load this persisted index directory instead of "
                   "embedding the corpus (validate, test, predict)")
    p.add_argument("--mode", choices=["train", "test", "predict"], default="train",
                   help="pretrain-retriever only: train; test = the full-KB metrics of "
                   "the saved encoders.npz; predict = their top-k ranking dumped")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    from .models.retriever_generator import RAGConfig
    from .utils.config import ExperimentConfig, load_config

    cfg = (load_config(args.config) if args.config
           else ExperimentConfig(model=RAGConfig.tiny()))
    if args.command == "fit":
        out = run_fit(cfg, device=args.device)
    elif args.command in ("validate", "test"):
        split = "val" if args.command == "validate" else "test"
        out = run_validate(cfg, split, index_dir=args.index, device=args.device)
    elif args.command == "pretrain-retriever":
        run = {"train": run_pretrain_retriever, "test": run_pretrain_retriever_test,
               "predict": run_pretrain_retriever_predict}[args.mode]
        out = run(cfg, device=args.device)
    elif args.command == "build-index":
        out = run_build_index(cfg, args.out, device=args.device)
    elif args.command == "bench-index":
        out = run_bench_index(cfg, device=args.device)
    else:
        out = run_predict(cfg, index_dir=args.index, device=args.device)
    print(json.dumps(out, default=str)[:2000])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
