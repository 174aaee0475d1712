"""Command-line entry point of the port:

    python -m retrieval_augmented_mds_tpu_torch.cli \
        {fit,validate,test,predict,pretrain-retriever,build-index,bench-index,export} \
        --config <yaml> [--index DIR] [--out DIR] [--mode train|test|predict] \
        [--device cuda|cpu] [--profile]

The subcommands do what the JAX package's ``run_fit``, ``run_validate``,
``run_predict`` and ``run_pretrain_retriever*`` do, on one device
(``fit``, ``validate`` and ``test`` also over a mesh):

* ``fit``: build the data and the parameters (seeded, with the pretrained
  weights the config names loaded over them: ``*_weights`` and
  ``encoder_state_path``, `models.hf_import`), resume from
  ``ckpt_dir/latest.json`` when there is one, build the memory store, and
  take ``max_steps`` train steps, refreshing the store every
  ``index.rebuild_every`` steps, evaluating every ``eval_every`` steps and
  checkpointing as the reference does. Metrics go to
  ``<log_dir>/<run_name>.metrics.jsonl``, the resolved config to
  ``<log_dir>/config_resolved.yaml``; ``logging.teams_webhook`` gets a card
  when the run starts and when it crashes. Over a ``mesh`` (one process
  per position: ``torchrun --nproc-per-node N -m
  retrieval_augmented_mds_tpu_torch.cli fit --config <yaml>``) each data
  rank trains on its rows of every batch, the gradients are summed over
  the ranks, the optimizer state is ZeRO-sharded over ``data``, the store
  is built and refreshed data-parallel and placed sharded, and only rank 0
  logs, notifies, prints and writes checkpoints (of the gathered state,
  which load on one device or any mesh). A config that sets
  ``baseline: bart`` or ``t5`` fine-tunes that baseline instead
  (`run_fit_baseline`).
* ``validate`` / ``test``: generate over the whole val / test split and
  score it with ROUGE, from the checkpoint ``best.json`` marks (else
  ``latest.json``) when ``ckpt_dir`` has one. Over a ``mesh`` (one process
  per position: ``torchrun --nproc-per-node N -m
  retrieval_augmented_mds_tpu_torch.cli validate --config <yaml>``) the
  store is built data-parallel and placed sharded, each data rank
  generates for its rows of every batch, and every rank scores the
  gathered predictions (`parallel.mesh`); only rank 0 prints and writes.
* ``predict``: generate for the first batch of the test split; with
  ``generation.output_copy_probs``, also the per-token copy traces
  (`models.generate.copy_trace`) as lists.
* ``pretrain-retriever``: contrastive pretraining of the query and mips
  encoders on the config's positive pairs (``--mode train``), exporting
  ``ckpt_dir/encoders.npz``, the file ``model.encoder_state_path`` reads;
  ``--mode test`` scores that file over the full pair corpus, ``--mode
  predict`` dumps its per-query ranking.
* ``build-index``: embed the corpus, build the configured index and save
  it with the tokenized corpus (``corpus_tokens.npz``) under ``--out``, in
  the JAX package's layout; ``--index DIR`` loads such a directory.
* ``bench-index``: flat and IVF index build times and recall@10 on a
  seeded Gaussian-mixture corpus shaped like the config, against the exact
  top-10 of the native CPU search (`utils.cpu_baseline`).
* ``export``: the serving step as two `torch.export` programs (encode and
  one cached decode step, weights and index as inputs) with a manifest
  under ``--out`` (`serving`; `serving.load_serving` and `serving.serve`
  serve them).

Serving runs under ``torch.no_grad()``. Everything runs on CUDA by default
and raises when CUDA is missing, unless ``--device cpu`` is given.
``--profile`` writes a `torch.profiler` Chrome trace of any command under
``<logging.log_dir>/trace`` (`obs.trace`): the host's operators, the card's
kernels, and the program's spans (`obs.span`: ``train.step``,
``generate.step``, ``store.build`` and their parts) as ranges on the same
timeline.
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

# what a batch carries to the device (the reference's _device_batch);
# decoder_input_ids are derived from the labels
_DEVICE_KEYS = (
    "input_ids", "attention_mask", "query_input_ids", "query_attention_mask",
    "mips_ignore", "labels", "gold_aid", "aid_counts", "target_memory_ids",
    "target_memory_mask", "input_memory_ids", "input_memory_mask", "input_memory_count",
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


def build_data(cfg, prompt_prefix: str = ""):
    """The host data pipeline (pandas): the module, and the tokenizer.
    ``prompt_prefix`` is put before every source before it is tokenized
    (T5's "summarize: ")."""
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
        source_memory=d.source_memory, doc_sep=d.doc_sep, prompt_prefix=prompt_prefix,
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


def build_store(params, cfg, dm, device: torch.device, mesh=None):
    """Embed the corpus and build the configured index (over a ``mesh``:
    embedded data-parallel, placed sharded)."""
    from .train.trainer import build_memory_store

    arr = dm.store_arrays
    aids = arr.get("row_aids")
    return build_memory_store(
        params, cfg.model, cfg.index,
        token_ids=torch.from_numpy(arr["token_ids"]).to(device),
        token_mask=torch.from_numpy(arr["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
        seed=cfg.seed, compute_dtype=compute_dtype(cfg), mesh=mesh,
    )


def load_store(index_dir: str, cfg, device: torch.device, mesh=None):
    """A MemoryStore from a persisted ``build-index`` directory (either
    package's, flat or IVF), with no re-embedding; ``cfg.index.nprobe``
    sets the probe width. Over a ``mesh``, this rank's part of the index."""
    from .index import load_index
    from .models.retriever_generator import MemoryStore

    tok = np.load(os.path.join(index_dir, "corpus_tokens.npz"))
    aids = tok["row_aids"] if "row_aids" in tok.files else None
    return MemoryStore(
        index=load_index(index_dir, device=device, mesh=mesh),
        token_ids=torch.from_numpy(tok["token_ids"]).to(device),
        token_mask=torch.from_numpy(tok["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
        nprobe=cfg.index.nprobe,
    )


def serving_store(params, cfg, dm, device: torch.device, index_dir: str | None = None,
                  mesh=None):
    """The store that validate, test, predict and export serve from: None
    under ``mips_disabled``, loaded from ``index_dir``, or built."""
    if cfg.model.mips_disabled:
        return None
    if index_dir:
        return load_store(index_dir, cfg, device, mesh)
    return build_store(params, cfg, dm, device, mesh)


def best_params(cfg, device: torch.device):
    """`build_params`, then the ``ckpt_dir`` checkpoint that ``best.json``
    marks (else the latest) when ``ckpt_dir`` has one."""
    from .utils.checkpoint import checkpoint_path, load_arrays, load_params

    params = build_params(cfg, device)
    if cfg.ckpt_dir and os.path.exists(os.path.join(cfg.ckpt_dir, "latest.json")):
        load_params(params, load_arrays(checkpoint_path(cfg.ckpt_dir, prefer="best")))
    return params


def device_batch(host: dict, cfg, device: torch.device, mesh=None
                 ) -> dict[str, torch.Tensor]:
    """Host batch → device tensors, with the teacher-forcing decoder inputs.
    Over a ``mesh``, data rank d takes rows [d·B/D, (d+1)·B/D) when D
    divides B, and the whole batch otherwise (the JAX package replicates
    such a batch)."""
    from .models.led import shift_tokens_right

    rows = slice(None) if mesh is None else mesh.data_rows(len(host["input_ids"]))
    out = {k: torch.from_numpy(np.asarray(v)[rows]).to(device)
           for k, v in host.items() if k in _DEVICE_KEYS}
    out["decoder_input_ids"] = shift_tokens_right(
        out["labels"], cfg.model.led.pad_id, cfg.generation.decoder_start_id)
    return out


def build_tx(cfg, params, mesh=None):
    """The one optimizer construction: ``fit`` and every command that loads
    a train state must build the same one, or its state will not load.
    Over a ``mesh`` its state is ZeRO-sharded over ``data``; its
    checkpoints keep the single-device layout."""
    from .train.optimizer import build_optimizer

    t = cfg.train
    return build_optimizer(
        t.lr, t.warmup_steps, t.total_steps, weight_decay=t.weight_decay,
        grad_clip=t.grad_clip,
        frozen_groups=tuple(t.frozen_groups) + cfg.model.frozen_groups(),
        accumulate_steps=t.accumulate_steps, mu_dtype=t.adam_mu_dtype,
        state_8bit=t.adam_8bit, mesh=mesh,
    )


def check_fit_config(cfg) -> None:
    """Raise on what `run_fit` does not run, rather than train something
    else without a word: a baseline (`run_fit_baseline` trains those; ``fit``
    dispatches to it)."""
    if cfg.baseline:
        raise ValueError(
            f"baseline {cfg.baseline!r}: run_fit trains the retrieval-augmented model; "
            "run_fit_baseline trains the baselines (`fit` picks it)")


class _Quiet:
    """The logger of a rank other than 0 over a mesh: it writes nothing."""

    def log(self, *a, **k):
        pass

    log_hyperparams = close = log


def copy_force(cfg, step: int) -> bool | None:
    """The copy-forcing flag of train step ``step`` under ``target_in``
    (None otherwise): a draw seeded by (seed, step), not a sequential
    stream, so the schedule survives a resume (the JAX package's draw)."""
    if cfg.model.memory_forcing != "target_in":
        return None
    return bool(np.random.default_rng([cfg.seed, step]).random() < cfg.model.copy_forcing)


def run_fit(cfg, *, device: str = "cuda", report: dict[str, Any] | None = None
            ) -> dict[str, Any]:
    """Train for ``cfg.max_steps`` steps → the last step's metrics and
    ``steps``. With ``report``, also fills in per-step wall times (seconds,
    synchronised) and phase times, the losses, each step's retrieved row
    ids and copy-forcing flag, the store builds' and refreshes' times, and
    the objects the run made. The resolved config goes to
    ``<log_dir>/config_resolved.yaml``; ``logging.teams_webhook`` is told
    when the run starts and when it raises (`obs.TeamsNotifier`).

    The config's ``mesh`` is built by `parallel.build_mesh`; over it (each
    rank calls this, under ``torchrun``) the run is the JAX package's mesh
    fit: the batches split over ``data`` (`device_batch`), the LED encoder
    sequence-sharded over ``shard`` with ``model.sequence_shard``, the
    optimizer state ZeRO-sharded, the store built, refreshed and searched
    over the mesh, the eval loop over the mesh; the logs, the Teams cards
    and the checkpoint files are rank 0's. ``report`` then also holds the
    ``mesh``, and each step's ``collectives`` (calls, bytes this rank
    received)."""
    from .obs import MetricsLogger, TeamsNotifier
    from .parallel import build_mesh
    from .parallel.collectives import STATS
    from .train.trainer import TrainState, make_train_step, refresh_store
    from .utils.checkpoint import load_train_state, mark_best, save_train_state
    from .utils.config import save_config

    check_fit_config(cfg)
    mesh = build_mesh(cfg, device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0  # the rank that logs and writes
    dm, tok = build_data(cfg)
    params = build_params(cfg, dev)
    tx = build_tx(cfg, params, mesh)
    state = TrainState.create(params, tx)
    start_step = 0
    if cfg.ckpt_dir and os.path.exists(os.path.join(cfg.ckpt_dir, "latest.json")):
        state, start_step = load_train_state(cfg.ckpt_dir, state, tx)
        if lead:
            print(f"resumed from step {start_step}")
    dtype = compute_dtype(cfg)
    t0 = time.perf_counter()
    # built from the current (possibly resumed) weights, as the reference
    store = (None if cfg.model.mips_disabled
             else build_store(state.params, cfg, dm, dev, mesh))
    _sync(dev)
    rep = report if report is not None else {}
    rep.update(store_s=time.perf_counter() - t0, step_s=[], phase_s=[], losses=[],
               refresh_s=[], retrieved=[], copy_force=[], collectives=[], mesh=mesh)
    split = mesh is not None and mesh.splits_batch(cfg.data.batch_size)
    step_fn = make_train_step(cfg.model, tx, cfg.train, dtype=dtype,
                              remat=cfg.train.remat,
                              phase_times=rep["phase_s"] if report is not None else None,
                              retrieved=rep["retrieved"] if report is not None else None,
                              mesh=mesh, data_sharded=split)

    if lead:
        log = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name,
                            tensorboard=cfg.logging.tensorboard, mlflow=cfg.logging.mlflow)
        log.log_hyperparams(dataclasses.asdict(cfg))
        save_config(cfg, os.path.join(cfg.logging.log_dir, "config_resolved.yaml"))
    else:
        log = _Quiet()
    teams = TeamsNotifier(cfg.logging.teams_webhook if lead else None,
                          cfg.logging.run_name)
    teams.on_fit_start()
    step, metrics, best_rouge1 = start_step, {}, -1.0
    # a resumed run starts "saved" at start_step
    last_saved = start_step if start_step else -1
    # the batch order is a function of (seed, step): epoch e shuffles with
    # seed + e, so a resumed run re-enters the same permutation
    steps_per_epoch = max(1, len(dm.split_indices("train")) // cfg.data.batch_size)
    last_end = time.perf_counter()
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
                                          seed=cfg.seed, mesh=mesh)
                    _sync(dev)
                    rep["refresh_s"].append(time.perf_counter() - t0)
                dbatch = device_batch(batch, cfg, dev, mesh)
                force = copy_force(cfg, step)
                rep["copy_force"].append(force)
                t0, received, calls = time.perf_counter(), STATS["bytes"], STATS["calls"]
                state, metrics = step_fn(state, store, dbatch, force)
                loss = float(metrics["loss"])  # waits for the device
                end = time.perf_counter()
                sec = end - t0
                rep["step_s"].append(sec)
                rep["losses"].append(loss)
                rep["collectives"].append((STATS["calls"] - calls, STATS["bytes"] - received))
                metrics["steps_per_s"] = 1.0 / max(sec, 1e-9)
                # the batch's real source tokens over all the time since the
                # last step ended, the wait for this batch included
                metrics["tokens_per_s"] = (float(np.asarray(batch["attention_mask"]).sum())
                                           / max(end - last_end, 1e-9))
                last_end = end
                log.log(step, metrics)
                step += 1
                if cfg.ckpt_dir and cfg.train.save_every and step % cfg.train.save_every == 0:
                    save_train_state(cfg.ckpt_dir, state, tx, step, mesh=mesh)
                    last_saved = step
                if cfg.eval_every and step % cfg.eval_every == 0:
                    ev = run_eval_loop(cfg, state.params, store, dm, tok,
                                       max_batches=cfg.eval_max_batches, device=dev,
                                       mesh=mesh)
                    log.log(step, ev, prefix="val_")
                    # keep the checkpoint of the best rouge1
                    if cfg.ckpt_dir and ev.get("rouge1", 0) > best_rouge1:
                        best_rouge1 = ev["rouge1"]
                        path = save_train_state(cfg.ckpt_dir, state, tx, step, mesh=mesh)
                        if lead:
                            mark_best(cfg.ckpt_dir, step, path, best_rouge1)
                        last_saved = step
        if cfg.ckpt_dir and last_saved != step:
            save_train_state(cfg.ckpt_dir, state, tx, step, mesh=mesh)
    except BaseException as e:  # noqa: BLE001
        teams.on_exception(e)
        raise
    finally:
        log.close()
    rep.update(state=state, store=store, tx=tx)
    out = {k: float(v) for k, v in metrics.items()}
    out["steps"] = step
    return out


def run_eval_loop(cfg, params, store, dm, tok, max_batches: int | None = None,
                  dump_name: str | None = None, split: str = "val", *,
                  device: torch.device, mesh=None, report: dict | None = None
                  ) -> dict[str, float]:
    """Generate for every batch of ``split`` (at most ``max_batches``) and
    score the outputs with ROUGE; with ``dump_name``, also write them to
    ``<log_dir>/<dump_name>.json``. Runs without autograd. The ragged last
    batch is padded to ``data.batch_size`` with copies of its first row and
    only its real rows are scored, as the JAX package does: the batch size
    picks the IVF search's route, so a smaller batch could retrieve other
    rows.

    Over a ``mesh`` each data rank encodes and generates for its rows of
    the padded batch (`device_batch`), the ids are gathered over ``data``,
    every rank scores the same predictions, and only rank 0 writes the
    dump. With ``report``, each batch's device batch and encoder output
    (this rank's rows), generated ids (all rows), wall seconds (the device
    synchronised), and the bytes this rank's collectives received and
    their number (`parallel.collectives`) are appended to its ``batch``,
    ``enc``, ``ids``, ``batch_s``, ``collective_bytes`` and
    ``collective_calls`` lists."""
    from .eval import RougeAccumulator
    from .models.generate import generate
    from .models.retriever_generator import rag_encode
    from .parallel.collectives import STATS, gather_cat

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
            t0, received, calls = time.perf_counter(), STATS["bytes"], STATS["calls"]
            split_rows = mesh is not None and mesh.splits_batch(cfg.data.batch_size)
            dbatch = device_batch(batch, cfg, device, mesh)
            enc = rag_encode(params, cfg.model, store, dbatch, dtype=dtype, mesh=mesh,
                             data_sharded=split_rows)
            ids = generate(params, cfg.model, enc, cfg.generation, dtype=dtype)
            if split_rows:
                ids = gather_cat(ids, mesh.data_group)
            if report is not None:
                _sync(device)
                for key, value in (("batch", dbatch), ("enc", enc), ("ids", ids),
                                   ("batch_s", time.perf_counter() - t0),
                                   ("collective_bytes", STATS["bytes"] - received),
                                   ("collective_calls", STATS["calls"] - calls)):
                    report.setdefault(key, []).append(value)
            preds = tok.batch_decode(ids.cpu().numpy())[:n_real]
            refs = tok.batch_decode(np.asarray(batch["labels"]))[:n_real]
            acc.add_batch(preds, refs)
            outputs.extend({"prediction": p, "reference": r} for p, r in zip(preds, refs))
    if dump_name and (mesh is None or mesh.rank == 0):
        from .obs import MetricsLogger

        logger = MetricsLogger(cfg.logging.log_dir, cfg.logging.run_name)
        logger.dump_outputs(dump_name, outputs)
        logger.close()
    return acc.compute()


def run_validate(cfg, split: str = "val", index_dir: str | None = None, *,
                 device: str = "cuda", max_batches: int | None = None,
                 report: dict | None = None) -> dict[str, float]:
    """ROUGE over the whole ``split`` (its first ``max_batches``), from the
    checkpoint of ``ckpt_dir`` (the best-marked one, else the latest) when
    there is one. The config's ``mesh`` is built by `parallel.build_mesh`
    (which raises on a mesh the world cannot form); over it the store is
    built data-parallel and placed sharded and the eval loop runs sharded.
    With ``report``: the mesh, params, store and the eval loop's report."""
    from .parallel import build_mesh

    mesh = build_mesh(cfg, device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    dm, tok = build_data(cfg)
    params = best_params(cfg, dev)
    store = serving_store(params, cfg, dm, dev, index_dir, mesh)
    if report is not None:
        report.update(mesh=mesh, params=params, store=store)
    return run_eval_loop(cfg, params, store, dm, tok, max_batches=max_batches,
                         dump_name=f"{split}_outputs_{int(time.time())}", split=split,
                         device=dev, mesh=mesh, report=report)


def predict_batch(cfg, dm, device: torch.device) -> dict[str, torch.Tensor]:
    """The batch `run_predict` serves and `run_export` exports at: the first
    batch of the held-out test split (the JAX package's ``run_predict``
    draws from the unsplit set, train examples included)."""
    host = next(dm.batches(cfg.data.batch_size, shuffle=False, split="test",
                           drop_last=False))
    return device_batch(host, cfg, device)


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
    store = serving_store(params, cfg, dm, dev, index_dir)
    _sync(dev)
    t1 = time.perf_counter()
    batch = predict_batch(cfg, dm, dev)
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
        trace = copy_trace(params, cfg.model, enc, ids,
                           decoder_start_id=cfg.generation.decoder_start_id)
        _sync(dev)
        out["copy_traces"] = {k: v.cpu().tolist() for k, v in trace.items()}
    t4 = time.perf_counter()
    if report is not None:
        report.update(store_s=t1 - t0, encode_s=t2 - t1, generate_s=t3 - t2,
                      copy_trace_s=t4 - t3, params=params, store=store, batch=batch,
                      enc=enc, ids=ids)
    return out


def run_export(cfg, out_dir: str, index_dir: str | None = None, *, device: str = "cuda",
               report: dict[str, Any] | None = None) -> dict[str, Any]:
    """Export the serving step as two `torch.export` programs (`serving`:
    encode, and one cached decode step) with its manifest under
    ``out_dir`` → the manifest. As the JAX package's ``run_export``, at the
    weights of `best_params` and the store of `serving_store`, which stay
    inputs of the programs; the signature batch is `predict_batch` minus
    ``labels``. With ``report``, also fills in the export's wall seconds
    and the params, store and batch it exported with."""
    from .serving import export_serving

    dev = resolve_device(device)
    dm, _ = build_data(cfg)
    params = best_params(cfg, dev)
    store = serving_store(params, cfg, dm, dev, index_dir)
    batch = predict_batch(cfg, dm, dev)
    t0 = time.perf_counter()
    manifest = export_serving(params, cfg, store, batch, out_dir)
    if report is not None:
        report.update(export_s=time.perf_counter() - t0, params=params, store=store,
                      batch=batch)
    return manifest


def run_fit_baseline(cfg, *, device: str = "cuda",
                     report: dict[str, Any] | None = None) -> dict[str, Any]:
    """Fine-tune the parametric-only baseline ``cfg.baseline`` (``bart`` or
    ``t5``; reference BartLightning / T5Lightning, sotasum/bart_lightning.py:
    48-244, t5_lightning.py:48-232) for ``max_steps`` steps, then generate
    greedily over the val split (at most ``eval_max_batches`` batches; the
    ragged last one padded with copies of its first row) and score it with
    ROUGE → the last step's metrics, the ROUGE scores and ``steps``. T5's
    sources get the "summarize: " prefix. As the JAX package's
    ``run_fit_baseline``: seeded random weights of ``model.led``'s shape, f32
    whatever ``precision`` says, AdamW with only lr, warmup, total steps,
    ``grad_clip`` and ``adam_mu_dtype`` (no weight decay, frozen groups,
    accumulation, 8-bit state or remat), no store, eval, checkpoints or
    resume; the metrics go to ``<log_dir>/<run_name>_<family>.metrics.jsonl``
    (and its TensorBoard and mlflow mirrors), the outputs to
    ``baseline_<family>_val_outputs.json``. Unlike it, the steps draw from
    the train split, not from every example (the val split included). With
    ``report``, also fills in each step's wall seconds (synchronised) and
    loss, each val batch's ``generate`` seconds and ids, and the final
    state. Each step and each batch's decoding is a program span
    (`obs.span`: ``baseline_step``, ``baseline_generate``), a range of a
    ``--profile`` trace."""
    from .eval import RougeAccumulator
    from .models.bart import init_bart
    from .models.t5 import init_t5
    from .obs import MetricsLogger, span
    from .train.baseline import make_seq2seq_train_step, seq2seq_greedy
    from .train.optimizer import build_optimizer
    from .train.trainer import TrainState

    family = cfg.baseline
    if family not in ("bart", "t5"):
        raise ValueError(f"baseline {family!r}: the baselines are 'bart' and 't5'")
    dev = resolve_device(device)
    # the prefix goes in before tokenization (reference data_modules.py:152-155)
    dm, tok = build_data(cfg, prompt_prefix="summarize: " if family == "t5" else "")
    mcfg, t = cfg.model.led, cfg.train
    init = init_bart if family == "bart" else init_t5
    params = init(mcfg, torch.Generator().manual_seed(cfg.seed)).to(dev)
    tx = build_optimizer(t.lr, t.warmup_steps, t.total_steps, grad_clip=t.grad_clip,
                         mu_dtype=t.adam_mu_dtype)
    state = TrainState.create(params, tx)
    step_fn = make_seq2seq_train_step(family, mcfg, tx, t.label_smoothing_eps)
    log = MetricsLogger(cfg.logging.log_dir, f"{cfg.logging.run_name}_{family}",
                        tensorboard=cfg.logging.tensorboard, mlflow=cfg.logging.mlflow)
    rep = report if report is not None else {}
    rep.update(step_s=[], losses=[], generate_s=[], val_ids=[])
    n, metrics = 0, {}
    acc, outputs = RougeAccumulator(), []
    try:
        while n < cfg.max_steps:
            drawn = 0
            # epochs reshuffle with seed + the step they start at, as the JAX package
            for batch in dm.batches(cfg.data.batch_size, seed=cfg.seed + n, split="train"):
                if n >= cfg.max_steps:
                    break
                drawn += 1
                db = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                      for k in ("input_ids", "attention_mask", "labels")}
                t0 = time.perf_counter()
                with span("baseline_step"):
                    state, metrics = step_fn(state, db)
                    rep["losses"].append(float(metrics["loss"]))  # waits for the device
                rep["step_s"].append(time.perf_counter() - t0)
                log.log(n, metrics)
                n += 1
            if not drawn:
                raise ValueError(f"the train split holds fewer than data.batch_size="
                                 f"{cfg.data.batch_size} examples")
        # a full validation epoch (reference bart_lightning.py:126-196)
        for bi, batch in enumerate(dm.batches(cfg.data.batch_size, shuffle=False,
                                              drop_last=False, split="val")):
            if cfg.eval_max_batches is not None and bi >= cfg.eval_max_batches:
                break
            n_real = len(batch["input_ids"])
            if n_real < cfg.data.batch_size:
                reps = cfg.data.batch_size - n_real
                batch = {k: np.concatenate([v, np.repeat(v[:1], reps, axis=0)])
                         for k, v in batch.items()}
            t0 = time.perf_counter()
            with span("baseline_generate"):
                ids = seq2seq_greedy(
                    family, state.params, mcfg,
                    torch.from_numpy(np.asarray(batch["input_ids"])).to(dev),
                    torch.from_numpy(np.asarray(batch["attention_mask"])).to(dev),
                    max_new_tokens=cfg.generation.max_new_tokens).cpu().numpy()
            rep["generate_s"].append(time.perf_counter() - t0)
            rep["val_ids"].append(ids)
            preds = tok.batch_decode(ids)[:n_real]
            refs = tok.batch_decode(np.asarray(batch["labels"]))[:n_real]
            acc.add_batch(preds, refs)
            outputs.extend({"prediction": p, "reference": r} for p, r in zip(preds, refs))
        log.dump_outputs(f"baseline_{family}_val_outputs", outputs)
    finally:
        log.close()
    rep.update(state=state)
    out = {k: float(v) for k, v in metrics.items()}
    out.update(acc.compute())
    out["steps"] = n
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
    (65536 by default) at the mips encoder's width. Recall is against the
    exact top-10 over the f32 corpus of the native CPU search
    (`utils.cpu_baseline.cpu_mips_search`, as the JAX package takes it);
    the IVF queries go in batches of 4, so that B·nprobe < C and the
    probed route runs (a batch of 64 would scan every cluster). Times are
    host seconds with the device synchronised."""
    from .index import build_flat_index, build_ivf_index, ivf_search, search
    from .utils.cpu_baseline import cpu_mips_search

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

    ref = torch.from_numpy(cpu_mips_search(x, q, k)[1])
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
                                       "pretrain-retriever", "build-index", "bench-index",
                                       "export"])
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="./index_out",
                   help="build-index: the directory to save the index in; export: the "
                   "directory of the serving artifact")
    p.add_argument("--index", default=None, metavar="DIR",
                   help="load this persisted index directory instead of "
                   "embedding the corpus (validate, test, predict, export)")
    p.add_argument("--mode", choices=["train", "test", "predict"], default="train",
                   help="pretrain-retriever only: train; test = the full-KB metrics of "
                   "the saved encoders.npz; predict = their top-k ranking dumped")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace of the command into "
                   "<log_dir>/trace: host ops, the card's kernels and the program's spans")
    args = p.parse_args(argv)

    from .models.retriever_generator import RAGConfig
    from .utils.config import ExperimentConfig, load_config

    cfg = (load_config(args.config) if args.config
           else ExperimentConfig(model=RAGConfig.tiny()))

    def run():
        if args.command == "fit":
            return (run_fit_baseline if cfg.baseline else run_fit)(cfg, device=args.device)
        if args.command in ("validate", "test"):
            split = "val" if args.command == "validate" else "test"
            return run_validate(cfg, split, index_dir=args.index, device=args.device)
        if args.command == "pretrain-retriever":
            return {"train": run_pretrain_retriever, "test": run_pretrain_retriever_test,
                    "predict": run_pretrain_retriever_predict}[args.mode](
                        cfg, device=args.device)
        if args.command == "build-index":
            return run_build_index(cfg, args.out, device=args.device)
        if args.command == "bench-index":
            return run_bench_index(cfg, device=args.device)
        if args.command == "export":
            return run_export(cfg, args.out, index_dir=args.index, device=args.device)
        return run_predict(cfg, index_dir=args.index, device=args.device)

    if args.profile:
        from .obs import trace

        with trace(os.path.join(cfg.logging.log_dir, "trace")):
            out = run()
    else:
        out = run()
    if torch.distributed.is_initialized():  # a mesh: rank 0 prints the result
        rank = torch.distributed.get_rank()
        torch.distributed.destroy_process_group()
        if rank:
            return 0
    print(json.dumps(out, default=str)[:2000])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
