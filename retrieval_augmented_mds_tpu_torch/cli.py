"""Command-line entry point of the port:

    python -m retrieval_augmented_mds_tpu_torch.cli predict --config <yaml> \
        [--index DIR] [--device cuda|cpu]

``predict`` does what the JAX package's ``run_predict`` does: build the
data and the (seeded, random) parameters, build or load the memory store,
run `rag_encode` and `generate` on the first batch of the test split, and
print the predictions as JSON. It runs on CUDA by default and raises when
CUDA is missing, unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any

import numpy as np
import torch

_BATCH_KEYS = ("input_ids", "attention_mask", "query_input_ids",
               "query_attention_mask", "mips_ignore")


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
    """Host data pipeline of the JAX package (framework-free, pandas)."""
    from retrieval_augmented_mds_tpu.data import (
        RAGDataModule,
        load_tokenizer,
        synthetic_multi_x_science,
    )

    d = cfg.data
    if d.source == "synthetic":
        df = synthetic_multi_x_science(d.n_synthetic)
    elif d.source == "fixture" or d.source.endswith((".json", ".json.gz")):
        from retrieval_augmented_mds_tpu.data.corpus import load_fixture

        df = load_fixture(None if d.source == "fixture" else d.source)
    else:
        import pandas as pd

        from retrieval_augmented_mds_tpu.data.corpus import load_multi_x_science

        hf = load_multi_x_science(
            d.source if d.source != "multi_x_science" else "multi_x_science_sum"
        )
        df = pd.concat([v.to_pandas() for v in hf.values()], ignore_index=True)
    if d.dataset_mode == "aggregated":
        from retrieval_augmented_mds_tpu.data.corpus import aggregate_by_aid

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
    from .models.retriever_generator import init_rag

    named = [f for f in ("led_weights", "query_encoder_weights",
                         "mips_encoder_weights", "memory_encoder_weights",
                         "encoder_state_path") if getattr(cfg.model, f)]
    if named:
        raise NotImplementedError(
            f"pretrained weights ({', '.join(named)}) are not ported yet "
            "(ROADMAP queue 1: HF interop); drop them for a seeded random init"
        )
    # drawn on the CPU, then moved: one seed gives the same weights on
    # every device, so a CPU run is a reference for a CUDA run
    return init_rag(cfg.model, torch.Generator().manual_seed(cfg.seed)).to(device)


def build_store(params, cfg, dm, device: torch.device):
    from .train.trainer import build_memory_store

    arr = dm.store_arrays
    aids = arr.get("row_aids")
    return build_memory_store(
        params, cfg.model, cfg.index,
        token_ids=torch.from_numpy(arr["token_ids"]).to(device),
        token_mask=torch.from_numpy(arr["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
        compute_dtype=compute_dtype(cfg),
    )


def load_store(index_dir: str, cfg, device: torch.device):
    """A MemoryStore from a persisted ``build-index`` directory (either
    package's), with no re-embedding."""
    from .index import load_flat_index
    from .models.retriever_generator import MemoryStore

    with open(os.path.join(index_dir, "meta.json")) as f:
        if json.load(f).get("kind", "flat") != "flat":
            raise NotImplementedError(
                "only Flat indexes load in the port (ROADMAP queue 1: IVF)"
            )
    tok = np.load(os.path.join(index_dir, "corpus_tokens.npz"))
    aids = tok["row_aids"] if "row_aids" in tok.files else None
    return MemoryStore(
        index=load_flat_index(index_dir, device=device),
        token_ids=torch.from_numpy(tok["token_ids"]).to(device),
        token_mask=torch.from_numpy(tok["token_mask"]).to(device),
        row_aids=None if aids is None else torch.from_numpy(aids).to(device),
    )


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
    host = next(dm.batches(cfg.data.batch_size, shuffle=False, native=False,
                           split="test", drop_last=False))
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in _BATCH_KEYS if k in host}
    dtype = compute_dtype(cfg)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="retrieval_augmented_mds_tpu_torch")
    p.add_argument("command", choices=["predict"])
    p.add_argument("--config", default=None)
    p.add_argument("--index", default=None, metavar="DIR",
                   help="load this persisted index directory instead of "
                   "embedding the corpus")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    from .models.retriever_generator import RAGConfig
    from .utils.config import ExperimentConfig, load_config

    cfg = (load_config(args.config) if args.config
           else ExperimentConfig(model=RAGConfig.tiny()))
    out = run_predict(cfg, index_dir=args.index, device=args.device)
    print(json.dumps(out, default=str)[:2000])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
