"""Host-side preprocessing: text → fixed-shape device-ready arrays.

Counterpart of ``retrieval_augmented_mds_tpu/data/pipeline.py``, owned by
the port (numpy and pandas, no JAX). Batches are gathered in Python: the
JAX package's optional C++ batch assembler (``data/native_loader.py``,
which yields the same batches) is not ported.

Rebuilds the reference's offline tokenize pipeline + dataloaders
(`RGMultiXScienceDataModule`, sotasum/data_modules.py:158-330; per-item
assembly at sotasum/data_loaders.py:194-300) for the TPU execution model:
everything is tokenized once into fixed-shape numpy arrays, batches are
plain dicts of arrays (no ragged collation), and the corpus side becomes
the `MemoryStore` payload (pre-tokenized [N, L_mem] ids + integer aid
lists) that lives in HBM.

Notable mapping decisions:
  * `input` = abstract [+ non-empty ref abstracts] joined by `<DOC_SEP>`;
    `query_input` = abstract; `target` = related_work with `@cite_N` →
    "cite" (data_modules.py:270-285, data_loaders.py:249-275). The
    `source_memory` flag swaps the composition (data_loaders.py:249-267).
  * self-exclusion: the reference passes the example's corpus row ids to
    FAISS search (`ignore_indexes`); here that is a fixed-width
    `mips_ignore` int array per example (SURVEY.md §7.3 static-shape rule).
  * string aids become integer ids via a host-side vocabulary so metrics
    run on device (reference compares Python strings, mips.py:458-462).
  * train shuffling defaults ON; the reference ships `shuffle=False` even
    for train (data_modules.py:319 — SURVEY.md §7.3 quirk, fixed here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import pandas as pd

from .corpus import add_aid_counts, build_mips_corpus, strip_cites


def _pad_lists(lists, width: int, fill: int = -1) -> np.ndarray:
    out = np.full((len(lists), width), fill, np.int32)
    for i, row in enumerate(lists):
        row = list(row)[:width]
        out[i, : len(row)] = row
    return out


def build_aid_vocab(df: pd.DataFrame, corpus: pd.DataFrame) -> dict[str, int]:
    aids: set[str] = set(df["aid"])
    for row in corpus["aid"]:
        aids.update(row)
    if "ref_aid" in corpus:
        for row in corpus["ref_aid"]:
            aids.update(a for a in row if a)
    return {a: i for i, a in enumerate(sorted(aids))}


def prepare_memory_store_arrays(
    corpus: pd.DataFrame,
    tokenizer,
    *,
    memory_len: int = 128,
    aid_vocab: dict[str, int] | None = None,
    max_aids: int = 8,
) -> dict[str, np.ndarray]:
    """Corpus text → {token_ids [N, L], token_mask [N, L], row_aids [N, A]}.

    The tokenized corpus is the device-side replacement for re-tokenizing
    retrieved strings every step (sotasum/mips.py:465-476).
    """
    toks = tokenizer(list(corpus["mips_column"]), max_length=memory_len)
    out = {
        "token_ids": toks["input_ids"],
        "token_mask": toks["attention_mask"],
    }
    if aid_vocab is not None:
        ids = [
            [aid_vocab[a] for a in row if a in aid_vocab]
            for row in corpus["aid"]
        ]
        out["row_aids"] = _pad_lists(ids, max_aids)
    return out


def prepare_rag_examples(
    df: pd.DataFrame,
    corpus: pd.DataFrame,
    tokenizer,
    query_tokenizer,
    *,
    max_length: int = 1024,
    query_max_length: int = 256,
    decoder_max_length: int = 256,
    doc_sep: str = "<DOC_SEP>",
    source_memory: bool = False,
    aid_vocab: dict[str, int] | None = None,
    max_ignore: int = 8,
    prompt_prefix: str = "",  # T5 "summarize: " (data_modules.py:152-155)
    dual_memory: bool = False,  # input docs as memory slots (mips.py:445-451)
    memory_len: int = 128,
    max_input_docs: int = 4,
) -> dict[str, np.ndarray]:
    """Examples → fixed-shape arrays (the offline `prepare_data` pass)."""
    df = add_aid_counts(df)

    inputs, queries, targets, doc_lists = [], [], [], []
    for _, item in df.iterrows():
        refs = [a for a in item["ref_abstract"]["abstract"] if a != ""]
        if source_memory:
            inputs.append(prompt_prefix + item["abstract"])
            queries.append(" ".join([item["abstract"]] + refs))
        else:
            inputs.append(prompt_prefix + doc_sep.join([item["abstract"]] + refs))
            queries.append(item["abstract"])
        targets.append(strip_cites(item["related_work"]))
        doc_lists.append([item["abstract"]] + refs)

    enc = tokenizer(inputs, max_length=max_length)
    q = query_tokenizer(queries, max_length=query_max_length)
    tgt = tokenizer(targets, max_length=decoder_max_length)

    # inverse map: example index → corpus rows containing it (self-exclusion)
    row_of: dict[int, list[int]] = {}
    for rid, idx_list in enumerate(corpus["index"]):
        for ex in idx_list:
            row_of.setdefault(int(ex), []).append(rid)
    ignore = [row_of.get(int(i), []) for i in df["index"]]

    tgt_mem = tokenizer(targets, max_length=memory_len)
    out = {
        "input_ids": enc["input_ids"],
        "attention_mask": enc["attention_mask"],
        "query_input_ids": q["input_ids"],
        "query_attention_mask": q["attention_mask"],
        "labels": tgt["input_ids"],
        "mips_ignore": _pad_lists(ignore, max_ignore),
        "aid_counts": df["aid_counts"].to_numpy(np.int32),
        # memory-forcing payload (target text at memory length;
        # reference target_only/target_in modes, mips.py:412-439)
        "target_memory_ids": tgt_mem["input_ids"],
        "target_memory_mask": tgt_mem["attention_mask"],
    }
    if aid_vocab is not None:
        out["gold_aid"] = np.asarray(
            [aid_vocab.get(a, -1) for a in df["aid"]], np.int32
        )
    if dual_memory:
        b = len(doc_lists)
        mem_ids = np.ones((b, max_input_docs, memory_len), np.int32)
        mem_mask = np.zeros((b, max_input_docs, memory_len), np.int32)
        counts = np.zeros((b,), np.int32)
        for i, docs in enumerate(doc_lists):
            docs = docs[:max_input_docs]
            toks = tokenizer(docs, max_length=memory_len)
            mem_ids[i, : len(docs)] = toks["input_ids"]
            mem_mask[i, : len(docs)] = toks["attention_mask"]
            counts[i] = len(docs)
        out["input_memory_ids"] = mem_ids
        out["input_memory_mask"] = mem_mask
        out["input_memory_count"] = counts
    return out


def prepare_pretrain_pairs(
    df: pd.DataFrame,
    query_tokenizer,
    mips_tokenizer,
    *,
    mode: str = "abstract",  # "abstract": abstract↔cited ref (data_loaders.py:520-598)
    # "related": abstract↔related_work           (data_loaders.py:428-517)
    query_max_length: int = 256,
    mips_max_length: int = 256,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Positive pairs for contrastive retriever pretraining."""
    rng = np.random.default_rng(seed)
    queries, positives = [], []
    for _, item in df.iterrows():
        if mode == "related":
            queries.append(item["abstract"])
            positives.append(strip_cites(item["related_work"]))
        else:
            refs = [a for a in item["ref_abstract"]["abstract"] if a != ""]
            if not refs:
                continue
            queries.append(item["abstract"])
            positives.append(refs[rng.integers(0, len(refs))])
    q = query_tokenizer(queries, max_length=query_max_length)
    m = mips_tokenizer(positives, max_length=mips_max_length)
    return {
        "query_input_ids": q["input_ids"],
        "query_attention_mask": q["attention_mask"],
        "mips_input_ids": m["input_ids"],
        "mips_attention_mask": m["attention_mask"],
    }


@dataclasses.dataclass
class RAGDataModule:
    """End-to-end host pipeline: corpus build + tokenize + batch iterator."""

    df: pd.DataFrame
    tokenizer: Any
    query_tokenizer: Any
    corpus_column: str = "ref_abstract"
    # MIPS corpus selector (reference mips_dataset, model_config.py:58 /
    # mips.py:167-182): "multi_x_science" builds from df via
    # corpus_column; "arxiv2" / "arxiv_x_science" load arxiv_path parquet
    # (data_loaders.py:129-191)
    mips_dataset: str = "multi_x_science"
    arxiv_path: str | None = None
    max_length: int = 1024
    query_max_length: int = 256
    decoder_max_length: int = 256
    memory_len: int = 128
    source_memory: bool = False
    doc_sep: str = "<DOC_SEP>"
    prompt_prefix: str = ""
    dual_memory: bool = False
    cache_dir: str | None = None  # offline tokenized-arrays cache

    def _cache_key(self) -> str:
        """Fingerprint of everything that determines the tokenized arrays
        (the reference tokenizes once to Arrow and reloads,
        sotasum/data_modules.py:84,268 — this is the npz equivalent)."""
        import hashlib

        tok_id = getattr(
            getattr(self.tokenizer, "tok", None), "name_or_path",
            f"hash:{getattr(self.tokenizer, 'vocab_size', 0)}",
        )
        qtok_id = getattr(
            getattr(self.query_tokenizer, "tok", None), "name_or_path",
            f"hash:{getattr(self.query_tokenizer, 'vocab_size', 0)}",
        )
        h = hashlib.sha256()
        h.update(repr((
            tok_id, qtok_id, self.corpus_column, self.max_length,
            self.query_max_length, self.decoder_max_length, self.memory_len,
            self.source_memory, self.doc_sep, self.prompt_prefix,
            self.dual_memory, len(self.df),
            self.mips_dataset, self.arxiv_path,
        )).encode())
        for col in ("mid", "aid"):
            if col in self.df:
                h.update("".join(map(str, self.df[col])).encode())
        h.update(str(int(self.df["abstract"].str.len().sum())).encode())
        h.update(str(int(self.df["related_work"].str.len().sum())).encode())
        return h.hexdigest()[:16]

    def prepare(self):
        import os

        cache_path = None
        if self.cache_dir:
            cache_path = os.path.join(
                self.cache_dir, f"rag_tok_{self._cache_key()}.npz"
            )
        if self.mips_dataset == "multi_x_science":
            self.corpus = build_mips_corpus(self.df, self.corpus_column)
        elif self.mips_dataset == "arxiv2":
            from .corpus import load_mips_arxiv2

            self.corpus = load_mips_arxiv2(self.arxiv_path)
        elif self.mips_dataset == "arxiv_x_science":
            from .corpus import load_mips_arxiv_x_science

            self.corpus = load_mips_arxiv_x_science(
                self.arxiv_path, self.df, self.corpus_column
            )
        else:
            raise ValueError(
                f"unknown mips_dataset {self.mips_dataset!r} (choices: "
                "multi_x_science, arxiv2, arxiv_x_science)"
            )
        self.aid_vocab = build_aid_vocab(self.df, self.corpus)
        if cache_path and os.path.exists(cache_path):
            data = np.load(cache_path)
            self.store_arrays = {
                k[len("store/"):]: data[k] for k in data.files
                if k.startswith("store/")
            }
            self.examples = {
                k[len("ex/"):]: data[k] for k in data.files
                if k.startswith("ex/")
            }
            return self
        self.store_arrays = prepare_memory_store_arrays(
            self.corpus, self.tokenizer, memory_len=self.memory_len,
            aid_vocab=self.aid_vocab,
        )
        self.examples = prepare_rag_examples(
            self.df, self.corpus, self.tokenizer, self.query_tokenizer,
            max_length=self.max_length,
            query_max_length=self.query_max_length,
            decoder_max_length=self.decoder_max_length,
            doc_sep=self.doc_sep, source_memory=self.source_memory,
            aid_vocab=self.aid_vocab, prompt_prefix=self.prompt_prefix,
            dual_memory=self.dual_memory, memory_len=self.memory_len,
        )
        if cache_path:
            os.makedirs(self.cache_dir, exist_ok=True)
            payload = {f"store/{k}": v for k, v in self.store_arrays.items()}
            payload.update({f"ex/{k}": v for k, v in self.examples.items()})
            np.savez(cache_path, **payload)
        return self

    @property
    def n_examples(self) -> int:
        return len(self.examples["input_ids"])

    @property
    def corpus_size(self) -> int:
        return len(self.store_arrays["token_ids"])

    def split_indices(self, split: str, seed: int = 0) -> np.ndarray:
        """Deterministic 80/10/10 train/val/test partition (the reference
        consumes HF's published splits; the synthetic/flat path derives
        one reproducibly)."""
        n = self.n_examples
        order = np.random.default_rng(seed).permutation(n)
        n_val = max(1, n // 10) if n >= 3 else 0
        if split == "train":
            return order[: n - 2 * n_val] if n_val else order
        if split == "val":
            return order[n - 2 * n_val : n - n_val]
        if split == "test":
            return order[n - n_val :]
        raise ValueError(split)

    def batches(
        self, batch_size: int, *, shuffle: bool = True, seed: int = 0,
        drop_last: bool = True, split: str | None = None, native: bool = True,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Batch iterator over ``split`` (all examples when None). An epoch
        of whole batches is assembled by the native C++ loader
        (`native_loader.native_batches`, the torch-DataLoader-worker analog
        of sotasum/data_modules.py:287-321) unless ``native`` is False; an
        epoch with a ragged tail, or ``native=False``, by the Python
        gather. Both yield the same batches. Unlike the JAX package, a
        loader library that cannot be built raises instead of falling back
        to the Python gather."""
        if split is None:
            order = np.arange(self.n_examples)
        else:
            order = self.split_indices(split)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n = len(order)
        stop = n - (n % batch_size) if drop_last else n
        if native and stop > 0 and stop % batch_size == 0:
            from .native_loader import native_batches

            # created here, so a loader that cannot be built raises before
            # the first batch
            yield from native_batches(self.examples, order[:stop], batch_size)
            return
        for i in range(0, stop, batch_size):
            sel = order[i : i + batch_size]
            yield {k: v[sel] for k, v in self.examples.items()}
