"""Tokenization front end.

Counterpart of ``retrieval_augmented_mds_tpu/data/tokenizer.py``, owned by
the port (no JAX). The reference leans on HF/Rust tokenizers (SURVEY.md §2.3 #5) — the right
call on TPU too: tokenization stays on host, feeding fixed-shape device
batches. `load_tokenizer` wraps HF `AutoTokenizer` when weights/caches are
available; `HashTokenizer` is the hermetic fallback (deterministic word
hashing) used by tests and offline development so the entire pipeline runs
with zero network egress.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np


class HashTokenizer:
    """Deterministic word-level hash tokenizer with the special-token
    layout of the RoBERTa/LED family (bos=0, pad=1, eos=2, unk=3)."""

    def __init__(self, vocab_size: int = 512, doc_sep: str = "<DOC_SEP>"):
        self.vocab_size = vocab_size
        self.bos_id, self.pad_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.doc_sep = doc_sep
        self.doc_sep_id = vocab_size - 1
        self._word = re.compile(r"\S+")

    def _tok(self, w: str) -> int:
        if w == self.doc_sep:
            return self.doc_sep_id
        h = 2166136261
        for c in w.encode():
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        return 4 + (h % (self.vocab_size - 5))

    def __call__(
        self,
        texts: str | Sequence[str],
        max_length: int = 128,
        add_special_tokens: bool = True,
    ) -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        b = len(texts)
        ids = np.full((b, max_length), self.pad_id, np.int32)
        mask = np.zeros((b, max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self._tok(w) for w in self._word.findall(t)]
            if add_special_tokens:
                toks = [self.bos_id] + toks[: max_length - 2] + [self.eos_id]
            else:
                toks = toks[:max_length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(
            f"<{i}>" for i in ids if i not in (self.bos_id, self.pad_id, self.eos_id)
        )

    def batch_decode(self, batch) -> list[str]:
        return [self.decode(row) for row in batch]


class HFTokenizerWrapper:
    """Uniform fixed-shape interface over a HF tokenizer."""

    def __init__(self, tok, doc_sep: str = "<DOC_SEP>"):
        self.tok = tok
        if doc_sep not in tok.get_vocab():
            tok.add_special_tokens({"additional_special_tokens": [doc_sep]})
        self.doc_sep = doc_sep
        self.doc_sep_id = tok.convert_tokens_to_ids(doc_sep)
        self.vocab_size = len(tok)
        self.bos_id = tok.bos_token_id or 0
        self.pad_id = tok.pad_token_id or 1
        self.eos_id = tok.eos_token_id or 2

    def __call__(self, texts, max_length=128, add_special_tokens=True):
        out = self.tok(
            list(texts) if not isinstance(texts, str) else [texts],
            padding="max_length",
            truncation=True,
            max_length=max_length,
            add_special_tokens=add_special_tokens,
            return_tensors="np",
        )
        return {
            "input_ids": out["input_ids"].astype(np.int32),
            "attention_mask": out["attention_mask"].astype(np.int32),
        }

    def decode(self, ids):
        return self.tok.decode(
            [i for i in ids if i != self.pad_id], skip_special_tokens=True
        )

    def batch_decode(self, batch):
        return [self.decode(row) for row in batch]


def load_tokenizer(
    name_or_path: str | None,
    vocab_size: int = 512,
    doc_sep: str = "<DOC_SEP>",
    fallback: str = "error",  # "error" | "hash"
):
    """HF tokenizer for an explicit name; hash tokenizer when name is None.

    A named tokenizer that fails to load RAISES by default — a typo'd model
    name must not silently train garbage through the toy hash tokenizer.
    Pass ``fallback="hash"`` (config `data.tokenizer_fallback: hash`) to
    keep the old dev-friendly behavior, which then warns loudly.
    """
    if name_or_path:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(name_or_path)
            return HFTokenizerWrapper(tok, doc_sep)
        except Exception as e:  # noqa: BLE001
            if fallback != "hash":
                raise RuntimeError(
                    f"tokenizer {name_or_path!r} failed to load "
                    f"({type(e).__name__}: {e}). Set `data.tokenizer: null` "
                    "for the hermetic hash tokenizer, or "
                    "`data.tokenizer_fallback: hash` to fall back on load "
                    "failure."
                ) from e
            import warnings

            warnings.warn(
                f"[tokenizer] FALLING BACK to the toy hash tokenizer: "
                f"{name_or_path!r} failed to load ({type(e).__name__}: {e})",
                stacklevel=2,
            )
    return HashTokenizer(vocab_size=vocab_size, doc_sep=doc_sep)
