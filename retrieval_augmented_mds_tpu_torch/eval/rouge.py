"""ROUGE evaluation.

Counterpart of ``retrieval_augmented_mds_tpu/eval/rouge.py``, owned by
the port (no JAX). The reference computes ROUGE-1/2/L/Lsum per val/test epoch with HF
`evaluate` (sotasum/lightning_model.py:107-110, 371-381) and selects
checkpoints on max rouge1 (config/no_mips.yaml:31). `evaluate` is not in
the image; `rouge_score` (the same underlying implementation) is — with a
pure-python fallback so eval works even bare."""

from __future__ import annotations

from typing import Sequence


def _lcs(a: list, b: list) -> int:
    m, n = len(a), len(b)
    if not m or not n:
        return 0
    prev = [0] * (n + 1)
    for i in range(m):
        cur = [0] * (n + 1)
        for j in range(n):
            cur[j + 1] = prev[j] + 1 if a[i] == b[j] else max(prev[j + 1], cur[j])
        prev = cur
    return prev[n]


def _ngram_f1(pred: list, ref: list, n: int) -> float:
    from collections import Counter

    pn = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
    rn = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    overlap = sum((pn & rn).values())
    p_tot, r_tot = sum(pn.values()), sum(rn.values())
    if not overlap or not p_tot or not r_tot:
        return 0.0
    p, r = overlap / p_tot, overlap / r_tot
    return 2 * p * r / (p + r)


def _fallback_scores(pred: str, ref: str) -> dict[str, float]:
    pt, rt = pred.lower().split(), ref.lower().split()
    l = _lcs(pt, rt)
    if l and pt and rt:
        p, r = l / len(pt), l / len(rt)
        rl = 2 * p * r / (p + r)
    else:
        rl = 0.0
    return {
        "rouge1": _ngram_f1(pt, rt, 1),
        "rouge2": _ngram_f1(pt, rt, 2),
        "rougeL": rl,
        "rougeLsum": rl,
    }


def rouge_scores(
    predictions: Sequence[str], references: Sequence[str]
) -> dict[str, float]:
    """Mean F1 ROUGE-1/2/L/Lsum over the batch."""
    try:
        from rouge_score import rouge_scorer

        scorer = rouge_scorer.RougeScorer(
            ["rouge1", "rouge2", "rougeL", "rougeLsum"], use_stemmer=True,
            split_summaries=True,
        )
        keys = ["rouge1", "rouge2", "rougeL", "rougeLsum"]
        acc = {k: 0.0 for k in keys}
        for p, r in zip(predictions, references):
            s = scorer.score(r, p)
            for k in keys:
                acc[k] += s[k].fmeasure
    except Exception:
        keys = ["rouge1", "rouge2", "rougeL", "rougeLsum"]
        acc = {k: 0.0 for k in keys}
        for p, r in zip(predictions, references):
            s = _fallback_scores(p, r)
            for k in keys:
                acc[k] += s[k]
    n = max(1, len(predictions))
    return {k: v / n for k, v in acc.items()}


class RougeAccumulator:
    """add_batch/compute interface (reference `rouge.add_batch` pattern,
    sotasum/lightning_model.py:371-381)."""

    def __init__(self):
        self.preds: list[str] = []
        self.refs: list[str] = []

    def add_batch(self, predictions, references):
        self.preds.extend(predictions)
        self.refs.extend(references)

    def compute(self) -> dict[str, float]:
        out = rouge_scores(self.preds, self.refs)
        self.preds, self.refs = [], []
        return out
