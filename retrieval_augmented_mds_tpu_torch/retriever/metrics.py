"""Retriever ranking metrics: recall, reciprocal rank, average precision.

Counterpart of ``retrieval_augmented_mds_tpu/retriever/metrics.py``, both
variants:

* `retriever_metrics`: the reference's semantics, quirk included: the
  reciprocal rank is 1 / argmax(hits), so a rank-1 hit (argmax 0) and a
  row with no hit (argmax 0 too) both count 0. Kept for comparisons with
  the reference's numbers.
* `retriever_metrics_fixed`: the intended reciprocal rank 1 / (first hit
  + 1), 0 for a row with no hit. The train steps and the retriever's
  validation log this one.
"""

from __future__ import annotations

import torch


def _recall_ap(pred: torch.Tensor, counts: torch.Tensor):
    recall = (pred.sum(-1) / counts).mean()
    ranks = torch.arange(1, pred.shape[-1] + 1, dtype=torch.float32, device=pred.device)
    ap = (((pred.cumsum(-1) / ranks) * pred).sum(-1) / counts).mean()
    return recall, ap


def retriever_metrics(pred: torch.Tensor, counts: torch.Tensor) -> dict:
    """pred: [B, k] {0,1} hit matrix in rank order; counts: [B] gold set
    sizes. Returns 0-d f32 tensors."""
    pred = pred.float()
    counts = counts.float().clamp(min=1)
    recall, ap = _recall_ap(pred, counts)
    am = pred.argmax(-1).float()
    rr = torch.where(am == 0, torch.zeros_like(am), 1.0 / torch.where(am == 0, 1.0, am))
    return {"recall": recall, "reciprocal_rank": rr.mean(), "average_precision": ap}


def retriever_metrics_fixed(pred: torch.Tensor, counts: torch.Tensor) -> dict:
    """As `retriever_metrics`, with the reciprocal rank 1 / (first hit + 1)."""
    pred = pred.float()
    counts = counts.float().clamp(min=1)
    recall, ap = _recall_ap(pred, counts)
    first = pred.argmax(-1).float()
    rr = torch.where((pred > 0).any(-1), 1.0 / (first + 1.0), torch.zeros_like(first))
    return {"recall": recall, "reciprocal_rank": rr.mean(), "average_precision": ap}


def hits_from_aids(retrieved_aids: torch.Tensor, gold_aid: torch.Tensor) -> torch.Tensor:
    """[B, k] hit matrix from the aid lists [B, k, A] of the retrieved rows
    and each query's gold aid [B]: a hit where the row lists the gold aid."""
    return (retrieved_aids == gold_aid[:, None, None]).any(-1)
