"""Retriever ranking metrics: recall, reciprocal rank, average precision.

Counterpart of `retriever_metrics_fixed` in
``retrieval_augmented_mds_tpu/retriever/metrics.py``: the intended
reciprocal rank 1 / (first hit + 1), 0 for a row with no hit. The train
step logs these against each query's gold article id. (The reference's
quirk-exact `retriever_metrics` comes with the retriever port.)
"""

from __future__ import annotations

import torch


def retriever_metrics_fixed(pred: torch.Tensor, counts: torch.Tensor) -> dict:
    """pred: [B, k] {0,1} hit matrix in rank order; counts: [B] gold set
    sizes. Returns 0-d f32 tensors."""
    pred = pred.float()
    counts = counts.float().clamp(min=1)
    recall = (pred.sum(-1) / counts).mean()
    first = pred.argmax(-1).float()
    rr = torch.where((pred > 0).any(-1), 1.0 / (first + 1.0), torch.zeros_like(first))
    ranks = torch.arange(1, pred.shape[-1] + 1, dtype=torch.float32, device=pred.device)
    ap = (((pred.cumsum(-1) / ranks) * pred).sum(-1) / counts).mean()
    return {"recall": recall, "reciprocal_rank": rr.mean(), "average_precision": ap}
