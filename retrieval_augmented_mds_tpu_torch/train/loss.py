"""Label-smoothed NLL losses: the four variants of the reference.

Counterpart of ``retrieval_augmented_mds_tpu/train/loss.py``, with the
same semantics and quirks. The trainer uses the "transformers" variant,
which takes NEGATED log-probs; `summarization_loss` wraps that calling
convention.
"""

from __future__ import annotations

import torch


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.long()[..., None])[..., 0]


def _masked(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def label_smoothed_nll_loss_copy(lprobs, target, epsilon, ignore_index=None, sum=True):
    """The "copy-is-all-you-need" variant → (loss, nll)."""
    nll = -_gather_last(lprobs, target.clamp(min=0))
    smooth = -lprobs.sum(dim=-1)
    if ignore_index is not None:
        keep = target != ignore_index
        nll, smooth = _masked(nll, keep), _masked(smooth, keep)
    if sum:
        nll, smooth = nll.sum(), smooth.sum()
    eps_i = epsilon / lprobs.shape[-1]
    return (1.0 - epsilon) * nll + eps_i * smooth, nll


def label_smoothed_nll_loss_fairseq(lprobs, target, epsilon, ignore_index=None,
                                    reduce=True):
    """The fairseq variant → (loss, nll)."""
    nll = -_gather_last(lprobs, target.clamp(min=0))
    smooth = -lprobs.sum(dim=-1)
    if ignore_index is not None:
        keep = target != ignore_index
        nll, smooth = _masked(nll, keep), _masked(smooth, keep)
    if reduce:
        nll, smooth = nll.sum(), smooth.sum()
    eps_i = epsilon / (lprobs.shape[-1] - 1)
    return (1.0 - epsilon - eps_i) * nll + eps_i * smooth, nll


def label_smoothed_nll_loss_custom(lprobs, target, epsilon, ignore_index=None,
                                   reduce=None):
    """The custom variant (``reduce`` None, "sum" or "mean") → (loss, nll)."""
    eps_i = epsilon / (lprobs.shape[-1] - 1)
    nll = -_gather_last(lprobs, target.clamp(min=0))
    smooth = -(lprobs * eps_i).sum(dim=-1)
    count = None
    if ignore_index is not None:
        keep = target != ignore_index
        nll, smooth = _masked(nll, keep), _masked(smooth, keep)
        count = keep.sum()
    if reduce == "sum":
        nll, smooth = nll.sum(), smooth.sum()
    elif reduce == "mean":
        nll, smooth = nll.sum() / count, smooth.sum() / count
    return (1.0 - epsilon - eps_i) * nll + smooth, nll


def label_smoothed_nll_loss_transformers(log_probs, labels, epsilon, ignore_index,
                                         group=None):
    """HF LabelSmoother semantics on NEGATED log-probs: the smooth term in
    f32, both terms averaged over the active tokens. With a process
    ``group`` (the mesh's ``data`` group, each member holding its rows of
    the batch) the active tokens are counted over the group's whole batch,
    and each member returns its rows' share of that batch's loss: the
    shares sum to it, weighting every token alike whatever rows a member
    holds."""
    keep = labels != ignore_index
    nll = _masked(_gather_last(log_probs, labels.clamp(min=0)), keep)
    smooth = _masked(log_probs.float().sum(dim=-1), keep)
    n_active = keep.sum()
    if group is not None:
        from ..parallel.collectives import all_reduce

        n_active = all_reduce(n_active, group)
    n_active = n_active.clamp(min=1)
    nll = nll.sum() / n_active
    smooth = smooth.sum() / (n_active * log_probs.shape[-1])
    return (1.0 - epsilon) * nll + epsilon * smooth


def summarization_loss(log_probs, labels, epsilon, pad_id, group=None):
    """The trainer's loss: real log-probs [B, T, V] in, scalar out (with a
    ``group``, this member's share of its whole batch's loss)."""
    v = log_probs.shape[-1]
    return label_smoothed_nll_loss_transformers(
        -log_probs.reshape(-1, v), labels.reshape(-1), epsilon, pad_id, group
    )
