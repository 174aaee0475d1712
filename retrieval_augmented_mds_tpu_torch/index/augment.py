"""MIPS→L2 φ-augmentation (compatibility / testing transform).

Counterpart of ``retrieval_augmented_mds_tpu/index/augment.py``. The
reference's "SpeedUp" trick (Bachrach et al., theorem 5; see
sotasum/mips.py:52-70) appends one column so that L2 search over the
augmented corpus equals inner-product search over the original. The
port's search takes a per-row bias, so L2 and IP are the same kernel; the
transform is kept for the reference's index format and as the oracle of
the L2↔IP equivalence.
"""

from __future__ import annotations

import torch


def corpus_phi(corpus: torch.Tensor) -> torch.Tensor:
    """φ = max squared norm over the corpus (sotasum/mips.py:316-331)."""
    return (corpus.float() ** 2).sum(dim=-1).max()


def augment_corpus(corpus: torch.Tensor, phi=None):
    """Append sqrt(φ − ‖x‖²) column (reference `augment_xb`, mips.py:55-63).

    Returns (augmented [N, D+1] f32, phi)."""
    x = corpus.float()
    norms = (x ** 2).sum(dim=-1)
    if phi is None:
        phi = norms.max()
    extra = torch.sqrt(torch.clamp(phi - norms, min=0.0))
    return torch.cat([x, extra[:, None]], dim=-1), phi


def augment_queries(queries: torch.Tensor) -> torch.Tensor:
    """Append a zero column (reference `augment_xq`, mips.py:66-70)."""
    x = queries.float()
    return torch.cat([x, torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)],
                     dim=-1)
