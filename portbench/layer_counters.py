"""The program's own counters that the per-layer metrics read: each
hand-written kernel's wrapper counts its launches in ``.launches``."""

from __future__ import annotations


def wrappers() -> dict:
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import ivf_probe_topk
    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        flash_dense_attention,
        flash_dense_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import flash_sliding_attention
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import flash_sliding_backward
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk

    return {f.__name__: f for f in (flash_sliding_attention, flash_sliding_backward,
                                    flash_dense_attention, flash_dense_backward,
                                    mips_topk, ivf_probe_topk)}


def launches() -> dict[str, int]:
    return {name: f.launches for name, f in wrappers().items()}
