"""Memory-store build: embed the tokenized corpus and index it.

Counterpart of ``encode_corpus`` and ``build_memory_store`` in
``retrieval_augmented_mds_tpu/train/trainer.py`` — the store-build path of
``predict``. The train step, losses and index refresh come with the
training port.
"""

from __future__ import annotations

import torch

from ..index import build_index_from_factory
from ..models.longformer import longformer_encode
from ..models.retriever_generator import MemoryStore, RAGConfig


@torch.no_grad()
def encode_corpus(
    enc_params,
    enc_cfg,
    token_ids: torch.Tensor,  # [N, L]
    token_mask: torch.Tensor,
    *,
    batch_size: int = 64,
    dtype=torch.float32,
) -> torch.Tensor:
    """CLS embeddings [N, H] f32, in batches of ``batch_size`` rows (the
    last one ragged: rows are encoded independently)."""
    outs = []
    for i in range(0, token_ids.shape[0], batch_size):
        hid = longformer_encode(enc_params, enc_cfg, token_ids[i:i + batch_size],
                                token_mask[i:i + batch_size], dtype=dtype)
        outs.append(hid[:, 0].float())
    return torch.cat(outs, dim=0)


def build_memory_store(
    params,
    model_cfg: RAGConfig,
    index_cfg,
    *,
    token_ids: torch.Tensor,
    token_mask: torch.Tensor,
    row_aids: torch.Tensor | None = None,
    compute_dtype=torch.float32,
    batch_size: int | None = None,
) -> MemoryStore:
    """Embed the corpus under the mips encoder and build the configured
    index. ``index_cfg`` is duck-typed (factory/metric/normalize/dtype)."""
    emb = encode_corpus(
        params.mips_encoder, model_cfg.mips_enc, token_ids, token_mask,
        batch_size=batch_size or min(64, token_ids.shape[0]), dtype=compute_dtype,
    )
    index = build_index_from_factory(
        emb, index_cfg.factory, metric=index_cfg.metric,
        normalize=index_cfg.normalize, dtype=index_cfg.dtype,
    )
    return MemoryStore(index=index, token_ids=token_ids, token_mask=token_mask,
                       row_aids=row_aids)
