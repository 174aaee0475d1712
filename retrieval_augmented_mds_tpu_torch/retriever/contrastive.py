"""Dual-encoder retriever pretraining: in-batch InfoNCE plus an optional
bag-of-words auxiliary loss.

Counterpart of ``retrieval_augmented_mds_tpu/retriever/contrastive.py``:
two Longformer encoders (the query side and the index side), CLS pooling
in f32 with an optional projection to ``pooling_dim``, and the in-batch
contrastive loss: scores = query_cls @ mips_cls.T / temperature against the
diagonal. With ``token_loss`` each side's CLS also reconstructs the other
side's tokens through a projection and the encoder's tied token table.
One device: the JAX package's ``gather_axis`` (negatives gathered over a
mesh) has no counterpart, and asking for it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..models.config import EncoderConfig
from ..models.core import Dense, build_module, dense
from ..models.longformer import Longformer, longformer_encode


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """Same fields and defaults as the JAX package's RetrieverConfig."""

    query_enc: EncoderConfig
    mips_enc: EncoderConfig
    temperature: float = 1.0
    pooling_dim: int | None = None
    token_loss: bool = False


class BOW(nn.Module):
    """The bag-of-words head: a projection; the output table is tied to the
    encoder's token table."""

    def __init__(self, d_model: int):
        super().__init__()
        self.proj = Dense(d_model, d_model)


class Retriever(nn.Module):
    """Parameter tree of `init_retriever`: the two encoders, the pooled
    projections when ``pooling_dim`` is set, the BOW heads when
    ``token_loss`` is."""

    def __init__(self, cfg: RetrieverConfig):
        super().__init__()
        self.query_encoder = Longformer(cfg.query_enc)
        self.mips_encoder = Longformer(cfg.mips_enc)
        if cfg.pooling_dim:
            self.query_proj = Dense(cfg.query_enc.d_model, cfg.pooling_dim)
            self.mips_proj = Dense(cfg.mips_enc.d_model, cfg.pooling_dim)
        if cfg.token_loss:
            self.query_bow = BOW(cfg.query_enc.d_model)
            self.mips_bow = BOW(cfg.mips_enc.d_model)


def init_retriever(cfg: RetrieverConfig, generator: torch.Generator, device=None) -> Retriever:
    """Random init with the JAX package's shapes and distributions (normal x
    0.02 kernels and tables, zero biases, LayerNorm 1/0), drawn from
    ``generator`` on its device (or ``device``)."""
    return build_module(lambda: Retriever(cfg), generator, device)


def bow_loss(bow: BOW, emb_table: torch.Tensor, cls: torch.Tensor, label_ids: torch.Tensor,
             attention_mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """Bag-of-words reconstruction of the OTHER side's tokens [B, L] from a
    CLS [B, H]: the summed NLL of every token but bos, eos and padding under
    softmax(proj(cls) @ emb_table.T), averaged over the batch."""
    logits = dense(bow.proj, cls).float() @ emb_table.float().T
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, 1, label_ids.long().clamp(min=0))
    drop = (label_ids == cfg.bos_id) | (label_ids == cfg.eos_id) | (attention_mask == 0)
    nll = torch.where(drop, torch.zeros_like(nll), nll)
    return nll.sum(-1).mean()


def retriever_forward(params: Retriever, cfg: RetrieverConfig, batch: dict[str, Any], *,
                      dtype=torch.float32):
    """(query_cls [B, P], mips_cls [B, P]) in f32."""
    qh = longformer_encode(params.query_encoder, cfg.query_enc, batch["query_input_ids"],
                           batch["query_attention_mask"], dtype=dtype)
    mh = longformer_encode(params.mips_encoder, cfg.mips_enc, batch["mips_input_ids"],
                           batch["mips_attention_mask"], dtype=dtype)
    q, m = qh[:, 0].float(), mh[:, 0].float()
    if cfg.pooling_dim:
        q = dense(params.query_proj, q)
        m = dense(params.mips_proj, m)
    return q, m


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def contrastive_loss(params: Retriever, cfg: RetrieverConfig, batch: dict[str, Any], *,
                     dtype=torch.float32, gather_axis: str | None = None, mesh=None):
    """InfoNCE (+ BOW) → (loss, metrics): ``sentence_loss``, ``token_loss``
    (with ``token_loss``), ``train_accuracy`` (the in-batch top-1 of the
    normalised scores, the first index on ties) and ``loss``, as 0-d
    tensors, the metrics detached.

    ``gather_axis="data"`` with a ``mesh`` (this rank holding its rows of
    the batch): the mips embeddings of every data rank are all-gathered,
    with their gradient, as the global in-batch negatives, and this rank's
    targets are offset by its position (the JAX package's ``all_gather``
    over the axis). The loss and metrics are this rank's rows'; their mean
    over ``data`` is the global batch's."""
    q, m = retriever_forward(params, cfg, batch, dtype=dtype)
    offset = 0
    m_all = m
    if gather_axis is not None:
        if gather_axis != "data" or mesh is None:
            raise ValueError(f"gather_axis={gather_axis!r} needs the mesh's 'data' axis "
                             "and the mesh")
        from ..parallel.collectives import gather_cat

        m_all = gather_cat(m, mesh.data_group)
        offset = mesh.d * q.shape[0]
    scores = (q @ m_all.T) / cfg.temperature
    target = torch.arange(q.shape[0], device=q.device) + offset
    loss = F.cross_entropy(scores, target)
    metrics: dict[str, torch.Tensor] = {"sentence_loss": loss.detach()}
    if cfg.token_loss:
        # the query's tokens from the mips CLS, and the reverse
        ql = bow_loss(params.query_bow, params.query_encoder.tok_emb.table, m,
                      batch["query_input_ids"], batch["query_attention_mask"], cfg.query_enc)
        ml = bow_loss(params.mips_bow, params.mips_encoder.tok_emb.table, q,
                      batch["mips_input_ids"], batch["mips_attention_mask"], cfg.mips_enc)
        metrics["token_loss"] = (ql + ml).detach()
        loss = loss + ql + ml
    with torch.no_grad():
        hit = (_normalize(q) @ _normalize(m_all).T).argmax(-1) == target
        metrics["train_accuracy"] = hit.float().mean()
    metrics["loss"] = loss.detach()
    return loss, metrics
