"""Train step, memory-store build and the train-time index refresh.

Counterpart of ``retrieval_augmented_mds_tpu/train/trainer.py``:

* `make_train_step`: the teacher-forced `rag_forward` with gradients
  (the attention kernels K2-K5 on the card), the label-smoothed loss,
  the copy and retriever diagnostics, and one optimizer update
  (`train.optimizer.AdamW`). The step returns the reference's metric
  names. Where the reference returns a new state, the port updates the
  parameters and the optimizer state in place and returns the same
  `TrainState`.
* `make_retriever_train_step`: the retriever's contrastive step
  (`retriever.contrastive.contrastive_loss` with gradients, then one
  optimizer update), in f32 as the JAX package runs it.
* `encode_corpus` / `build_memory_store`: embed the tokenized corpus under
  the mips encoder and index it (the store-build path of ``predict`` and
  ``fit``).
* `refresh_store`: rebuild the index under the current mips encoder
  weights and swap it in, the reference's stale-index refresh.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, Callable

import torch
from torch import nn

from ..index import build_index_from_factory
from ..index.ivf import IVFIndex
from ..models.core import remat_context
from ..models.longformer import longformer_encode
from ..models.retriever_generator import MemoryStore, RAGConfig, rag_forward
from .loss import summarization_loss
from .optimizer import AdamW, OptState, param_group


@dataclasses.dataclass
class TrainState:
    params: nn.Module  # a RAG, or a Retriever for its pretraining
    opt_state: OptState
    step: int

    @staticmethod
    def create(params: nn.Module, tx: AdamW) -> "TrainState":
        return TrainState(params=params, opt_state=tx.init(params), step=0)


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(
    cfg: RAGConfig,
    tx: AdamW,
    hyper,
    *,
    dtype=torch.float32,
    remat: bool | str = False,
    phase_times: list[dict[str, float]] | None = None,
    retrieved: list[torch.Tensor] | None = None,
) -> Callable:
    """Returns ``train_step(state, store, batch, copy_force=None) →
    (state, metrics)``, metrics as 0-d tensors. With ``phase_times``, each
    step synchronises the device between its phases and appends
    ``{"forward", "backward", "optimizer"}`` wall seconds to the list. With
    ``retrieved``, each step that searches the store appends its retrieved
    row ids [B, k] (on the device) to that list."""
    remat_context(remat)  # an unsupported policy raises here, not mid-step

    def loss_fn(params, store, batch):
        out, aux, enc_out = rag_forward(params, cfg, store, batch, dtype=dtype,
                                        remat=remat)
        if cfg.mips_disabled or enc_out.memory is None:
            log_probs = torch.log_softmax(out, dim=-1)
        else:
            log_probs = out
        loss = summarization_loss(log_probs, batch["labels"],
                                  hyper.label_smoothing_eps, cfg.led.pad_id)
        metrics: dict[str, Any] = {"loss": loss.detach()}
        if retrieved is not None and enc_out.retrieved_idx is not None:
            retrieved.append(enc_out.retrieved_idx.detach())
        with torch.no_grad():
            if aux.get("copy_gate") is not None:
                mask = (batch["labels"] != cfg.led.pad_id)[..., None]
                metrics["copy_gate_mean"] = ((aux["copy_gate"] * mask).sum()
                                             / mask.sum().clamp(min=1))
                metrics["copy_probs_mass"] = aux["copy_probs"].sum(-1).mean()
            if enc_out.mips_scores is not None:
                metrics["mips_score_mean"] = enc_out.mips_scores.mean()
            if (enc_out.retrieved_idx is not None and store is not None
                    and store.row_aids is not None and "gold_aid" in batch):
                from ..retriever.metrics import retriever_metrics_fixed

                r_aids = store.row_aids[enc_out.retrieved_idx.clamp(min=0).long()]
                hits = (r_aids == batch["gold_aid"][:, None, None]).any(-1)
                counts = batch.get("aid_counts", torch.ones_like(batch["gold_aid"]))
                rm = retriever_metrics_fixed(hits, counts)
                metrics.update({f"retriever_{k}": v for k, v in rm.items()})
        return loss, metrics

    def mark(times: dict, name: str, t0: float, device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        times[name] = t1 - t0
        return t1

    def train_step(state: TrainState, store, batch, copy_force=None):
        if copy_force is not None:
            raise NotImplementedError(
                "copy_force (memory_forcing='target_in') is not ported yet "
                "(ROADMAP queue 1: memory forcing)")
        params = state.params
        device = next(params.parameters()).device
        times: dict[str, float] = {}
        t0 = time.perf_counter()
        loss, metrics = loss_fn(params, store, batch)
        if phase_times is not None:
            t0 = mark(times, "forward", t0, device)
        grads = _backward_grads(params, loss)
        named = list(params.named_parameters())
        if phase_times is not None:
            t0 = mark(times, "backward", t0, device)
        with torch.no_grad():
            metrics["grad_norm"] = _global_norm(grads.values())
            if hyper.grad_group_norms:
                for group in dict.fromkeys(param_group(n) for n, _ in named):
                    metrics[f"grad_norm_{group}"] = _global_norm(
                        g for n, g in grads.items() if param_group(n) == group)
        tx.update(params, grads, state.opt_state)
        state.step += 1
        if phase_times is not None:
            mark(times, "optimizer", t0, device)
            phase_times.append(times)
        return state, metrics

    return train_step


def _backward_grads(params, loss) -> dict[str, torch.Tensor]:
    """Every parameter's gradient of ``loss`` by name (zeros where none
    reaches it), with the parameters' ``.grad`` left empty."""
    for p in params.parameters():
        p.grad = None
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return grads


def make_retriever_train_step(cfg, tx: AdamW) -> Callable:
    """Returns ``step(state, batch) → (state, metrics)``: the contrastive
    loss in f32 with autograd (the token table gets gradient through the
    encoder and, with ``token_loss``, through the tied BOW logits), then
    one update of ``tx``. Metrics are `contrastive_loss`'s, as 0-d
    tensors."""
    from ..retriever.contrastive import contrastive_loss

    def step(state: TrainState, batch):
        loss, metrics = contrastive_loss(state.params, cfg, batch)
        tx.update(state.params, _backward_grads(state.params, loss), state.opt_state)
        state.step += 1
        return state, metrics

    return step


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
    seed: int = 0,
    compute_dtype=torch.float32,
    batch_size: int | None = None,
) -> MemoryStore:
    """Embed the corpus under the mips encoder and build the configured
    index. ``index_cfg`` is duck-typed (factory/metric/normalize/nprobe/
    train_size/dtype); ``seed`` draws the IVF k-means sample."""
    emb = encode_corpus(
        params.mips_encoder, model_cfg.mips_enc, token_ids, token_mask,
        batch_size=batch_size or min(64, token_ids.shape[0]), dtype=compute_dtype,
    )
    index = build_index_from_factory(
        emb, index_cfg.factory, metric=index_cfg.metric,
        normalize=index_cfg.normalize, dtype=index_cfg.dtype,
        train_size=index_cfg.train_size, seed=seed,
    )
    return MemoryStore(index=index, token_ids=token_ids, token_mask=token_mask,
                       row_aids=row_aids, nprobe=index_cfg.nprobe)


def _index_cfg_from_store(store: MemoryStore):
    """The factory knobs an existing store was built with."""
    idx = store.index
    if isinstance(idx, IVFIndex):
        factory = f"IVF{idx.n_clusters},{'Flat' if idx.clustered_scale is None else 'SQ8'}"
        dtype = str(idx.clustered.dtype)
    else:
        factory = "Flat"
        dtype = "int8" if idx.row_scale is not None else str(idx.embeddings.dtype)
    return types.SimpleNamespace(factory=factory, metric=idx.metric,
                                 normalize=idx.normalized, nprobe=store.nprobe,
                                 train_size=None, dtype=dtype.replace("torch.", ""))


def refresh_store(
    params,
    cfg: RAGConfig,
    store: MemoryStore,
    *,
    index_cfg=None,
    batch_size: int = 64,
    dtype=torch.float32,
    seed: int = 0,
) -> MemoryStore:
    """Re-embed the corpus under the CURRENT mips encoder and return a new
    store (the caller swaps it in); ``index_cfg`` pins the factory knobs,
    else they are recovered from ``store``. Same path as the first build,
    so a refresh under equal weights equals a fresh build. The store's
    ``nprobe`` is kept."""
    n = store.index.n
    new = build_memory_store(
        params, cfg, index_cfg or _index_cfg_from_store(store),
        token_ids=store.token_ids[:n], token_mask=store.token_mask[:n],
        row_aids=store.row_aids, seed=seed, compute_dtype=dtype,
        batch_size=batch_size,
    )
    return MemoryStore(index=new.index, token_ids=store.token_ids,
                       token_mask=store.token_mask, row_aids=store.row_aids,
                       nprobe=store.nprobe)
