"""Train step, memory-store build and the train-time index refresh.

Counterpart of ``retrieval_augmented_mds_tpu/train/trainer.py``:

* `make_train_step`: the teacher-forced `rag_forward` with gradients
  (the attention kernels K2-K5 on the card), the label-smoothed loss,
  the copy and retriever diagnostics, and one optimizer update
  (`train.optimizer.AdamW`). The step returns the reference's metric
  names. Where the reference returns a new state, the port updates the
  parameters and the optimizer state in place and returns the same
  `TrainState`. Over a mesh (`parallel.mesh`, one process per position)
  each rank runs its rows of the batch, the LED encoder sequence-sharded
  with ``sequence_shard``; its loss is its share of the global batch's
  (the tokens counted over ``data``, the work replicated over ``shard``
  taken 1/S a rank), so every gradient summed over all the ranks is the
  global one, and the metrics are the global batch's.
* `make_retriever_train_step`: the retriever's contrastive step
  (`retriever.contrastive.contrastive_loss` with gradients, then one
  optimizer update), in f32 as the JAX package runs it.
* `encode_corpus` / `build_memory_store`: embed the tokenized corpus under
  the mips encoder and index it (the store-build path of ``predict`` and
  ``fit``).
* `refresh_store`: rebuild the index under the current mips encoder
  weights and swap it in, the reference's stale-index refresh.

Both steps are the program span ``train.step`` (`obs.profiling.span`), with
``train.forward``, ``train.backward``, ``train.reduce`` (over a mesh) and
``train.optimizer`` inside it; the store build is ``store.build``, with
``store.embed`` and ``store.index``.
"""

from __future__ import annotations

import contextlib
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
from ..obs.profiling import span
from ..parallel.collectives import all_reduce, all_reduce_grads
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
    mesh=None,
    data_sharded: bool | None = None,
) -> Callable:
    """Returns ``train_step(state, store, batch, copy_force=None) →
    (state, metrics)``, metrics as 0-d tensors; ``copy_force`` is the
    step's copy-forcing flag under ``target_in`` (`rag_encode`). With
    ``phase_times``, each step synchronises the device between its phases
    and appends ``{"forward", "backward", "optimizer"}`` wall seconds (and
    over a mesh ``"reduce"``, the gradients' all_reduce) to the list. With
    ``retrieved``, each step that searches the store appends its retrieved
    row ids [B, k] (on the device) to that list.

    Over a ``mesh``, ``batch`` is this rank's rows of the global batch
    (`cli.device_batch`) when ``data_sharded`` (default: the mesh has a
    ``data`` size above 1), else the whole batch on every rank. The
    gradients are summed over every rank (`collectives.all_reduce_grads`)
    before the clip; ``tx`` is the optimizer built over the same mesh."""
    remat_context(remat)  # an unsupported policy raises here, not mid-step
    split = mesh is not None and mesh.data > 1 and data_sharded is not False
    # this rank's share of the loss: work replicated over a group counts
    # once over it
    share = 1.0 if mesh is None else 1.0 / (mesh.shard * (1 if split else mesh.data))

    def loss_fn(params, store, batch, copy_force):
        out, aux, enc_out = rag_forward(params, cfg, store, batch, dtype=dtype,
                                        remat=remat, copy_force=copy_force, mesh=mesh,
                                        data_sharded=split)
        if cfg.mips_disabled or enc_out.memory is None:
            log_probs = torch.log_softmax(out, dim=-1)
        else:
            log_probs = out
        loss = summarization_loss(log_probs, batch["labels"],
                                  hyper.label_smoothing_eps, cfg.led.pad_id,
                                  group=mesh.data_group if split else None)
        metrics: dict[str, Any] = {"loss": loss.detach()}
        if retrieved is not None and enc_out.retrieved_idx is not None:
            retrieved.append(enc_out.retrieved_idx.detach())
        with torch.no_grad():
            if aux.get("copy_gate") is not None:
                mask = (batch["labels"] != cfg.led.pad_id)[..., None]
                gate, count = (aux["copy_gate"] * mask).sum(), mask.sum()
                if split:  # a ratio over the global batch
                    gate, count = all_reduce(torch.stack([gate, count.to(gate.dtype)]),
                                             mesh.data_group)
                metrics["copy_gate_mean"] = gate / count.clamp(min=1)
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
            if split:
                # the loss shares sum to the global loss; the other metrics
                # are means over equal shares of the global batch
                names = [k for k in metrics if k != "copy_gate_mean"]
                tot = all_reduce(torch.stack([metrics[k].float() for k in names]),
                                 mesh.data_group)
                for i, k in enumerate(names):
                    metrics[k] = tot[i] if k == "loss" else tot[i] / mesh.data
        return loss, metrics

    def train_step(state: TrainState, store, batch, copy_force=None):
        params = state.params
        times = {} if phase_times is not None else None
        device = next(params.parameters()).device
        with span("train.step"):
            with _phase("forward", times, device):
                loss, metrics = loss_fn(params, store, batch, copy_force)
            with _phase("backward", times, device):
                grads = _backward_grads(params, loss if mesh is None else loss * share)
                named = list(params.named_parameters())
            if mesh is not None:
                with _phase("reduce", times, device):
                    all_reduce_grads(list(grads.values()))
            with _phase("optimizer", times, device):
                with torch.no_grad():
                    metrics["grad_norm"] = _global_norm(grads.values())
                    if hyper.grad_group_norms:
                        for group in dict.fromkeys(param_group(n) for n, _ in named):
                            metrics[f"grad_norm_{group}"] = _global_norm(
                                g for n, g in grads.items() if param_group(n) == group)
                tx.update(params, grads, state.opt_state)
                state.step += 1
        if times is not None:
            phase_times.append(times)
        return state, metrics

    return train_step


@contextlib.contextmanager
def _phase(name: str, times: dict[str, float] | None, device):
    """A phase of a train step: the span ``train.<name>``; with ``times``,
    the device synchronised at its end and its wall seconds in
    ``times[name]``."""
    with span(f"train.{name}"):
        t0 = time.perf_counter()
        yield
        if times is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[name] = time.perf_counter() - t0


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


def make_retriever_train_step(cfg, tx: AdamW, *, gather_axis: str | None = None,
                              mesh=None) -> Callable:
    """Returns ``step(state, batch) → (state, metrics)``: the contrastive
    loss in f32 with autograd (the token table gets gradient through the
    encoder and, with ``token_loss``, through the tied BOW logits), then
    one update of ``tx``. Metrics are `contrastive_loss`'s, as 0-d
    tensors. With ``gather_axis="data"`` and a ``mesh`` (``batch`` this
    rank's rows): the negatives are gathered over ``data``, the loss is
    the mean over the data ranks of theirs (each rank's gradient 1/D of
    its own, summed over every rank), and the metrics are those means."""
    from ..retriever.contrastive import contrastive_loss

    def step(state: TrainState, batch):
        with span("train.step"):
            with span("train.forward"):
                loss, metrics = contrastive_loss(state.params, cfg, batch,
                                                 gather_axis=gather_axis, mesh=mesh)
            with span("train.backward"):
                grads = _backward_grads(state.params, loss if gather_axis is None
                                        else loss / (mesh.data * mesh.shard))
            if gather_axis is not None:
                with span("train.reduce"):
                    all_reduce_grads(list(grads.values()))
                    names = sorted(metrics)
                    tot = all_reduce(torch.stack([metrics[k] for k in names]),
                                     mesh.data_group)
                    metrics = {k: tot[i] / mesh.data for i, k in enumerate(names)}
            with span("train.optimizer"):
                tx.update(state.params, grads, state.opt_state)
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
    mesh=None,
) -> torch.Tensor:
    """CLS embeddings [N, H] f32, in batches of ``batch_size`` rows (the
    last one ragged: rows are encoded independently). Over a ``mesh`` whose
    ``data`` size D divides the batch size, data rank d embeds rows
    [d·bs/D, (d+1)·bs/D) of every batch (the last one padded with its first
    row), and the slices are gathered over ``data``: every rank returns all
    N rows."""
    n = token_ids.shape[0]
    split = mesh is not None and mesh.splits_batch(batch_size)
    per, first, pad = batch_size, 0, 0
    if split:
        per = batch_size // mesh.data
        first, pad = mesh.d * per, (-n) % batch_size
    if pad:
        token_ids = torch.cat([token_ids, token_ids[:1].expand(pad, -1)])
        token_mask = torch.cat([token_mask, token_mask[:1].expand(pad, -1)])
    outs = []
    for i in range(first, n + pad, batch_size):
        hid = longformer_encode(enc_params, enc_cfg, token_ids[i:i + per],
                                token_mask[i:i + per], dtype=dtype)
        outs.append(hid[:, 0].float())
    if not split:
        return torch.cat(outs, dim=0)
    from ..parallel.collectives import gather_stack

    mine = torch.stack(outs)  # [batches, bs / D, H]
    # [D, batches, bs / D, H] → batch-major rows
    every = gather_stack(mine, mesh.data_group).transpose(0, 1)
    return every.reshape(-1, every.shape[-1])[:n]


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
    mesh=None,
) -> MemoryStore:
    """Embed the corpus under the mips encoder and build the configured
    index. ``index_cfg`` is duck-typed (factory/metric/normalize/nprobe/
    train_size/dtype); ``seed`` draws the IVF k-means sample. Over a
    ``mesh`` the corpus is embedded data-parallel and the index placed
    sharded over ``shard``; the token ids and masks stay whole on every
    rank."""
    with span("store.build"):
        with span("store.embed"):
            emb = encode_corpus(
                params.mips_encoder, model_cfg.mips_enc, token_ids, token_mask,
                batch_size=batch_size or min(64, token_ids.shape[0]), dtype=compute_dtype,
                mesh=mesh,
            )
        with span("store.index"):
            index = build_index_from_factory(
                emb, index_cfg.factory, metric=index_cfg.metric,
                normalize=index_cfg.normalize, dtype=index_cfg.dtype,
                train_size=index_cfg.train_size, seed=seed, mesh=mesh,
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
    mesh=None,
) -> MemoryStore:
    """Re-embed the corpus under the CURRENT mips encoder and return a new
    store (the caller swaps it in); ``index_cfg`` pins the factory knobs,
    else they are recovered from ``store``. Same path as the first build,
    so a refresh under equal weights equals a fresh build. The store's
    ``nprobe`` is kept. Over a ``mesh``, the corpus is embedded
    data-parallel and the new index placed sharded, as the first build
    (`build_memory_store`; ``index_cfg`` is then needed, a sharded store
    not recording its factory)."""
    n = store.index.n
    new = build_memory_store(
        params, cfg, index_cfg or _index_cfg_from_store(store),
        token_ids=store.token_ids[:n], token_mask=store.token_mask[:n],
        row_aids=store.row_aids, seed=seed, compute_dtype=dtype,
        batch_size=batch_size, mesh=mesh,
    )
    return MemoryStore(index=new.index, token_ids=store.token_ids,
                       token_mask=store.token_mask, row_aids=store.row_aids,
                       nprobe=store.nprobe)
