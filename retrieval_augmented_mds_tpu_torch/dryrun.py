"""One full train step of the tiny RAG model over a (data, shard) mesh.

    torchrun --nproc-per-node 4 -m retrieval_augmented_mds_tpu_torch.dryrun [--device cpu]

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: the
world of N processes forms the mesh (shard 2 when N is even, data the
rest); the tiny preset's parameters are drawn from a seed; a 64-row store
(embeddings and token ids drawn from a numpy seed, the JAX package's
draws in its order) is indexed ``IVF8,SQ8``, cluster-partitioned over
``shard``; the LED encoder runs sequence-sharded when ``shard`` > 1; the
batch holds 2 rows a data rank; the optimizer state (AdamW, bf16 mu) is
ZeRO-sharded over ``data``. One step; the loss must be finite. Rank 0
prints ``dryrun_multichip OK: mesh=(D x S) loss=... step=1``.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

N_ROWS, MEM_LEN, SRC_LEN, QUERY_LEN, TGT_LEN = 64, 64, 128, 64, 8
FACTORY = "IVF8,SQ8"


def tiny_inputs(cfg, batch: int) -> dict[str, np.ndarray]:
    """The store's embeddings and token ids and a batch of ``batch`` rows,
    drawn from ``numpy.random.default_rng(0)`` in the JAX package's order."""
    rng = np.random.default_rng(0)
    h = cfg.query_enc.d_model
    out = {"emb": rng.standard_normal((N_ROWS, h)).astype(np.float32),
           "ids": rng.integers(4, cfg.mips_enc.vocab_size, (N_ROWS, MEM_LEN)).astype(np.int32)}
    v = cfg.led.vocab_size
    out["labels"] = rng.integers(4, v - 2, (batch, TGT_LEN)).astype(np.int32)
    out["input_ids"] = rng.integers(4, v - 2, (batch, SRC_LEN)).astype(np.int32)
    out["query_input_ids"] = rng.integers(4, cfg.query_enc.vocab_size,
                                          (batch, QUERY_LEN)).astype(np.int32)
    return out


def dryrun(device: str = "cuda", *, params=None, index_arrays: dict | None = None,
           index_static: dict | None = None) -> dict:
    """Form the mesh over the running world, take one train step →
    {"loss", "step", "mesh": (data, shard), "metrics"}. ``params`` (a
    parameter tree of the JAX package's layout, numpy leaves) and
    ``index_arrays``/``index_static`` (an IVF index's arrays and static
    fields) replace the seeded draws, so that a caller can hold the step to
    the JAX package's on the same inputs."""
    from .bridge import ivf_index_from_arrays, load_jax_params
    from .index import build_index_from_factory
    from .models.led import shift_tokens_right
    from .models.retriever_generator import MemoryStore, RAGConfig, init_rag
    from .parallel import MeshSpec, make_mesh
    from .parallel.mesh import world_size
    from .train.optimizer import build_optimizer
    from .train.trainer import TrainState, make_train_step
    from .utils.config import TrainHyper

    n = world_size()
    shard = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(MeshSpec(n // shard, shard), device)
    dev = mesh.device
    cfg = RAGConfig.tiny(sequence_shard=shard > 1)
    model = init_rag(cfg, torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(model, params)
    model = model.to(dev)
    host = tiny_inputs(cfg, 2 * mesh.data)
    if index_arrays is None:
        index = build_index_from_factory(torch.from_numpy(host["emb"]).to(dev), FACTORY,
                                         mesh=mesh)
    else:
        index = ivf_index_from_arrays(index_arrays, device=dev, mesh=mesh, **index_static)
    store = MemoryStore(index=index, token_ids=torch.from_numpy(host["ids"]).to(dev),
                        token_mask=torch.ones((N_ROWS, MEM_LEN), dtype=torch.int32,
                                              device=dev))
    rows = mesh.data_rows(2 * mesh.data)
    labels = torch.from_numpy(host["labels"][rows]).to(dev)
    b = labels.shape[0]
    batch = {
        "input_ids": torch.from_numpy(host["input_ids"][rows]).to(dev),
        "attention_mask": torch.ones((b, SRC_LEN), dtype=torch.int32, device=dev),
        "query_input_ids": torch.from_numpy(host["query_input_ids"][rows]).to(dev),
        "query_attention_mask": torch.ones((b, QUERY_LEN), dtype=torch.int32, device=dev),
        "labels": labels,
        "decoder_input_ids": shift_tokens_right(labels, cfg.led.pad_id, cfg.led.bos_id),
    }
    hyper = TrainHyper(lr=1e-4, warmup_steps=10, total_steps=100)
    tx = build_optimizer(hyper.lr, hyper.warmup_steps, hyper.total_steps,
                         grad_clip=hyper.grad_clip, mesh=mesh)
    state = TrainState.create(model, tx)
    state, metrics = make_train_step(cfg, tx, hyper, mesh=mesh)(state, store, batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun: loss {loss} on rank {mesh.rank}")
    return {"loss": loss, "step": state.step, "mesh": (mesh.data, mesh.shard),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="retrieval_augmented_mds_tpu_torch.dryrun")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out = dryrun(args.device)
    rank = torch.distributed.get_rank()
    torch.distributed.destroy_process_group()
    if rank == 0:
        data, shard = out["mesh"]
        print(f"dryrun_multichip OK: mesh=({data}x{shard}) loss={out['loss']:.4f} "
              f"step={out['step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
