#!/usr/bin/env python3
"""The f32 sliding-window kernels (K2, K3) and the retriever slice of
chip_smoke.py on one NVIDIA GPU, for any tree of the port.

    python3 tools/torch_sliding_f32_ab.py [--tree DIR] [--profile-step]

The cases and the slice are this file's tree's ``chip_smoke.py``; the
port's package (and so its kernels, built into ``DIR/build/``) comes from
DIR, this tree by default. For an A/B, unpack the other tree with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one call. Prints the card's name and power limit, then
chip_smoke's lines: each f32 K2/K3 case checked against its plain version
(out, m, l and the gradients within 1e-4 x max|ref|, a bit-equal rerun),
its kernel, plain and SDPA times and both bounds (split TF32 and the f32
CUDA cores); with ``--profile-step``, three steady retriever train steps
(the slice's config, steps 2-4 of its batch draw) under ``torch.profiler``:
the step's wall time with the profiler on, the device time of its
kernels by class (K2, K3, the rest) and the largest kernels; then the
retriever slice (step and validation wall times, peak memory, launches).
"""

from __future__ import annotations

import argparse
import os

from torch_ab_common import HERE, profile_window, start

# this tree's kernel names, or the CUDA-core ones of earlier trees
CLASSES = {"K2": r"sliding_(mma_)?fwd", "K3": r"sliding_(mma_)?d(q|kv)|sum_splits"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="root of the tree whose port to run")
    ap.add_argument("--profile-step", action="store_true",
                    help="profile three retriever train steps")
    args = ap.parse_args()
    c = start(os.path.abspath(args.tree), "torch_sliding_f32_ab")

    import torch

    f32 = torch.float32
    c._k2_case("retriever_train", c.RET_QUERY, f32, library=True)
    c._k2_case("retriever_encode", c.RET_ENCODE, f32, library=True)
    c._k2_case("retriever_fixture", c.RET_FIXTURE, f32, library=True)
    c._k3_case("longformer_query", c.RET_QUERY, f32, library=True)
    c._k3_case("retriever_fixture", c.RET_FIXTURE, f32, model_do=True, library=True)
    if args.profile_step:
        profile_steps(c)
    c.phase_retriever_slice()


def profile_steps(c, steps: int = 3) -> None:
    """Device time of ``steps`` retriever train steps after two warm-up
    ones, by kernel (``torch.profiler``), against their wall time."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu_torch.train.trainer import (
        TrainState,
        make_retriever_train_step,
    )

    cfg = c.led_base_config("retriever_profile")
    dev = torch.device("cuda")
    rcfg, params, pairs = cli._pretrain_setup(cfg, dev)
    t = cfg.train
    tx = build_optimizer(t.lr, t.warmup_steps, t.total_steps, grad_clip=t.grad_clip,
                         mu_dtype=t.adam_mu_dtype)
    state = TrainState.create(params, tx)
    step_fn = make_retriever_train_step(rcfg, tx)
    n = len(pairs["query_input_ids"])

    def step(i):
        nonlocal state
        sel = np.random.default_rng(cfg.seed + i).choice(n, size=cfg.data.batch_size,
                                                         replace=False)
        batch = {k: torch.from_numpy(np.asarray(v)[sel]).to(dev) for k, v in pairs.items()}
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])  # waits for the device

    for i in range(2):
        step(i)
    steady = iter(range(2, 2 + steps))
    profile_window("retriever train step", lambda: step(next(steady)), steps, CLASSES,
                   top=8)


if __name__ == "__main__":
    main()
