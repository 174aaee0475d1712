#!/usr/bin/env python3
"""The dense attention kernels (K4-K7) in both dtypes and the f32 train
slice of chip_smoke.py on one NVIDIA GPU, for any tree of the port.

    python3 tools/torch_dense_f32_ab.py [--tree DIR] [--out FILE.json] [--profile-step]
    python3 tools/torch_dense_f32_ab.py --compare A.json B.json

The cases and the slice are this file's tree's ``chip_smoke.py``; the
port's package (and so its kernels, built into ``DIR/build/``) comes from
DIR, this tree by default. For an A/B, unpack the other tree with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one call, each with its own ``--out``, then ``--compare`` the
files. A run prints the card's name and power limit, then chip_smoke's
lines: each f32 K4-K7 case (``decoder_self``, ``decoder_cross``,
``decoder_cross_fixture``, ``decoder_cross_8k``,
``decoder_cross_16k_fixture``) and each bf16 one checked against its plain version (out, m, l or lse and the gradients, a
bit-equal rerun), its kernel, plain and SDPA times and its bounds (in
f32 both: split TF32 and the f32 CUDA cores); then the f32 train slice
(``[train_f32]``: steady step, phases, peak memory, launches, losses).
With ``--profile-step``, before the slice, the slice's first step and two
steady ones (steps 2-3 of its batch draw, no store refresh) under
``torch.profiler``: each window's wall time, the device time of its
kernels by class (K4, K5, K2, K3, the rest) and its largest kernels.
``--out`` keeps a SHA-256 of every K4-K7 output on the cases' inputs
and the slice's losses; ``--compare`` says which outputs two runs share
bit for bit (the bf16 ones should: the f32 change leaves them alone) and
how far apart their step-0 and step-1 losses are (both before the store
refresh; held to 1e-4 relative).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from torch_ab_common import HERE, digest, profile_window, start

LOSS_RTOL = 1e-4  # f32 steps before the store refresh


def output_digests(c, name, b, t, s, causal, lengths, dtype, blocked) -> dict:
    """SHA-256 of K4/K5 (or K6/K7) outputs on the inputs chip_smoke's case
    of that name makes (its seed, its dO draw)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        flash_dense_attention,
        flash_dense_backward,
        flash_dense_blocked,
        flash_dense_blocked_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import row_delta

    g, q, k, v, kb = c._dense_inputs(b, t, s, lengths, dtype, seed=23 if blocked else 21)
    if blocked:
        out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
        do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
        grads = flash_dense_blocked_backward(q, k, v, kb, out, lse, do, causal=causal)
        outs = {"out": out, "lse": lse}
    else:
        out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
        do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
        grads = flash_dense_backward(q, k, v, kb, do, m, l, row_delta(do, out),
                                     causal=causal)
        outs = {"out": out, "m": m, "l": l}
    outs.update(zip(("dq", "dk", "dv"), grads))
    kernels = ("K6", "K7") if blocked else ("K4", "K5")
    return {f"{kernels[nm[0] == 'd']} {name} {str(dtype)[6:]} {nm}": digest(x)
            for nm, x in outs.items()}


# kernel classes by name: this tree's or the CUDA-core ones of earlier trees
CLASSES = {"K4": r"(?<!sliding_)(mma_fwd|dense_fwd)_kernel",
           "K5": r"(?<!sliding_)(mma|dense)_d(q|kv)_kernel",
           "K2": r"sliding_(mma_)?fwd", "K3": r"sliding_(mma_)?d(q|kv|kvg)_|sum_splits"}


def profile_steps(c, steps: int = 2) -> None:
    """The f32 train slice's first step, then ``steps`` steady ones after
    one more (no store refresh), each window under ``torch.profiler``:
    its wall time per step and the device time of its kernels by class."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = dataclasses.replace(c.train_slice_config(), precision="float32")
    dev = torch.device("cuda")
    dm, _ = cli.build_data(cfg)
    params = cli.build_params(cfg, dev)
    tx = cli.build_tx(cfg, params)
    state = TrainState.create(params, tx)
    store = cli.build_store(state.params, cfg, dm, dev)
    step_fn = make_train_step(cfg.model, tx, cfg.train, dtype=cli.compute_dtype(cfg),
                              remat=cfg.train.remat)
    batches = dm.batches(cfg.data.batch_size, seed=cfg.seed, split="train")

    def step():
        nonlocal state
        state, metrics = step_fn(state, store, cli.device_batch(next(batches), cfg, dev))
        float(metrics["loss"])  # waits for the device

    profile_window("f32 train slice, step 0 (first calls)", step, 1, CLASSES)
    step()
    profile_window(f"f32 train slice, steps 2-{1 + steps}", step, steps, CLASSES)


def run(tree: str, out_path: str | None, profile_step: bool = False) -> None:
    c = start(tree, "torch_dense_f32_ab")

    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    cross = [2048, 1800, 1000, 0]
    # (name, B, T, S, causal, source lengths, dtypes, K6/K7)
    cases = [
        ("decoder_cross", 4, 512, 2048, False, cross, (f32, bf16), False),
        ("decoder_cross_fixture", 4, 512, 2048, False, c.FIXTURE_LENGTHS, (f32, bf16), False),
        ("decoder_self", 4, 512, 512, True, [512] * 4, (f32, bf16), False),
        ("decoder_cross_8k", 2, 256, 8192, False, [8192, 0], (f32,), True),
        ("decoder_cross_16k", 4, 512, 16384, False, [16384, 11000, 3000, 0], (bf16,), True),
        ("decoder_cross_16k_fixture", 4, 512, 16384, False, c.FIXTURE_LENGTHS, (f32, bf16),
         True),
    ]
    digests: dict = {}
    for name, b, t, s, causal, lengths, dtypes, blocked in cases:
        for dtype in dtypes:
            (c._blocked_case if blocked else c._dense_case)(name, b, t, s, causal, lengths,
                                                            dtype)
            digests.update(output_digests(c, name, b, t, s, causal, lengths, dtype, blocked))
    if profile_step:
        profile_steps(c)
    _, summary = c.phase_train_f32_slice()
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"tree": tree, "digests": digests, "losses": summary["losses"]}, f,
                      indent=1)
        print(f"[ab] {len(digests)} output digests and the f32 slice's losses -> {out_path}")


def compare(a_path: str, b_path: str) -> None:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    print(f"[compare] {a['tree']} ({a_path}) vs {b['tree']} ({b_path})")
    for dtype in ("float32", "bfloat16"):
        keys = [k for k in a["digests"] if f" {dtype} " in k]
        same = [k for k in keys if a["digests"][k] == b["digests"].get(k)]
        print(f"[compare] {dtype}: {len(same)} of {len(keys)} outputs bit-equal"
              + (f"; differ: {sorted(set(keys) - set(same))}" if len(same) < len(keys) else ""))
    rel = [abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"])]
    print(f"[compare] f32 slice losses {a['losses']} vs {b['losses']}: rel diff "
          + ", ".join(f"{r:.3e}" for r in rel) + f"; steps 0 and 1 (before the refresh) "
          + ("within" if max(rel[:2]) <= LOSS_RTOL else "NOT within") + f" {LOSS_RTOL}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="root of the tree whose port to run")
    ap.add_argument("--out", help="write the outputs' digests and the losses here")
    ap.add_argument("--profile-step", action="store_true",
                    help="profile the f32 train slice's first and two steady steps")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files instead of running")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(os.path.abspath(args.tree), args.out, args.profile_step)


if __name__ == "__main__":
    main()
