#!/usr/bin/env python3
"""The MIPS kernels (K1, K10, K8) in every dtype and the retriever slice of
chip_smoke.py on one NVIDIA GPU, for any tree of the port.

    python3 tools/torch_mips_f32_ab.py [--tree DIR] [--out FILE.json] [--no-slice]
    python3 tools/torch_mips_f32_ab.py --compare A.json B.json

The cases and the slice are this file's tree's ``chip_smoke.py``; the
port's package (and so its kernels, built into ``DIR/build/``) comes from
DIR, this tree by default. For an A/B, unpack the other tree with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one call, each with its own ``--out``, then ``--compare`` the
files. A run prints the card's name and power limit, then chip_smoke's
lines: the f32 K1 cases (``f32_bias_ignore``, ``f32_k128``,
``retriever_val``, ``retriever_val_l2``, ``serving_f32``) and f32 K10
cases (``serving_f32``, ``ragged_f32``) checked against their plain
versions (a bit-equal rerun; K10's scores at K1's hits), with their
kernel and plain times and both bounds (split TF32 and the f32 CUDA
cores); bf16 and int8 K1 and bf16 K10 at their timed shapes; K8 on a
random clustered payload of each type (1024 clusters of 1536 rows, D =
768, B = 4 and 16, nprobe 32), timed; then the retriever slice (its step
and validation wall times, metrics, launches). ``--out`` keeps a SHA-256
of every K1, K10 and K8 output on the digest inputs below, and the
slice's validation metrics and wall times; ``--compare`` says which
outputs two runs share bit for bit (the bf16 and int8 ones should: the
f32 change leaves them alone) and prints both runs' validations.
"""

from __future__ import annotations

import argparse
import json
import os

from torch_ab_common import HERE, digest, start

# digest inputs: (name, B, N, D, dtype, bias and 4 ignored ids)
K1_INPUTS = [("serving", 256, 131072, 768, "bfloat16", False),
             ("bias_ignore", 64, 100003, 768, "bfloat16", True),
             ("sq8", 64, 65613, 768, "int8", False),
             ("odd_d", 17, 4099, 50, "int8", True),
             ("odd_d", 17, 4099, 50, "bfloat16", True),
             ("retriever_val", 1997, 1997, 768, "float32", False),
             ("retriever_val_l2", 1997, 1997, 769, "float32", True),
             ("serving", 256, 131072, 768, "float32", True)]
K10_INPUTS = [("serving", 256, 131072, 768, "bfloat16", True),
              ("ragged", 37, 777, 50, "bfloat16", True),
              ("serving", 256, 131072, 768, "float32", True),
              ("ragged", 37, 777, 50, "float32", True)]
K8_C, K8_L, K8_D, K8_NPROBE, K8_K = 1024, 1536, 768, 32, 10


def _inputs(seed, b, n, d, dtype, extras):
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import quantize_corpus_sq8

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, d), generator=g, device="cuda")
    e = torch.randn((n, d), generator=g, device="cuda")
    scale = None
    if dtype == "int8":
        e, scale = quantize_corpus_sq8(e)
    else:
        e = e.to(getattr(torch, dtype))
    rb = ign = None
    if extras:
        rb = torch.randn(n, generator=g, device="cuda")
        ign = torch.randint(-1, n, (b, 4), generator=g, device="cuda", dtype=torch.int32)
    return q, e, rb, ign, scale


def output_digests() -> dict:
    """SHA-256 of K1's, K10's and K8's outputs on the digest inputs."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import ivf_probe_topk
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_chunkmax, mips_topk

    out = {}
    for i, (name, b, n, d, dtype, extras) in enumerate(K1_INPUTS):
        q, e, rb, ign, scale = _inputs(100 + i, b, n, d, dtype, extras)
        vals, ids = mips_topk(q, e, 10, rb, ign, scale)
        out[f"K1 {name} {dtype} vals"], out[f"K1 {name} {dtype} ids"] = digest(vals), digest(ids)
    for i, (name, b, n, d, dtype, extras) in enumerate(K10_INPUTS):
        q, e, rb, ign, _ = _inputs(200 + i, b, n, d, dtype, extras)
        scores, cmax = mips_chunkmax(q, e, rb, ign)
        out[f"K10 {name} {dtype} scores"] = digest(scores)
        out[f"K10 {name} {dtype} cmax"] = digest(cmax)
    for dtype in ("int8", "bfloat16", "float32"):
        for b in (4, 16):
            args = _k8_inputs(dtype, b)
            vals, pos = ivf_probe_topk(*args, K8_K)
            out[f"K8 B={b} {dtype} vals"], out[f"K8 B={b} {dtype} pos"] = (digest(vals),
                                                                         digest(pos))
            del args
            torch.cuda.empty_cache()
    return out


def _k8_inputs(dtype, b):
    """A random clustered payload (1024 x 1536 rows, the tails of the
    clusters padded with bias -3e38) and each query's 32 distinct probes."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import quantize_corpus_sq8

    g = torch.Generator(device="cuda").manual_seed(300 + b)
    x = torch.randn((K8_C * K8_L, K8_D), generator=g, device="cuda")
    scale = None
    if dtype == "int8":
        x, scale = quantize_corpus_sq8(x)
        scale = scale.reshape(K8_C, K8_L)
    else:
        x = x.to(getattr(torch, dtype))
    fill = torch.randint(K8_L // 2, K8_L + 1, (K8_C, 1), generator=g, device="cuda")
    bias = torch.where(torch.arange(K8_L, device="cuda")[None, :] < fill, 0.0, -3.0e38)
    q = torch.randn((b, K8_D), generator=g, device="cuda")
    probes = torch.stack([torch.randperm(K8_C, generator=g, device="cuda")[:K8_NPROBE]
                          for _ in range(b)]).to(torch.int32)
    return q, x.reshape(K8_C, K8_L, K8_D), bias.float(), scale, probes


def time_k8(c) -> None:
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_topk,
        ivf_probe_topk_plain,
    )

    for dtype in ("int8", "bfloat16", "float32"):
        for b in (4, 16):
            args = _k8_inputs(dtype, b)
            err, tol, swapped = c._k8_check(f"random {dtype} B={b}", args, K8_K)
            ms = c.cuda_ms(lambda: ivf_probe_topk(*args, K8_K))
            plain_ms = c.cuda_ms(lambda: ivf_probe_topk_plain(*args, K8_K), reps=3, warmup=1)
            print(f"[K8] random {dtype} B={b} nprobe={K8_NPROBE}: PASS ({swapped} swapped "
                  f"near-ties within {tol:.3e}; max abs err {err:.3e}); kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms")
            del args


def run(tree: str, out_path: str | None, slice_: bool) -> None:
    c = start(tree, "torch_mips_f32_ab")

    import torch

    def case(fn, *args, **kw):  # a failed check is printed, and the run goes on
        try:
            fn(*args, **kw)
        except c.SmokeFailure as e:
            print(f"[ab] FAIL: {e}")

    f32, bf16 = torch.float32, torch.bfloat16
    case(c._k1_case, "f32_bias_ignore", 64, 100003, 768, 10, f32, bias=True, ignore=True,
         timed=True)
    case(c._k1_case, "f32_k128", 16, 20000, 256, 128, f32, bias=True, ignore=True)
    case(c._k1_case, "retriever_val", 1997, 1997, 768, 10, f32, timed=True)
    case(c._k1_case, "retriever_val_l2", 1997, 1997, 769, 10, f32, bias=True, timed=True)
    case(c._k1_case, "serving_f32", 256, 131072, 768, 10, f32, timed=True)
    case(c._k10_case, "serving_f32", 256, 131072, 768, 10, f32, timed=True)
    case(c._k10_case, "ragged_f32", 37, 777, 50, 7, f32)
    case(c._k1_case, "serving", 256, 131072, 768, 10, bf16, timed=True)
    case(c._k1_case, "sq8", 64, 65613, 768, 10, "int8", timed=True)
    case(c._k10_case, "serving", 256, 131072, 768, 10, bf16, timed=True)
    time_k8(c)
    digests = output_digests()
    report: dict = {}
    if slice_:
        c.phase_retriever_slice(report)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"tree": tree, "digests": digests, "val": report.get("val"),
                       "val_s": report.get("val_s")}, f, indent=1)
        print(f"[ab] {len(digests)} output digests and the validations -> {out_path}")


def compare(a_path: str, b_path: str) -> None:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    print(f"[compare] {a['tree']} ({a_path}) vs {b['tree']} ({b_path})")
    for dtype in ("float32", "bfloat16", "int8"):
        keys = [k for k in a["digests"] if f" {dtype} " in k]
        same = [k for k in keys if a["digests"][k] == b["digests"].get(k)]
        print(f"[compare] {dtype}: {len(same)} of {len(keys)} outputs bit-equal"
              + (f"; differ: {sorted(set(keys) - set(same))}" if len(same) < len(keys) else ""))
    print(f"[compare] retriever validations {a['val']} in {a['val_s']} s vs {b['val']} in "
          f"{b['val_s']} s: metrics {'equal' if a['val'] == b['val'] else 'DIFFER'}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="root of the tree whose port to run")
    ap.add_argument("--out", help="write the outputs' digests and the validations here")
    ap.add_argument("--no-slice", action="store_true", help="skip the retriever slice")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files instead of running")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(os.path.abspath(args.tree), args.out, not args.no_slice)


if __name__ == "__main__":
    main()
