#!/usr/bin/env python3
"""Dissect the walk of the port's MIPS kernels K1 (`mips_topk`) and K10
(`mips_chunkmax`) on one NVIDIA GPU: build copies of their sources with one
part of the tensor-core tile's walk cut out (its products, its loads after
the first slabs, its epilogue, K1's offers) and time K1 and K10 at B = 256
with each; what is left is what the cut part does not cost. Their results
are wrong by construction and not checked.

    python3 tools/torch_mips_dissect.py

Shape: K1's serving shape, B = 256, N = 131072, D = 768 bf16, k = 10 (K10
with a bias and 8 ignored ids, as chip_smoke.py times it). Every copy runs
on the layout the wrappers plan for the uncut sources. Times are CUDA
events, mean of 10 launches after 2, queued behind device sleep
(chip_smoke.cuda_ms). Prints the card's name and power limit, the
registers and spills of each build, and one line per cut.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops import cuda_build  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops import mips_topk as m  # noqa: E402


def build_copy(edits) -> dict:
    """Both MIPS kernels built from a copy of csrc/ with ``edits`` ((file,
    text, replacement), each text required) → {kernel: library path}."""
    import shutil
    import tempfile

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR)
    shutil.rmtree(src)
    shutil.copytree(cuda_build.CSRC_DIR, src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        text = open(path).read()
        assert old in text, old
        open(path, "w").write(text.replace(old, new))
    procs = {}
    for kern in ("mips_topk", "mips_chunkmax"):
        out = os.path.join(src, f"{kern}.so")
        procs[kern] = (out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
             os.path.join(src, f"{kern}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for kern, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kern}: {err[-3000:]}")
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", err)]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", err)]
        print(f"[build] {kern} ({len(edits)} edits): registers {min(regs)}-{max(regs)}, "
              f"spill stores {max(spills)} bytes at most")
        libs[kern] = out
    return libs


def load_copy(libs) -> None:
    import ctypes

    for kern, path in libs.items():
        cuda_build._loaded[kern] = ctypes.CDLL(path)


CUTS = (("whole walk", None, None, None),
        ("no products", "mips_tile.cuh",
         "mma_slab<ET, NQ>(acc, stage);", ";"),
        ("no loads after the first slabs", "mips_tile.cuh", "issue(step + kStages - 1);",
         "cp_async_commit();"),
        # with no epilogue the products are dead code, and ptxas drops them
        ("no epilogue", "mips_tile.cuh",
         "epilogue(acc, row_begin + (step / n_slab) * S::ROWS, stage);", ";"),
        ("K1: no offers", "mips_topk.cu", "if (!__syncthreads_or(any)) return;",
         "if (!__syncthreads_or(any) || true) return;"),
        # every part (no threshold ever rises) runs the loop over its staged
        # scores, which offers nothing
        ("K1: the loop over staged scores in every part, no offers", "mips_topk.cu",
         "if (b < B && admits(qi, s, again)) offer(qi, b, base + r, s);",
         "if (b < B && admits(qi, s, again)) flags[1] = 0;"))


def dissect() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((256, 768), generator=g, device="cuda")
    e = torch.randn((131072, 768), generator=g, device="cuda").to(torch.bfloat16)
    rb = torch.randn(131072, generator=g, device="cuda")
    ign = torch.randint(-1, 131072, (256, 8), generator=g, device="cuda", dtype=torch.int32)
    libs = [build_copy([] if f is None else [(f, old, new)]) for _, f, old, new in CUTS]
    for (name, *_), paths in zip(CUTS, libs):
        load_copy(paths)
        ms1 = chip_smoke.cuda_ms(lambda: m.mips_topk(q, e, 10))
        ms10 = chip_smoke.cuda_ms(lambda: m.mips_chunkmax(q, e, rb, ign))
        print(f"[dissect] {name}: K1 B=256 {ms1:.3f} ms, K10 {ms10:.3f} ms")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dissect()


if __name__ == "__main__":
    main()
