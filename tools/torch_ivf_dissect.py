#!/usr/bin/env python3
"""Dissect kernel K8 (`ivf_probe_topk`, the per-query IVF probe top-k) on
one NVIDIA GPU, and hold it against another tree's K8 in the same process.

    python3 tools/torch_ivf_dissect.py [--other DIR]

Shape: the IVF indexes of chip_smoke.py's K8 phase (1,048,576 rows of the
``bench-index`` Gaussian mixture, D = 768, IVF1024 with L = 1536, SQ8 and
bf16), B = 4 and 16 queries, nprobe = 32, k = 10, the probes the route
computes. For each case it times (CUDA events, chip_smoke.cuda_ms) K8 as
the wrapper runs it and copies of its source with one part cut out:

* pass 1 alone (no merge launch);
* loads alone (pass 1 with no products and no selection);
* the products with the loads cut (pass 1 multiplying the first stages
  over and over; no merge);
* pass 1 without the selection (loads, products and the staged scores);
* pass 1 built for 2 CTAs an SM (up to 128 registers a thread);
* pass 1 without its L2 prefetch of the next 128 bytes of each row;
* the whole kernel with the score tile's int8 widening swapped (in
  csrc/mips_tile.cuh, which K1 shares): the I2F conversion the tile had
  before, and one 4-byte load a row for a lane's four k-slots (dims 4t ..
  4t + 3 into slots 2t, 2t + 1, 2t + 8, 2t + 9, the query's dims permuted
  within each 16 to match); their positions must equal the whole kernel's;

and, with torch.profiler, the device time of each kernel of one call (pass
1, the merge, the query copy before them), and the whole per-query route
(`ivf_search_serving`) on it, with a hash of the route's ids. Results of cut copies
are wrong by construction and not checked. Then, at B = 4, 8, 16 and 31
(31 x 32 probes is the most the per-query route sends to 1024 clusters),
the whole kernel with its row splits forced to each of 1, 2, 3, 4, 6, 8
and 12, beside the splits `_plan` picks.

``--other DIR``: the root of a tree whose csrc/ivf_probe_topk.cu is K8's
earlier design (one CTA per (query, probe, 256-row slice), one merge CTA
per query, entry point ``ivf_probe_topk_launch(q, clustered, dtype, bias,
scale, probes, B, P, L, D, k, splits, part_v, part_i, out_v, out_i,
stream)``). Its kernel is built from that tree's sources, cut the same
way, and timed in turns with this tree's (other, this, this, other); its
positions must equal this tree's in every case. Prints the card's name
and power limit, the registers and spills of each build, and one line per
timing.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from retrieval_augmented_mds_tpu_torch.index import ivf_serving as serving  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops import cuda_build  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (  # noqa: E402
    _DTYPE_CODE,
    _kernel_layout,
    _query_dtype,
)

LAUNCH, OP = serving._ivf_probe_topk_launch, serving._ivf_probe_topk_op


def WRAPPER(q, clustered, bias, scale, probes, k):
    """K8 as `ivf_probe_topk` runs it on the card, without the custom op's
    dispatch: the checks, the query in the kernel's type, the launch."""
    serving._check_k8(q, clustered, bias, scale, probes, k)
    return LAUNCH(q.to(_query_dtype(clustered)), clustered, bias, scale, probes, k)

I2F_WIDEN = "int8 widened by I2F"
WORD_WIDEN = "int8 read as one word a lane, query permuted"
NO_MERGE = ("ivf_probe_topk.cu", "  ivf::ivf_merge_kernel<<<B, ivf::kThreads, 0, s>>>(",
            "  if (0) ivf::ivf_merge_kernel<<<B, ivf::kThreads, 0, s>>>(")
# this tree's design: (name, edits)
CUTS = (
    ("whole", ()),
    ("pass 1 alone", (NO_MERGE,)),
    ("loads alone", (NO_MERGE, (
        "ivf_probe_topk.cu", "      if (step % n_slab != n_slab - 1) continue;",
        "      continue;"), (
        "ivf_probe_topk.cu", "        mips::mma_slab<ET, kNQ>(acc.a, stage);", "        ;"), (
        "ivf_probe_topk.cu", "        fma_slab(acc.a, stage);", "        ;"))),
    ("products, loads cut", (NO_MERGE, (
        "ivf_probe_topk.cu", "      issue(step + mips::kStages - 1);",
        "      cp_async_commit();"),)),
    ("pass 1 without selection", (NO_MERGE, (
        "ivf_probe_topk.cu", "      sel.take_tile(st, row0, n, pbase, any);",
        "      __syncthreads();"),)),
    # up to 128 registers a thread: 2 CTAs an SM
    ("pass 1, 2 CTAs an SM", (NO_MERGE, (
        "ivf_probe_topk.cu", "constexpr int kCtasPerSm = 3;", "constexpr int kCtasPerSm = 2;"),)),
    ("pass 1 without the L2 prefetch", (NO_MERGE, (
        "ivf_probe_topk.cu", "cp.async.cg.shared.global.L2::256B", "cp.async.cg.shared.global"),)),
    (I2F_WIDEN, ((
        "mips_tile.cuh",
        "  widen4(pair(p), a[0], a[2]);\n  widen4(pair(p + 8 * LD), a[1], a[3]);",
        "  auto i2f = [](const char* x) {\n"
        "    const uint16_t u = *reinterpret_cast<const uint16_t*>(x);\n"
        "    return pack_bf16(static_cast<float>(static_cast<int8_t>(u & 0xff)),\n"
        "                     static_cast<float>(static_cast<int8_t>(u >> 8)));\n"
        "  };\n"
        "  a[0] = i2f(p);\n  a[1] = i2f(p + 8 * LD);\n"
        "  a[2] = i2f(p + 8);\n  a[3] = i2f(p + 8 * LD + 8);"),)),
    (WORD_WIDEN, ((
        "mips_tile.cuh",
        "  const char* p = es + (r0 + g) * LD + kk * 16 + 2 * t;",
        "  const char* p = es + (r0 + g) * LD + kk * 16 + 4 * t;"), (
        "mips_tile.cuh",
        "  widen4(pair(p), a[0], a[2]);\n  widen4(pair(p + 8 * LD), a[1], a[3]);",
        "  widen4(*reinterpret_cast<const uint32_t*>(p), a[0], a[2]);\n"
        "  widen4(*reinterpret_cast<const uint32_t*>(p + 8 * LD), a[1], a[3]);"))),
)
# the earlier design's cuts
OTHER_NO_MERGE = ("ivf_probe_topk.cu", "  ivf_merge_kernel<<<B, kThreads, 0, s>>>(",
                  "  if (0) ivf_merge_kernel<<<B, kThreads, 0, s>>>(")
OTHER_CUTS = (
    ("whole", ()),
    ("pass 1 alone", (OTHER_NO_MERGE,)),
    ("loads alone", (OTHER_NO_MERGE, (
        "ivf_probe_topk.cu",
        "acc[u] = Chunk<ET>::dot(raw[u], qs + c * E, acc[u]);",
        "acc[u] += __uint_as_float(raw[u].x ^ raw[u].y ^ raw[u].z ^ raw[u].w);"))),
    ("products, loads cut", (OTHER_NO_MERGE, (
        "ivf_probe_topk.cu", "__ldg(rows + (long)(r0 + u) * cpr + c)",
        "make_uint4(c, r0 + u, cpr, lane)"),)),
)


def build(csrc: str, edits) -> str:
    """csrc/ivf_probe_topk.cu of ``csrc`` with ``edits`` ((file, text,
    replacement), each text required) built into a library → its path."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR)
    shutil.rmtree(src)
    shutil.copytree(csrc, src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        text = open(path).read()
        assert old in text, old
        open(path, "w").write(text.replace(old, new))
    return src


def compile_all(jobs: dict) -> dict:
    """{key: source dir} → {key: library path}, one nvcc each, together."""
    procs = {}
    for key, src in jobs.items():
        out = os.path.join(src, "ivf_probe_topk.so")
        procs[key] = (out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
             os.path.join(src, "ivf_probe_topk.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}: {err[-3000:]}")
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", err)] or [0]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", err)]
        print(f"[build] {key[0]} / {key[1]}: registers {min(regs)}-{max(regs)}, spill "
              f"stores {max(spills)} bytes at most")
        libs[key] = out
    return libs


def this_call(lib: str, permute_query: bool = False):
    """K8 through this tree's wrapper, on the library ``lib``; with
    ``permute_query`` slot 8h + 2t + e of each 16 query dims holds dim
    4t + 2h + e (what `WORD_WIDEN`'s fragments take)."""
    handle = ctypes.CDLL(lib)

    def call(q, *args):
        cuda_build._loaded["ivf_probe_topk"] = handle
        if permute_query:
            b, d = q.shape
            q = q.reshape(b, d // 16, 4, 2, 2).transpose(2, 3).reshape(b, d)
        return WRAPPER(q, *args)
    return call


def forced_splits(call, splits: int):
    """``call`` with `_plan` replaced by ``splits`` splits of whole tiles."""
    plan = serving._plan

    def forced(b, p, L, sms, layout):
        tile = layout()[1]
        rows = -(-(-(-L // tile)) // splits) * tile
        return rows, -(-L // rows)

    def run(*args):
        serving._plan = forced
        try:
            return call(*args)
        finally:
            serving._plan = plan
    return run


def other_call(lib: str):
    """K8 of the earlier design, called as its wrapper did."""
    fn = ctypes.CDLL(lib).ivf_probe_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5

    def call(q, clustered, bias, scale, probes, k):
        b, d = q.shape
        L, p = clustered.shape[1], probes.shape[1]
        qk = q.to(torch.bfloat16 if clustered.dtype != torch.float32 else torch.float32)
        qk = qk.float().contiguous()
        splits = -(-L // 256)
        part_v = torch.empty((b, p * splits, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((b, p * splits, k), dtype=torch.int32, device=q.device)
        vals = torch.empty((b, k), dtype=torch.float32, device=q.device)
        pos = torch.empty((b, k), dtype=torch.int32, device=q.device)
        code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[clustered.dtype]
        err = fn(qk.data_ptr(), clustered.data_ptr(), code, bias.data_ptr(),
                 None if scale is None else scale.data_ptr(), probes.data_ptr(), b, p, L, d,
                 k, splits, part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                 pos.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other K8 failed with cudaError_t={err}")
        return vals, pos
    return call


def split_line(call, args) -> str:
    times = chip_smoke.device_ms_by_kernel(lambda: call(*args, chip_smoke.K8_K))
    parts = sorted(times.items(), key=lambda kv: -kv[1])
    return ", ".join(f"{name[:48]} {ms:.4f}" for name, ms in parts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of a tree with K8's earlier design")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False

    jobs = {("this", name): build(cuda_build.CSRC_DIR, edits) for name, edits in CUTS}
    if opts.other:
        other_csrc = os.path.join(opts.other, "retrieval_augmented_mds_tpu_torch", "csrc")
        jobs.update({("other", name): build(other_csrc, edits) for name, edits in OTHER_CUTS})
    libs = compile_all(jobs)
    calls = {key: this_call(lib, key[1] == WORD_WIDEN) if key[0] == "this"
             else other_call(lib) for key, lib in libs.items()}

    from retrieval_augmented_mds_tpu_torch.cli import gaussian_mixture
    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        build_ivf_index,
        prepare_queries,
        probe_clusters,
    )

    t0 = time.perf_counter()
    x_np, q_np = gaussian_mixture(chip_smoke.K8_N, chip_smoke.K8_D, 16, seed=0)
    # 16 more queries drawn the same way, for the split sweep at B = 31
    rng = np.random.default_rng(1)
    more = x_np[rng.integers(0, len(x_np), 16)] \
        + 0.1 * rng.standard_normal((16, x_np.shape[1])).astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    queries = torch.from_numpy(np.concatenate([q_np, more])).cuda()
    print(f"[data] {chip_smoke.K8_N} x {chip_smoke.K8_D} in {time.perf_counter() - t0:.1f} s")
    k = chip_smoke.K8_K
    for payload in ("int8", "bfloat16"):
        idx = build_ivf_index(x, chip_smoke.K8_C, dtype=payload, alpha=1.5,
                              train_size=65536, seed=0, keep_flat=False)
        for b in (4, 8, 16, 31):
            q = prepare_queries(idx, queries[:b])
            probes = probe_clusters(idx, q, chip_smoke.K8_NPROBE).to(torch.int32).contiguous()
            args = (q, idx.clustered, idx.clustered_bias, idx.clustered_scale, probes)
            n_probed = int(torch.unique(probes).numel())
            what = f"{payload} B={b} ({n_probed} distinct clusters of {probes.numel()})"
            ref = calls["this", "whole"](*args, k)
            planned = serving._plan(b, probes.shape[1], idx.clustered.shape[1],
                                    torch.cuda.get_device_properties(0).multi_processor_count,
                                    lambda: _kernel_layout("ivf_probe_topk", 0,
                                                           _DTYPE_CODE[idx.clustered.dtype], k))
            for splits in (1, 2, 3, 4, 6, 8, 12):
                run = forced_splits(calls["this", "whole"], splits)
                got = run(*args, k)
                assert torch.equal(got[1], ref[1]), f"{what}: {splits} splits differ"
                ms = chip_smoke.cuda_ms(lambda: run(*args, k))
                print(f"[splits] {what}: {splits} splits {ms:.4f} ms "
                      f"(_plan: {planned[1]} of {planned[0]} rows)")
            if b not in (4, 16):
                continue
            if payload == "int8":
                for widen in (I2F_WIDEN, WORD_WIDEN):
                    got = calls["this", widen](*args, k)
                    assert torch.equal(got[1], ref[1]), f"{what}: {widen} positions differ"
                    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-4)
                turn = [("this", "whole"), ("this", I2F_WIDEN), ("this", WORD_WIDEN)]
                for key in turn * 2 + turn[::-1] * 2:
                    ms = chip_smoke.cuda_ms(lambda: calls[key](*args, k))
                    print(f"[widen] {what} {key[1]}: {ms:.4f} ms")
            if opts.other:
                got = calls["other", "whole"](*args, k)
                torch.cuda.synchronize()
                assert torch.equal(got[1], ref[1]), f"{what}: positions differ"
                print(f"[equal] {what}: this tree's positions equal the other tree's")
                order = [("other", "whole"), ("this", "whole"), ("this", "whole"),
                         ("other", "whole")]
            else:
                order = [("this", "whole")] * 2
            for key in order:
                ms = chip_smoke.cuda_ms(lambda: calls[key](*args, k))
                print(f"[time] {what} {key[0]} whole: {ms:.4f} ms")
            for key in order:  # the whole per-query route on either K8
                serving._ivf_probe_topk_op = calls[key]
                ms = chip_smoke.cuda_ms(lambda: serving.ivf_search_serving(
                    idx, queries[:b], k=k, nprobe=chip_smoke.K8_NPROBE))
                ids = serving.ivf_search_serving(idx, queries[:b], k=k,
                                                 nprobe=chip_smoke.K8_NPROBE)[1]
                serving._ivf_probe_topk_op = OP
                print(f"[route] {what} on {key[0]}'s K8: {ms:.4f} ms, ids "
                      f"{hash(tuple(ids.flatten().tolist())) & 0xffffffff:08x}")
            for key in [key for key in calls if key[1] != "whole"]:
                ms = chip_smoke.cuda_ms(lambda: calls[key](*args, k))
                print(f"[time] {what} {key[0]} {key[1]}: {ms:.4f} ms")
            for tree in ("this", "other") if opts.other else ("this",):
                print(f"[profile] {what} {tree}: {split_line(calls[tree, 'whole'], args)}")
        del idx
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
