#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. environment: the card's name and power limit, torch/CUDA/nvcc
     versions; builds every CUDA kernel of
     ``retrieval_augmented_mds_tpu_torch/csrc`` (one nvcc each, in parallel).
  2. kernel K1 (MIPS top-k) against its plain PyTorch version, each case
     run twice (bit-equal), with the worst case of its selection: scores
     that rise with the row index, so that every score passes its
     threshold; f32 (split TF32 on the score tile) at the serving shape
     too, beside both f32 bounds, its ids equal to plain's but where a
     near-tie swaps two rows (`_near_tie_swaps`);
  3. kernel K2 (sliding-window local rows, forward) against its plain version;
  4. kernel K3 (its backward) against the plain backward, at the LED and
     Longformer shapes of the train step;
  5. kernels K4/K5 (dense attention rows, forward and backward) against
     their plain versions, at the decoder's self and cross shapes; then
     K6/K7 (the same rows over a long source, with one log-sum-exp per
     row) at the long-source slice's cross shape (S = 16384, a source of
     length 0 among them) and at S = 8192 in f32, and K2/K3 at the LED
     shape of that slice (T = 16384); K2-K7 also at the fixture's own
     padding (sources of 306-743 tokens in T or S = 2048 and 16384), where
     the kernels skip the key tiles the bias masks whole; K4-K7 in f32 at
     the decoder's cross shapes (S = 2048 and 8192, with an empty source)
     and at the fixture's padding (S = 2048 and 16384), beside SDPA in f32
     and both f32 bounds (split TF32, which they run; the CUDA cores);
     The f32 cases of the retriever's path: K1 at its full-KB validation
     (B = N = 1997, D = 768, and D = 769 with the l2 route's augmented
     column), K2 at its train step (B=4) and encode batches (B=64), K3 at
     its train step, and both at the retriever's own padding (four fixture
     queries of 118-124 valid tokens of 512, K3 with the model's dO), K2/K3
     beside SDPA in f32 under the same mask and beside both f32 bounds
     (split TF32 on the tensor cores, which they run; the CUDA cores);
  5a. the cached decoder step's attention kernel (``flash_decode_attention``,
     no TPU kernel: the JAX package's step is XLA einsums) against its plain
     version at the predict cell's shapes: the cross-attention of 256 items
     x 4 beams over strided K/V of 2048 keys (traffic-like source lengths),
     bf16 and f32, and the self-attention over a 257-slot cache at position
     128, beside the plain version, SDPA and the bytes bound;
  5b. kernel K10 (phase 1 of the two-phase MIPS top-k) against its plain
     version at K1's serving shape, bf16 and f32 (beside ``torch.mm`` of
     the scores), its top-k against K1's and its scores at K1's hits
     bit-equal to K1's values;
  6. kernel K8 (the per-query IVF probe top-k) against its plain version on
     the same probe ids, on IVF indexes (C = 1024, SQ8, bf16 and f32) built by
     the port over 1,048,576 rows of the ``bench-index`` Gaussian mixture
     (D = 768), at B = 4 and 16, nprobe = 32, k = 10, and with 16 queries
     that all probe the same 32 clusters; with its read amplification and
     the device time of its passes, the K1 flat scan of the same payload
     beside its bound, the build time and recall@10;
  7. ``predict`` on ``configs/smoke.yaml`` on the card and on the CPU (the
     plain versions), from one seed: equal retrieved and generated ids;
     then ``fit`` on the same config for 3 steps, card against CPU: the
     same losses; then the same fit in each memory mode (``target_only``;
     dual, ``data.dataset_mode: dual``) and under the remat policies
     ``dots_saveable``, ``nothing_saveable`` (the attention kernels'
     forwards recomputed) and ``everything_saveable`` (nothing recomputed);
  8. the same config on an ``IVF16,SQ8`` index (the per-query route):
     ``predict`` and a 3-step ``fit``, card against CPU, then a
     ``build-index`` → ``predict --index`` round trip on the card;
  9. the serving slice: ``cli.run_predict`` of the port on the led_base
     preset (seeded random weights) over the committed 2000-example
     fixture, on the config's ``IVF256,SQ8`` index (nprobe 8), with the
     kernels' launch counts read around that run;
  9c. the serving step exported (``cli.run_export`` of 9's config: the
     encode program and the decode-step program, `torch.export`, weights
     and store as inputs), loaded and served with 9's params, store and
     batch: ids equal 9's; K1, K2 and K8 launched through their custom ops
     by the exported encode as often as by the eager ``rag_encode``, and the
     cached step's attention kernel through ``ramds::flash_decode`` 2 x 6 x
     256 times a serve, exported or eager; the export, load, encode and
     serve wall times beside the eager ones;
  9d. K2's host time per call through its custom op against the direct
     ctypes launch, at the Longformer row's shape;
  9e. the host tail: the native batch loader against the Python gather over
     the fixture's train epoch (B=4), the native CPU MIPS search against f32
     K1 on a 65536-row ``bench-index`` mixture, and ``bench-index`` at its
     defaults;
  9b. the same slice sampled (one beam, temperature 0.8, top-k 50, top-p
     0.95) with ``generation.output_copy_probs``: the copy traces' teacher-
     forced decoder pass on K4, held to the same call on the CPU; one seed
     gives the same ids, top-k 1 the greedy ids;
  7b. kernel K9 (the 8-bit AdamW superleaf update) against its plain
     version at the capacity slice's superleaf (613,192,286 parameters)
     and on a small superleaf with tails, padding, weight decay and a clip;
  8b. ``fit`` on ``configs/smoke.yaml`` with ``train.adam_8bit``, card
     against CPU, and its checkpoint loaded back on the card;
 10. the training slice: ``cli.run_fit`` on
     ``configs/led_base_multi_x_science.yaml`` (its ``IVF256,SQ8`` index,
     no pretrained weights, the hash tokenizer, the same fixture) for 4
     steps with one store refresh, with the launch counts read around it;
 10b. the same slice in f32 (``precision: float32``, the default): f32
     K4/K5 launched by every decoder layer on every step, its losses in
     full;
 10c. the same slice under ``model.memory_forcing: target_in`` with
     ``copy_forcing: 0.5`` (a third memory slot, the gold target, masked
     off on the steps whose seeded flag is off);
 11. the capacity training slice: the same with ``train.adam_8bit`` and
     ``train.remat`` on, its peak memory and step time beside 10's;
 12. the long-source training slice: 10's config with ``data.max_length``
     16384 (the LED's ``max_src_len``), the decoder's cross-attention on
     K6/K7;
 13. the retriever slice: ``pretrain-retriever`` at full width (the
     led_base preset's Longformer-base query and mips encoders, f32, B=4,
     query and positive 512 tokens) on
     ``configs/led_base_multi_x_science.yaml`` as written (its hub weight
     names warn and keep the seeded init), 4 steps with two full-KB
     validations over the fixture's 1997 positive pairs, then ``--mode
     test`` and ``--mode predict`` on the exported ``encoders.npz``, then the
     summarizer's ``predict`` with ``model.encoder_state_path`` set to it;
 14. the baselines, small: ``cli.run_fit_baseline`` of
     ``configs/baseline_bart.yaml`` and of the same with ``baseline: t5``,
     card against CPU (losses, greedy val ids), BART on K4/K5 and T5 on no
     kernel; the BART run again through ``fit --profile``, whose trace
     names the K4/K5 kernels (K4/K5 at the baseline's own shapes: phase 5);
 15. the BART baseline at ``facebook/bart-large``'s width (d 1024, 16 heads,
     12 + 12 layers, 1024-token sources), seeded random weights, over the
     fixture: 4 steps and greedy decoding of one val batch, K4 = 36 x steps
     + 12 x val batches and K5 = 36 x steps; then 2 steps and a shorter
     decoding through ``fit --profile``, whose trace gives the device's
     busy time in a step and in the decoding, by kernel class;
 16. the T5 baseline at ``t5-large``'s width (24 + 24 layers, 512-token
     sources): the same, with no kernel launched;
 17. ``[mesh_eval]``: ``validate`` of 9's config over a (data 2, shard 2)
     mesh with the LED sequence-sharded, 4 ranks sharing the one card over
     gloo, for 2 val batches (each rank's K1 on its shard, K2 on its LED
     block): the retrieved rows of the mesh and of one device over the same
     130-cluster index against the plain search on the CPU and against each
     other (up to near-tie swaps), the LED encoder states against one
     device's (and, in f32 on full-length rows whose real tokens cross the
     block boundary, against the unsharded encoder), the equal generated
     sequences, the walls, peak memories and collectives; then
     ``torchrun --nproc-per-node 4 -m retrieval_augmented_mds_tpu_torch.cli
     validate`` on ``configs/smoke.yaml`` with that mesh, and K2 and K1 at
     the sharded shapes (a rank's extended LED block; each shard's probed
     union and the spill, as the mesh searched them; a flat shard's rows
     with shifted ignore ids) against their plain versions.

 18. ``[mesh_fit]``: the training slice's config over the same (2, 2) mesh,
     the LED sequence-sharded, 4 ranks on the card over gloo, 3 steps with a
     store refresh, in two forms: AdamW with a bf16 mu and 8-bit AdamW with
     remat, each ZeRO-sharded over ``data`` (K9 on each data rank's row
     shard); each against one device's run of the same form: every step's
     loss, every leaf's gradient norm, the parameters after the last step,
     the gathered optimizer state, each rank's state bytes; the launches,
     walls, peaks and collectives by rank; then K3 on a rank's extended LED
     block (dO zero on its dummy rows) and K9 on a data rank's rows against
     their plain versions, ``torchrun ... cli fit`` on
     ``configs/smoke.yaml`` with a checkpoint that one device resumes (its
     losses those of a run never interrupted), and ``torchrun ... dryrun``.

The line before the last is the per-kernel JSON summary (launches summed
over the eight slices, the exported serving step (9c: its export and one
exported serve), the two baselines and the mesh runs' four ranks (17,
18), K10's from its own phase, as no path calls it; ms,
plain_ms and library_ms measured here with CUDA events; bound_ms the least
time for the same work on an H100 SXM from these inputs); the last line is
``{"ok": true, "device": {...}}``.
Without CUDA, or without the port's package beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(
    REPO, "retrieval_augmented_mds_tpu", "data", "fixtures",
    "multi_x_science_2000.json.gz",
)
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # fit logs, saved indexes
WARMUP, REPS = 2, 10
PLAIN_LONG_REPS = 3  # the plain versions at 16384 keys or rows: ~0.1 s a call
# H100 SXM (NVIDIA data sheet, dense): HBM bytes/s; peak operations/s of
# the f32 CUDA cores and the bf16 and TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32, PEAK_BF16, PEAK_TF32 = 67e12, 989e12, 494.7e12


class SmokeFailure(AssertionError):
    pass


def _counters() -> dict:
    """Each kernel's wrapper by name; ``wrapper.launches`` is its count."""
    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        flash_dense_attention,
        flash_dense_backward,
        flash_dense_blocked,
        flash_dense_blocked_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
    )
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import ivf_probe_topk
    from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import (
        adam8bit_superleaf_update,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_decode import flash_decode_attention
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_chunkmax, mips_topk

    return {f.__name__: f for f in (mips_topk, flash_sliding_attention,
                                    flash_sliding_backward, flash_dense_attention,
                                    flash_dense_backward, ivf_probe_topk,
                                    adam8bit_superleaf_update, flash_dense_blocked,
                                    flash_dense_blocked_backward, mips_chunkmax,
                                    flash_decode_attention)}


# kernels that only the long-source slice runs, and K10, which no path runs
LONG_ONLY = ("flash_dense_blocked", "flash_dense_blocked_backward")
NO_PATH = ("mips_chunkmax",)
# the cached decoder step's attention: only decoding launches it, never a fit
# that does not evaluate
DECODE_ONLY = ("flash_decode_attention",)


def run_counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after → (result, {kernel: launches})."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {name: c.launches for name, c in counters.items()}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean device time of fn() in ms over ``reps`` launches (CUDA events).
    The launches queue behind ~10 ms of device sleep, so the host's launch
    overhead shows only where fn() itself waits for the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # clock cycles
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes: float, n_ops: float, f32: bool, split_tf32: bool = False) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of the inputs' type.
    ``split_tf32``: f32 products run as three TF32 tensor-core products
    each (3 x the operations over the dense TF32 peak)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * n_ops / PEAK_TF32 if split_tf32
             else n_ops / (PEAK_F32 if f32 else PEAK_BF16)) * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def _route_bounds(n_bytes: float, flops: float, dtype) -> tuple[dict, str]:
    """A tensor-core kernel's (K1-K7, K10) bound for the dtype's route, and
    for f32 the text of the CUDA-core bound beside it. f32 runs split TF32
    on the tensor cores, so its bound is 3 x the operations over the TF32
    peak, or the bytes."""
    import torch

    if dtype != torch.float32:
        return roofline(n_bytes, flops, False), ""
    cores = roofline(n_bytes, flops, True)
    return roofline(n_bytes, flops, True, split_tf32=True), (
        f" (split TF32: 3 x ops over {PEAK_TF32 / 1e12:.1f} TFLOP/s, or bytes); on the "
        f"f32 CUDA cores {cores['bound_ms']:.3f} ms ({cores['bound_by']})")


def result(err, ms, plain_ms, bound, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_env() -> str:
    import torch

    from retrieval_augmented_mds_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card)
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc[-1] if nvcc else '?'}' "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = cuda_build.build(*cuda_build.KERNELS)
    print(f"[build] {len(paths)} kernel sources, one nvcc each in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in zip(cuda_build.KERNELS, paths):
        cuda_build.load(name)
        with open(f"{path}.log") as f:
            log = f.read()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name}: {len(regs)} kernel instances, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)} per thread, "
              f"spill stores {max(spills, default=0)} bytes at most (ptxas -v)")
    return card


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------

def _k1_case(name, b, n, d, k, dtype, *, bias=False, ignore=False, timed=False,
             rising=False):
    """K1 against `mips_topk_plain`, and a rerun bit-equal to the first run.
    ``rising``: a bias step of 1000 a row over products of at most a few
    hundred, so the scores rise with the row index and every score passes
    the selection's threshold (its worst case; the top-k is the last k
    rows)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
        mips_topk,
        mips_topk_plain,
        quantize_corpus_sq8,
    )

    g = torch.Generator(device="cuda").manual_seed(1000 + n)
    q = torch.randn((b, d), generator=g, device="cuda")
    e = torch.randn((n, d), generator=g, device="cuda")
    scale = None
    if dtype == "int8":
        e, scale = quantize_corpus_sq8(e)
    else:
        e = e.to(dtype)
    rb = torch.randn(n, generator=g, device="cuda") if bias else None
    if rising:
        rb = 1000.0 * torch.arange(n, device="cuda", dtype=torch.float32)
    ign = None
    if ignore:
        _, top = mips_topk_plain(q, e, 1, rb, None, scale)
        ign = torch.randint(-1, n, (b, 8), generator=g, device="cuda",
                            dtype=torch.int32)
        ign[:, 0] = top[:, 0]  # the true best hit must disappear
    vals, ids = mips_topk(q, e, k, rb, ign, scale)
    again_v, again_i = mips_topk(q, e, k, rb, ign, scale)
    ref_v, ref_i = mips_topk_plain(q, e, k, rb, ign, scale)
    torch.cuda.synchronize()
    check(torch.equal(vals, again_v) and torch.equal(ids, again_i),
          f"K1 {name}: a rerun differs")
    if rising:
        last = torch.arange(n - 1, n - 1 - k, -1, device="cuda", dtype=torch.int32)
        check(torch.equal(ids, last.expand(b, k)), f"K1 {name}: not the last {k} rows")
    err = (vals - ref_v).abs().max().item()
    if dtype == torch.float32:
        # f32: values to f32 summation-order noise; the same ids, but where
        # a near-tie swaps two rows (`_near_tie_swaps`)
        check(torch.allclose(vals, ref_v, rtol=1e-5, atol=1e-4),
              f"K1 {name}: values differ (max abs err {err})")
        swapped, gap, exact = _near_tie_swaps(name, q, e, rb, ids, ref_i, ref_v)
        tol = ("ids equal" + (f" but {swapped} ranks of near-tied rows in the other order "
                              f"(largest exact gap {gap:.3e}; in the exact order in "
                              f"{exact} of their queries)" if swapped else "")
               + ", values rtol 1e-5 atol 1e-4")
    else:
        # bf16 / int8 payloads: near-ties may swap at the last ranks
        hits = sum(len(set(a) & set(r)) for a, r in zip(ids.tolist(), ref_i.tolist()))
        overlap = hits / (b * k)
        check(overlap >= 0.999, f"K1 {name}: id overlap {overlap} < 0.999")
        check(torch.allclose(vals, ref_v, rtol=1e-4, atol=1e-3),
              f"K1 {name}: values differ (max abs err {err})")
        tol = f"id overlap {overlap:.4f} >= 0.999, values rtol 1e-4 atol 1e-3"
    if ign is not None:
        check(not bool(((ids[:, :, None] == ign[:, None, :]) & (ign[:, None, :] >= 0)).any()),
              f"K1 {name}: an ignored id was returned")
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: mips_topk(q, e, k, rb, ign, scale))
        plain_ms = cuda_ms(lambda: mips_topk_plain(q, e, k, rb, ign, scale))
    bound, cores = _route_bounds(nbytes(q, e, rb, scale, ign, vals, ids), 2.0 * b * n * d,
                                 dtype)
    print(f"[K1] {name}: B={b} N={n} D={d} k={k} {dtype}: PASS ({tol}; rerun "
          f"bit-equal); max_abs_err {err:.3e}"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}){cores}, "
             f"{bound['bound_ms'] / ms:.1%} of it" if timed else ""))
    return result(err, ms, plain_ms, bound)


def _near_tie_swaps(name, q, e, rb, ids, ref_i, ref_v) -> tuple[int, float, int]:
    """f32 K1's ids against plain's: equal, except at ranks where the two
    lists hold the same rows of a query in another order and the exact (f64)
    scores of the two rows at each such rank differ by less than the values'
    tolerance (rtol 1e-5, atol 1e-4): rows the values' accuracy cannot rank
    (an f32 score's rounding, a few ulps, decides their order in either
    version). A row missing or added, or a swap across a wider gap, fails.
    Returns (ranks swapped, the largest exact gap among them, the queries
    among those whose swapped rows the kernel holds in their exact
    order)."""
    import torch

    differ = ids != ref_i
    if not bool(differ.any()):
        return 0, 0.0, 0
    bias = torch.zeros(e.shape[0], dtype=torch.float64, device=e.device) if rb is None \
        else rb.double()
    exact_order = 0
    for b in differ.any(1).nonzero().flatten().tolist():
        got, want = ids[b][differ[b]], ref_i[b][differ[b]]
        check(torch.equal(torch.sort(got).values, torch.sort(want).values),
              f"K1 {name}: query {b} holds other rows than plain: {got.tolist()} vs "
              f"{want.tolist()}")
        exact = e[got.long()].double() @ q[b].double() + bias[got.long()]
        exact_order += bool((exact[:-1] >= exact[1:]).all())
    bi, ri = differ.nonzero(as_tuple=True)
    exact = lambda i: (q[bi].double() * e[i].double()).sum(-1) + bias[i]  # noqa: E731
    gap = (exact(ids[bi, ri].long()) - exact(ref_i[bi, ri].long())).abs()
    allowed = 1e-5 * ref_v[bi, ri].double().abs() + 1e-4
    check(bool((gap <= allowed).all()),
          f"K1 {name}: ids differ from plain where the exact scores differ by "
          f"{gap.max().item():.3e} (tolerance {allowed.min().item():.3e})")
    return int(differ.sum()), gap.max().item(), exact_order


def phase_k1():
    import torch

    serving = _k1_case("serving", 256, 131072, 768, 10, torch.bfloat16, timed=True)
    _k1_case("f32_bias_ignore", 64, 100003, 768, 10, torch.float32, bias=True,
             ignore=True, timed=True)
    _k1_case("sq8", 64, 65613, 768, 10, "int8", timed=True)
    _k1_case("f32_k128", 16, 20000, 256, 128, torch.float32, bias=True, ignore=True)
    _k1_case("rising_bf16", 64, 131072, 768, 128, torch.bfloat16, rising=True, timed=True)
    _k1_case("rising_sq8", 4, 200003, 768, 10, "int8", rising=True)
    # the retriever's full-KB validation: its 1997 queries over the 1997
    # encoded positives, f32; the l2 route's φ-augmented D = 769
    _k1_case("retriever_val", 1997, 1997, 768, 10, torch.float32, timed=True)
    _k1_case("retriever_val_l2", 1997, 1997, 769, 10, torch.float32, bias=True, timed=True)
    # the serving shape in f32: bound by split TF32's operations
    _k1_case("serving_f32", 256, 131072, 768, 10, torch.float32, timed=True)
    return serving


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def _k2_inputs(b, nh, t, dh, w, n_glob, lengths, n_valid_glob, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, nh, t, dh), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    pos = torch.arange(t, device="cuda")
    padded = pos[None, :] >= torch.tensor(lengths, device="cuda")[:, None]
    g_idx = torch.stack([
        torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                   1 + torch.randperm(lengths[i] - 1, generator=g, device="cuda")
                   [: n_glob - 1]])
        for i in range(b)
    ])
    g_valid = torch.arange(n_glob, device="cuda")[None, :] < torch.tensor(
        n_valid_glob, device="cuda")[:, None]
    is_global = torch.zeros((b, t), dtype=torch.bool, device="cuda")
    is_global.scatter_(1, g_idx, g_valid)
    key_bias = torch.where(padded | is_global, -1e9, 0.0).float()
    g_bias = torch.where(g_valid, 0.0, -1e9).float()
    take = lambda x: torch.gather(  # noqa: E731
        x, 2, g_idx[:, None, :, None].expand(b, nh, n_glob, dh))
    return (q, k, v, key_bias, take(k), take(v), g_bias, w), ~padded, is_global


def _band_global_mask(key_bias, is_global, w, dtype):
    """The additive [B, 1, T, T] mask under which one full softmax over all
    T keys computes K2's local rows: key j is open to row i when it lies in
    the band |i - j| <= w and is neither padding nor global (key_bias 0),
    or when it is a valid global token. Rows with no open key differ:
    K2's are uniform over their 3w + G columns, these over all T."""
    import torch

    t = key_bias.shape[1]
    i = torch.arange(t, device=key_bias.device)
    band = (i[None, :] - i[:, None]).abs() <= w
    open_ = (band[None] & (key_bias == 0)[:, None, :]) | is_global[:, None, :]
    return torch.where(open_, 0.0, -1e9).to(dtype)[:, None]


def _sliding_pairs(key_bias, g_bias, w, nh, rows=None) -> float:
    """Visible (query, key) pairs of the sliding rows: for every row (of
    ``rows`` [B, T] bool, all by default), the unmasked keys within w of it
    plus the valid globals, times the heads."""
    import torch

    b, t = key_bias.shape
    rows = torch.ones((b, t), dtype=torch.bool, device=key_bias.device) if rows is None \
        else rows
    ok = torch.nn.functional.pad((key_bias == 0).long().cumsum(1), (1, 0))
    i = torch.arange(t, device=key_bias.device)
    hi, lo = torch.clamp(i + w + 1, max=t), torch.clamp(i - w, min=0)
    window = ((ok[:, hi] - ok[:, lo]) * rows).sum()
    return float(nh * (window + (rows.sum(1) * (g_bias == 0).sum(1)).sum()))


def _sliding_reads(key_bias, g_bias, w, live) -> tuple[int, int, int]:
    """(query rows, open keys, window keys) per head that the sliding rows
    of ``live`` [B, T] bool must read: the live rows' queries; the keys
    open to a live row (key_bias 0, within w of it); and the other keys in
    the window of a live row with no open column (its own w-block and the
    two beside it), over which such a row is uniform: the forward reads
    their V, the backward their K and V. T is a multiple of w."""
    import torch

    b, t = key_bias.shape
    i = torch.arange(t, device=key_bias.device)
    hi, lo = torch.clamp(i + w + 1, max=t), torch.clamp(i - w, min=0)

    def near(x):  # [B, T]: some x within w of each position
        c = torch.nn.functional.pad(x.long().cumsum(1), (1, 0))
        return (c[:, hi] - c[:, lo]) > 0

    open_ = key_bias == 0
    blind = live & ~(near(open_) | (g_bias == 0).any(1, keepdim=True))
    blocks = blind.view(b, t // w, w).any(2).long()
    blocks = blocks + torch.nn.functional.pad(blocks[:, 1:], (0, 1)) \
        + torch.nn.functional.pad(blocks[:, :-1], (1, 0))
    keys = open_ & near(live)
    window = (blocks > 0).repeat_interleave(w, 1) & ~keys
    return int(live.sum()), int(keys.sum()), int(window.sum())


def _dense_reads(key_bias) -> tuple[int, int]:
    """(open keys, keys of sources with no open key) over the batches: the
    forward reads K of the first and V of both (a row with no open key is
    the mean of V over all S keys); the backward K and V of both."""
    open_ = key_bias == 0
    return int(open_.sum()), int((~open_.any(1)).sum()) * key_bias.shape[1]


def _k2_case(name, shape, dtype, *, timed=True, library=False, plain_b=None):
    """K2 against `local_rows_plain`; with ``plain_b`` the plain version
    runs (and is timed) on the first ``plain_b`` batches only, against the
    kernel's rows of those batches (each batch is independent). out is
    held on every row, in three sets apart (non-padded rows; padded rows of
    a batch with a valid global; the other padded rows), each within tol x
    its own max|ref|; m and l on every row. A second call must give the
    same bits."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        local_rows_plain,
    )

    args, rows_ok, is_global = _k2_inputs(*shape, dtype=dtype, seed=7)
    *tensors, w = args
    flops = 4 * shape[3] * _sliding_pairs(tensors[3], tensors[6], w, shape[1])
    pb = plain_b or shape[0]
    cut = [x[:pb] for x in tensors]
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    ref, ref_m, ref_l = local_rows_plain(*cut, w, return_stats=True)
    again = flash_sliding_attention(*tensors, window=w, return_stats=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip((out, m, l), again)),
          f"K2 {name} {dtype}: a second run gave other bits")
    full_out = out
    out, m, l = out[:pb], m[: pb * shape[1]], l[: pb * shape[1]]
    b, nh, t, dh = out.shape
    m_err = (m - ref_m).abs().max().item()
    l_rel = ((l - ref_l).abs() / ref_l).max().item()
    if dtype == torch.float32:
        tol_out, tol_m, tol_l = 1e-4, 1e-4, 1e-4
    else:
        tol_out, tol_m, tol_l = 2e-2, 1e-3, 1e-3
    # out on each row set apart, within tol x its own max|ref|: the
    # non-padded rows (up to 2w + 1 keys, small outputs), the padded rows
    # of a batch with a valid global (a few globals, large outputs), the
    # other padded rows
    with_global = (tensors[6] == 0).any(1, keepdim=True)
    sets = {"non-padded": rows_ok, "padded, global": ~rows_ok & with_global,
            "padded, no global": ~rows_ok & ~with_global}
    err, said = 0.0, []
    for set_name, rows in sets.items():
        sel = rows[:pb, None, :].expand(b, nh, t)
        if not bool(sel.any()):
            continue
        e = (out.float() - ref.float()).abs()[sel].max().item()
        ref_max = ref.float().abs()[sel].max().item()
        check(e <= tol_out * ref_max, f"K2 {name} {dtype}: out on the {set_name} rows: "
              f"max abs err {e} > {tol_out} x max|ref| {ref_max}")
        err = max(err, e)
        said.append(f"{set_name} {e:.3e} of max|ref| {ref_max:.3e}")
    check(torch.allclose(m, ref_m, rtol=1e-6, atol=tol_m), f"K2 {name}: m err {m_err}")
    check(l_rel <= tol_l, f"K2 {name}: l max rel err {l_rel} > {tol_l}")
    check(bool(torch.isfinite(out).all()), f"K2 {name}: non-finite output")
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_attention(*tensors, window=w))
        reps = PLAIN_LONG_REPS if shape[2] > 4096 else REPS
        plain_ms = cuda_ms(lambda: local_rows_plain(*cut, w), reps, min(reps, WARMUP))
    if library:
        q, k, v = tensors[:3]
        mask = _band_global_mask(tensors[3], is_global, w, dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    # bytes: every query and output row; the keys some row needs
    rows, keys, window = _sliding_reads(tensors[3], tensors[6], w,
                                        torch.ones_like(rows_ok))
    per_row = shape[1] * shape[3] * tensors[0].element_size()
    n_bytes = per_row * (rows + 2 * keys + window) + nbytes(*tensors[3:7], full_out)
    bound, cores = _route_bounds(n_bytes, flops, dtype)
    print(f"[K2] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]} lengths {shape[6]} valid "
          f"globals {shape[7]}: PASS (out within {tol_out} x each row set's own max|ref|: "
          f"{'; '.join(said)}; m atol {tol_m}+rtol 1e-6: {m_err:.3e}; l rtol {tol_l}: "
          f"{l_rel:.3e}; a second run bit-equal)"
          + (f"; plain version on the first {pb} batches only" if pb < shape[0] else "")
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, {flops / 1e9:.2f} GFLOP)"
             + cores if timed else "")
          + (f"; SDPA with the [B, 1, T, T] band + global mask {lib_ms:.3f} ms"
             if library else ""))
    return result(err, ms, plain_ms, bound, lib_ms)


def phase_k2():
    import torch

    # LED-base encoder layer: padded keys, invalid globals, and a batch
    # whose globals are all invalid (its tail rows are fully masked)
    led = (4, 12, 2048, 64, 512, 64, [2048, 1800, 1000, 512], [64, 10, 3, 0])
    # Longformer-base query/memory encoder layer: CLS as the one global
    lf = (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100],
          [1] * 8)
    served = _k2_case("led_base", led, torch.bfloat16, library=True)
    _k2_case("led_base", led, torch.float32)
    _k2_case("longformer_base", lf, torch.bfloat16, library=True)
    _k2_case("longformer_base", lf, torch.float32)
    # the retriever's f32 encoder layers: its train step (B=4) and the
    # validation's encode batches (B=64)
    _k2_case("retriever_train", RET_QUERY, torch.float32, library=True)
    _k2_case("retriever_encode", RET_ENCODE, torch.float32, library=True)
    # the retriever's own padding: a train step's four fixture queries
    _k2_case("retriever_fixture", RET_FIXTURE, torch.float32, library=True)
    # the LED encoder layer of the long-source slice (the plain version on 2
    # of the 4 batches: its [B, nh, T/w, w, 3w] f32 band tensors)
    _k2_case("led_base_16k", LED_16K, torch.bfloat16, plain_b=2, library=True)
    # the fixture's padding and the LED's valid globals, at the standing and
    # the long-source slices' lengths
    _k2_case("led_base_fixture", LED_FIXTURE, torch.bfloat16, library=True)
    _k2_case("led_base_16k_fixture", LED_16K_FIXTURE, torch.bfloat16, plain_b=2,
             library=True)
    return served


# ---------------------------------------------------------------------------
# phases 4 and 5: the backward of K2 (K3); dense attention rows (K4, K5)
# ---------------------------------------------------------------------------

# LED-base encoder layer over the long-source slice's 16384-token sources
LED_16K = (4, 12, 16384, 64, 512, 64, [16384, 12000, 6000, 2048], [64, 10, 3, 0])
# the retriever's Longformer-base layers, CLS the one global: its train
# step's queries (B=4) and the validation's encode batches of 64 rows
# (valid lengths 40-195, mean 116.5; the fixture's queries hold 119.0
# valid tokens on average)
RET_QUERY = (4, 12, 512, 64, 256, 1, [512, 500, 300, 130], [1] * 4)
RET_ENCODE = (64, 12, 512, 64, 256, 1, [40 + (61 * i) % 160 for i in range(64)], [1] * 64)
# the queries of the retriever slice's first train step as its pipeline
# tokenizes them (fixture rows 538, 1020, 1696, 1270 of the 1997 pairs;
# the pairs' queries hold 119.0 valid tokens of 512 on average)
RET_FIXTURE = (4, 12, 512, 64, 256, 1, [119, 124, 118, 123], [1] * 4)
# valid source tokens of four fixture examples (mean 451.7, 306-743 over
# the long-source slice's steps): the padding the slices' kernels see
FIXTURE_LENGTHS = [743, 451, 306, 520]
# the LED's valid globals on such sources: token 0 and each <DOC_SEP>
FIXTURE_GLOBALS = [6, 4, 3, 5]
LED_FIXTURE = (4, 12, 2048, 64, 512, 64, FIXTURE_LENGTHS, FIXTURE_GLOBALS)
LED_16K_FIXTURE = (4, 12, 16384, 64, 512, 64, FIXTURE_LENGTHS, FIXTURE_GLOBALS)


def _grad_tol(dtype) -> float:
    """Relative to the largest magnitude of each reference: f32 summation
    order, or one bf16 rounding of a result both versions take in f32."""
    import torch

    return 1e-4 if dtype == torch.float32 else 2e-2


def _compare(what: str, got, ref, tol: float) -> float:
    """max |got - ref| over the tensors, each within tol x its own max|ref|
    (no floor: gradients of long rows are far below 1)."""
    err = 0.0
    for g, r in zip(got, ref):
        e = (g.float() - r.float()).abs().max().item()
        bound = tol * r.float().abs().max().item()
        check(e <= bound and math.isfinite(e), f"{what}: max abs err {e} > {bound}")
        err = max(err, e)
    return err


def _k3_case(name, shape, dtype, *, timed=True, library=False, plain_b=None,
             model_do=False):
    """K3 against `sliding_backward_plain` from the same m, l, delta; with
    ``plain_b`` as in `_k2_case`. With ``model_do`` the cotangent is zero on
    the padded rows and on the valid global rows, as the encoder hands it
    to the backward (their outputs are zeroed or overwritten); otherwise
    random everywhere. A second call must give the same bits."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        row_delta,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
        sliding_backward_plain,
    )

    args, rows_ok, is_global = _k2_inputs(*shape, dtype=dtype, seed=11)
    *tensors, w = args
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    live = torch.ones_like(rows_ok)
    if model_do:
        live = rows_ok & ~is_global
        do = do.masked_fill(~live[:, None, :, None], 0.0)
    # the work these inputs need: rows with a zero cotangent add nothing
    flops = 10 * shape[3] * _sliding_pairs(tensors[3], tensors[6], w, shape[1], live)
    bwd = (*tensors, do, m, l, row_delta(do, out))
    pb, nh = plain_b or shape[0], shape[1]
    cut = [x[: pb * nh] if x.shape[0] == shape[0] * nh else x[:pb] for x in bwd]
    got = flash_sliding_backward(*bwd, window=w)
    ref = sliding_backward_plain(*cut, w)
    again = flash_sliding_backward(*bwd, window=w)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    err = _compare(f"K3 {name} {dtype}", [x[:pb] for x in got], ref, tol)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K3 {name} {dtype}: a second run gave other bits")
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_backward(*bwd, window=w))
        reps = PLAIN_LONG_REPS if shape[2] > 4096 else REPS
        plain_ms = cuda_ms(lambda: sliding_backward_plain(*cut, w), reps, min(reps, WARMUP))
    if library:
        # the backward of one SDPA call under the equivalent mask
        q2, k2, v2 = (x.detach().requires_grad_() for x in tensors[:3])
        mask = _band_global_mask(tensors[3], is_global, w, dtype)
        lib_out = torch.nn.functional.scaled_dot_product_attention(q2, k2, v2,
                                                                   attn_mask=mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (q2, k2, v2), do,
                                                     retain_graph=True))
    # bytes: dO, the outputs and the small inputs in full; the stats and
    # queries of live rows; the keys these rows need
    rows, keys, window = _sliding_reads(tensors[3], tensors[6], w, live)
    per_row = shape[1] * shape[3] * tensors[0].element_size()
    n_bytes = (per_row * (rows + 2 * (keys + window)) + rows * shape[1] * 3 * m.element_size()
               + nbytes(*tensors[3:7], do, *got))
    bound, cores = _route_bounds(n_bytes, flops, dtype)
    print(f"[K3] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]} lengths {shape[6]} valid "
          f"globals {shape[7]}, dO {'zero on padded and global rows' if model_do else 'random'}"
          f": PASS (dq, dk, dv, dkg, dvg on every row, fully masked ones included, within "
          f"{tol} x max|ref|: max abs err {err:.3e}; a second run bit-equal)"
          + (f"; plain version on the first {pb} batches only" if pb < shape[0] else "")
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, {flops / 1e9:.2f} GFLOP)"
             + cores if timed else "")
          + (f"; SDPA backward with the band + global mask {lib_ms:.3f} ms"
             if library else ""))
    return result(err, ms, plain_ms, bound, lib_ms)


def phase_k3():
    import torch

    # the train step's shapes: LED encoder layer; Longformer query encoder
    # (B=4) and memory re-encode (B*k = 8 rows), CLS the one global
    led = (4, 12, 2048, 64, 512, 64, [2048, 1800, 1000, 512], [64, 10, 3, 0])
    query = (4, 12, 512, 64, 256, 1, [512, 500, 300, 130], [1] * 4)
    memory = (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100], [1] * 8)
    served = _k3_case("led_base", led, torch.bfloat16, library=True)
    _k3_case("led_base", led, torch.float32)
    _k3_case("longformer_query", query, torch.bfloat16, library=True)
    # the retriever's train step: the same shape in f32, and at its own
    # padding with the model's dO
    _k3_case("longformer_query", query, torch.float32, library=True)
    _k3_case("retriever_fixture", RET_FIXTURE, torch.float32, model_do=True, library=True)
    _k3_case("longformer_memory", memory, torch.bfloat16, library=True)
    _k3_case("led_base_16k", LED_16K, torch.bfloat16, plain_b=2, library=True)
    # the fixture's padding, its globals and the model's zero cotangents, at
    # the standing and the long-source slices' lengths
    _k3_case("led_base_fixture", LED_FIXTURE, torch.bfloat16, model_do=True, library=True)
    _k3_case("led_base_16k_fixture", LED_16K_FIXTURE, torch.bfloat16, plain_b=2,
             model_do=True, library=True)
    return served


def _dense_inputs(b, t, s, lengths, dtype, seed, nh=12):
    """(generator, q, k, v, key_bias) of the decoder's attention (nh heads,
    dh = 64); batch i's source is lengths[i] long (0: all padding)."""
    import torch

    dh = 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, nh, t, dh), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    pos = torch.arange(s, device="cuda")
    kb = torch.where(pos[None, :] < torch.tensor(lengths, device="cuda")[:, None],
                     0.0, -1e9).float()
    return g, q, k, v, kb


def _dense_pairs(b, nh, t, s, causal, lengths) -> float:
    """Visible (query, key) pairs: keys inside the source, and not after the
    query when causal; 4 (forward) and 10 (backward) x dh operations each."""
    import torch

    j = torch.arange(s, device="cuda")
    vis = j[None, None, :] < torch.tensor(lengths, device="cuda")[:, None, None]
    if causal:
        vis = vis & (j[None, None, :] <= torch.arange(t, device="cuda")[None, :, None])
    return float(nh * vis.expand(b, t, s).sum())


def _sdpa_ms(q, k, v, kb, do, causal) -> list[float]:
    """The library's yardstick: one scaled_dot_product_attention call with
    the same additive key mask, and its backward (ms)."""
    import torch

    b, _, t, _ = q.shape
    s = k.shape[2]
    mask = kb[:, None, None, :].expand(b, 1, t, s)
    if causal:
        later = (torch.arange(s, device="cuda")[None, :]
                 > torch.arange(t, device="cuda")[:, None])
        mask = mask + torch.where(later, -1e9, 0.0)
    mask = mask.to(q.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q2, k2, v2 = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = sdpa(q2, k2, v2, attn_mask=mask)
    return [cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (q2, k2, v2), do,
                                                retain_graph=True))]


def _dense_case(name, b, t, s, causal, lengths, dtype, nh=12):
    """K4 against `dense_rows_plain` (out, m, l) and K5 against
    `dense_backward_plain` (dq, dk, dv from the same m, l, delta), nh heads
    of 64; a source of length 0 is all padding (its rows are uniform over
    the S keys)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        dense_backward_plain,
        dense_rows_plain,
        flash_dense_attention,
        flash_dense_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import row_delta

    dh = 64
    g, q, k, v, kb = _dense_inputs(b, t, s, lengths, dtype, seed=21, nh=nh)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    ref, ref_m, ref_l = dense_rows_plain(q, k, v, kb, causal, return_stats=True)
    again = flash_dense_attention(q, k, v, kb, causal=causal)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    bwd = (q, k, v, kb, do, m, l, row_delta(do, out))
    got = flash_dense_backward(*bwd, causal=causal)
    ref_g = dense_backward_plain(*bwd, causal)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    what = f"{name} {dtype}"
    err4 = _compare(f"K4 {what}", [out], [ref], tol)
    check(all(torch.equal(a, b_) for a, b_ in zip((out, m, l), again)),
          f"K4 {what}: a second run gave other bits")
    check(torch.allclose(m, ref_m, rtol=1e-6, atol=1e-3), f"K4 {what}: m differs")
    check(bool(((l - ref_l).abs() / ref_l).max() <= 1e-3), f"K4 {what}: l differs")
    err5 = _compare(f"K5 {what}", got, ref_g, tol)
    pairs = _dense_pairs(b, nh, t, s, causal, lengths)
    # bytes: K and V of the keys the rows need (`_dense_reads`), the rest in full
    open_keys, blind_keys = _dense_reads(kb)
    per_key = nh * dh * k.element_size()
    bound4, cores4 = _route_bounds(
        nbytes(q, kb, out, m, l) + per_key * (2 * open_keys + blind_keys), 4 * dh * pairs,
        dtype)
    bound5, cores5 = _route_bounds(
        nbytes(q, *bwd[3:], *got) + per_key * 2 * (open_keys + blind_keys), 10 * dh * pairs,
        dtype)
    times = [cuda_ms(lambda: flash_dense_attention(q, k, v, kb, causal=causal)),
             cuda_ms(lambda: dense_rows_plain(q, k, v, kb, causal)),
             cuda_ms(lambda: flash_dense_backward(*bwd, causal=causal)),
             cuda_ms(lambda: dense_backward_plain(*bwd, causal)),
             *_sdpa_ms(q, k, v, kb, do, causal)]
    shape = f"B={b} nh={nh} T={t} S={s} dh={dh} causal={causal} lengths={lengths}"
    print(f"[K4] {what}: {shape}: PASS (out within {tol} x max|ref|: {err4:.3e}; "
          f"m atol 1e-3, l rtol 1e-3; a second run bit-equal); kernel {times[0]:.3f} ms, "
          f"plain {times[1]:.3f} ms, sdpa {times[4]:.3f} ms, bound {bound4['bound_ms']:.3f} "
          f"ms ({bound4['bound_by']}, {4 * dh * pairs / 1e9:.2f} GFLOP)" + cores4)
    print(f"[K5] {what}: {shape}: PASS (dq, dk, dv within {tol} x max|ref|: {err5:.3e}); "
          f"kernel {times[2]:.3f} ms, plain {times[3]:.3f} ms, sdpa backward {times[5]:.3f} "
          f"ms, bound {bound5['bound_ms']:.3f} ms ({bound5['bound_by']}, "
          f"{10 * dh * pairs / 1e9:.2f} GFLOP)" + cores5)
    return (result(err4, times[0], times[1], bound4, times[4]),
            result(err5, times[2], times[3], bound5, times[5]))


def phase_k45():
    import torch

    # decoder self-attention (causal) and cross-attention over the padded
    # 2048-token source of the train step, B=4 (longer sources: phase_k67)
    _dense_case("decoder_self", 4, 512, 512, True, [512] * 4, torch.bfloat16)
    cross = _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0],
                        torch.bfloat16)
    # the fixture's own padding: sources of its order of length, none empty
    _dense_case("decoder_cross_fixture", 4, 512, 2048, False, FIXTURE_LENGTHS,
                torch.bfloat16)
    # f32 (the decoder of a config that keeps the default precision, as
    # `[train_f32]` runs it), at the same shapes
    _dense_case("decoder_self", 4, 512, 512, True, [512] * 4, torch.float32)
    _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0], torch.float32)
    _dense_case("decoder_cross_fixture", 4, 512, 2048, False, FIXTURE_LENGTHS,
                torch.float32)
    # the BART baseline's three f32 shapes at bart-large's 16 heads (phase
    # `[baseline_bart]`): the encoder's non-causal self-attention over
    # 1024-token sources at the fixture's padding, the decoder's causal
    # self-attention over 512 tokens, its cross-attention over the source
    _dense_case("baseline_encoder_self", 4, 1024, 1024, False, FIXTURE_LENGTHS,
                torch.float32, nh=16)
    _dense_case("baseline_decoder_self", 4, 512, 512, True, [512] * 4, torch.float32, nh=16)
    _dense_case("baseline_cross", 4, 512, 1024, False, FIXTURE_LENGTHS, torch.float32,
                nh=16)
    return cross


def _source_lengths(rng, n: int, width: int = 2048) -> list[int]:
    """Source lengths in tokens as the benchmark's Multi-XScience traffic
    draws them (portbench/traffic.py): an abstract and 1 + Poisson(3.42)
    cited abstracts, each log-normal (mean 143.6 words, sigma 0.45), one
    token a word, a <DOC_SEP> between documents and <s>, </s> around, cut
    to ``width``: about 780 of 2048 on average."""
    sigma = 0.45
    mu = math.log(143.6) - sigma * sigma / 2
    docs = 2 + rng.poisson(3.42, n)
    return [min(width, 1 + int(d) + int(sum(max(1, round(x))
                                            for x in rng.lognormal(mu, sigma, int(d)))))
            for d in docs]


def _decode_case(name, q, k, v, mask, sdpa_args):
    """The cached step's attention kernel against `flash_decode_plain` (tol x
    max|ref|), a rerun bit-equal, and the times of the kernel, the plain
    version and SDPA under the same mask (``sdpa_args``: q, k, v, mask as
    SDPA takes them), beside the bytes bound: the K/V rows of the open keys
    (each row's open keys; a row with none reads all S), q, the output and
    the mask, read or written once."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_plain,
    )

    bq, nh, t, dh = q.shape
    b, s = k.shape[0], k.shape[2]
    out = flash_decode_attention(q, k, v, mask)
    ref = flash_decode_plain(q, k, v, mask)
    again = flash_decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    tol = _grad_tol(q.dtype)
    err = _compare(f"flash_decode {name}", [out], [ref], tol)
    check(torch.equal(out, again), f"flash_decode {name}: a second run gave other bits")
    rows_open = mask.expand(b, s).sum(1)
    open_keys = int(torch.where(rows_open > 0, rows_open, s).sum())
    tiles = (rows_open + 63) // 64 * 64  # the kernel reads 64-key tiles whole
    tile_keys = int(torch.where(rows_open > 0, tiles.clamp(max=s), s).sum())
    per_key = nh * dh * k.element_size()
    n_bytes = 2 * per_key * open_keys + nbytes(q, out, mask)
    rows = bq // b * t  # query rows of an item: its beams' tokens
    bound, cores = _route_bounds(n_bytes, 4 * dh * rows * nh * open_keys, q.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = [cuda_ms(lambda: flash_decode_attention(q, k, v, mask)),
             cuda_ms(lambda: flash_decode_plain(q, k, v, mask)),
             cuda_ms(lambda: sdpa(*sdpa_args[:3], attn_mask=sdpa_args[3]))]
    eff = n_bytes / (times[0] * 1e-3) / 1e12
    print(f"[decode_attn] {name} {q.dtype}: q [{bq}, {nh}, {t}, {dh}] k/v [{b}, {nh}, {s}, "
          f"{dh}] strides {tuple(k.stride())}, open keys {open_keys} of {b * s} "
          f"({tile_keys} in open 64-key tiles): PASS (within {tol} x max|ref|: {err:.3e}; a "
          f"second run bit-equal); kernel {times[0]:.4f} ms ({eff:.2f} TB/s), plain "
          f"{times[1]:.4f} ms, sdpa {times[2]:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}, {n_bytes / 1e9:.3f} GB; the open tiles' K/V "
          f"{2 * per_key * tile_keys / 1e9:.3f} GB); kernel / bound "
          f"{times[0] / bound['bound_ms']:.2f}" + cores)
    return result(err, times[0], times[1], bound, times[2])


def phase_decode_attn() -> dict:
    """The cached decoder step's attention kernel (`flash_decode_attention`)
    alone at the rag_predict cell's shapes (bf16, 12 heads of 64): the
    cross-attention of B = 256 items x 4 beams over un-expanded, strided
    encoder K/V of S = 2048 with source lengths drawn like the traffic's;
    the self-attention of B' = 1024 beam rows over a 257-slot cache at
    position 128 (keys 0-128 open). Each against its plain version, timed
    (10 launches after 2 warm-ups) beside the plain version, SDPA under the
    same mask (the folded beams as SDPA's query rows), and the bytes bound;
    the cross case also in f32 (the BART baseline's cached decode)."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch.models.core import causal_mask

    nh, dh = 12, 64
    lengths = _source_lengths(np.random.default_rng(23), 256)
    print(f"[decode_attn] source lengths (traffic-like): mean {np.mean(lengths):.1f}, min "
          f"{min(lengths)}, max {max(lengths)} of 2048")
    g = torch.Generator(device="cuda").manual_seed(23)

    def heads(rows, t, dtype):  # split from a [rows, t, nh dh] projection: strided
        x = torch.randn((rows, t, nh * dh), generator=g, device="cuda").to(dtype)
        return x.reshape(rows, t, nh, dh).permute(0, 2, 1, 3)

    mask = (torch.arange(2048, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])
    cross = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = heads(1024, 1, dtype), heads(256, 2048, dtype), heads(256, 2048, dtype)
        qf = q.reshape(256, 4, nh, dh).permute(0, 2, 1, 3)  # the beams as query rows
        cross[dtype] = _decode_case("cross B=256 g=4 S=2048", q, k, v, mask,
                                    (qf, k, v, mask[:, None, None, :]))
        del k, v
    q = heads(1024, 1, torch.bfloat16)
    kc, vc = (torch.randn((1024, nh, 257, dh), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    smask = causal_mask(1, 257, torch.tensor(128, device="cuda"), "cuda")
    _decode_case("self B'=1024 Tmax=257 pos=128", q, kc, vc, smask.reshape(1, 257),
                 (q, kc, vc, smask))
    return cross[torch.bfloat16]


def _blocked_case(name, b, t, s, causal, lengths, dtype, *, timed=True):
    """K6 against `dense_rows_blocked_plain` (out, lse) and K7 against
    `dense_blocked_backward_plain` (dq, dk, dv from the same out, lse, g).
    A source of length 0 is all padding: its LSE rounds to -1e9, and K7
    must give its rows the uniform p = 1/S of the composite (dv of every
    key = the rows' mean of g), not the p = 1 of exp(s - lse)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        LSE_DEGENERATE,
        dense_blocked_backward_plain,
        dense_rows_blocked_plain,
        flash_dense_blocked,
        flash_dense_blocked_backward,
    )

    nh, dh = 12, 64
    gen, q, k, v, kb = _dense_inputs(b, t, s, lengths, dtype, seed=23)
    out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
    ref, ref_lse = dense_rows_blocked_plain(q, k, v, kb, causal)
    again = flash_dense_blocked(q, k, v, kb, causal=causal)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"K6 {name} {dtype}: a second run gave other bits")
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = flash_dense_blocked_backward(q, k, v, kb, out, lse, do, causal=causal)
    ref_g = dense_blocked_backward_plain(q, k, v, kb, out, lse, do, causal)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    what = f"{name} {dtype}"
    err6 = _compare(f"K6 {what}", [out], [ref], tol)
    check(torch.allclose(lse, ref_lse, rtol=1e-6, atol=1e-3), f"K6 {what}: lse differs")
    err7 = _compare(f"K7 {what}", got, ref_g, tol)
    empty = [i for i, n in enumerate(lengths) if n == 0]
    pad = ""
    for i in empty:
        check(bool((lse[i * nh:(i + 1) * nh] <= LSE_DEGENERATE).all()),
              f"K6 {what}: batch {i} (all padding) has an LSE above -1e8")
        uniform = do[i].float().sum(1, keepdim=True).expand(-1, s, -1) / s
        pad_err = _compare(f"K7 {what}: dv of the all-padding batch {i}", [got[2][i]],
                           [uniform], tol)
        pad = (f"; the all-padding batch's dv uniform over the S keys within {tol} x "
               f"its max {uniform.abs().max().item():.3e}: {pad_err:.3e}")
    pairs = _dense_pairs(b, nh, t, s, causal, lengths)
    # bytes: K and V of the keys the rows need (`_dense_reads`), the rest in full
    open_keys, blind_keys = _dense_reads(kb)
    per_key = nh * dh * k.element_size()
    bound6, cores6 = _route_bounds(
        nbytes(q, kb, out, lse) + per_key * (2 * open_keys + blind_keys), 4 * dh * pairs,
        dtype)
    bound7, cores7 = _route_bounds(
        nbytes(q, kb, out, lse, do, *got) + per_key * 2 * (open_keys + blind_keys),
        10 * dh * pairs, dtype)
    times = [None] * 6
    if timed:
        times = [cuda_ms(lambda: flash_dense_blocked(q, k, v, kb, causal=causal)),
                 cuda_ms(lambda: dense_rows_blocked_plain(q, k, v, kb, causal),
                         PLAIN_LONG_REPS, 1),
                 cuda_ms(lambda: flash_dense_blocked_backward(q, k, v, kb, out, lse, do,
                                                              causal=causal)),
                 cuda_ms(lambda: dense_blocked_backward_plain(q, k, v, kb, out, lse, do,
                                                              causal),
                         PLAIN_LONG_REPS, 1),
                 *_sdpa_ms(q, k, v, kb, do, causal)]
    shape = f"B={b} nh={nh} T={t} S={s} dh={dh} causal={causal} lengths={lengths}"
    print(f"[K6] {what}: {shape}: PASS (out within {tol} x max|ref|: {err6:.3e}; lse atol "
          f"1e-3" + (", the all-padding batch's lse <= -1e8" if empty else "")
          + "; a second run bit-equal)"
          + (f"; kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms, sdpa {times[4]:.3f} ms, "
             f"bound {bound6['bound_ms']:.3f} ms ({bound6['bound_by']}, "
             f"{4 * dh * pairs / 1e9:.2f} GFLOP)" + cores6 if timed else ""))
    print(f"[K7] {what}: {shape}: PASS (dq, dk, dv each within {tol} x its max|ref|: "
          f"{err7:.3e}{pad})"
          + (f"; kernel {times[2]:.3f} ms, plain {times[3]:.3f} ms, sdpa backward "
             f"{times[5]:.3f} ms, bound {bound7['bound_ms']:.3f} ms ({bound7['bound_by']}, "
             f"{10 * dh * pairs / 1e9:.2f} GFLOP)" + cores7 if timed else ""))
    return (result(err6, times[0], times[1], bound6, times[4]),
            result(err7, times[2], times[3], bound7, times[5]))


def phase_k67():
    import torch

    # the decoder's cross-attention of the long-source slice: B=4 sources
    # padded to 16384 tokens, one of them empty; then f32 at S = 8192; the
    # fixture's padding in both dtypes
    cross = _blocked_case("decoder_cross_16k", 4, 512, 16384, False,
                          [16384, 11000, 3000, 0], torch.bfloat16)
    _blocked_case("decoder_cross_8k", 2, 256, 8192, False, [8192, 0], torch.float32)
    _blocked_case("causal_ragged", 2, 4500, 4500, True, [4500, 4500], torch.bfloat16,
                  timed=False)
    _blocked_case("decoder_cross_16k_fixture", 4, 512, 16384, False, FIXTURE_LENGTHS,
                  torch.bfloat16)
    _blocked_case("decoder_cross_16k_fixture", 4, 512, 16384, False, FIXTURE_LENGTHS,
                  torch.float32)
    return cross


# ---------------------------------------------------------------------------
# phase 5b: K10, phase 1 of the two-phase MIPS top-k
# ---------------------------------------------------------------------------

def _k10_case(name, b, n, d, k, dtype, *, timed=False):
    """K10 against `mips_chunkmax_plain`: the same masked cells (-3e38),
    scores and chunk maxima within 1e-4 x max|score| (f32 sums of the same
    products in another order); the two-phase top-k against K1's (random
    data: no equal scores, so K1's distinct-value rule and the all-hits
    rule agree): equal ids, values within rtol 1e-5 + atol 1e-4; K10's
    scores at K1's hits bit-equal to K1's values (one tile, one walk, in
    both types); a rerun bit-equal. Returns (result, launches of the top-k
    call)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
        mips_chunkmax,
        mips_chunkmax_plain,
        mips_topk,
        mips_topk_blocked,
    )

    g = torch.Generator(device="cuda").manual_seed(2000 + n)
    q = torch.randn((b, d), generator=g, device="cuda")
    e = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    rb = torch.randn(n, generator=g, device="cuda")
    ign = torch.randint(-1, n, (b, 8), generator=g, device="cuda", dtype=torch.int32)
    scores, cmax = mips_chunkmax(q, e, rb, ign)
    ref, ref_cmax = mips_chunkmax_plain(q, e, rb, ign)
    (vals, ids), launches = run_counted(lambda: mips_topk_blocked(q, e, k, rb, ign))
    k1_vals, k1_ids = mips_topk(q, e, k, rb, ign)
    torch.cuda.synchronize()
    masked = ref < -1e38
    check(torch.equal(scores < -1e38, masked) and bool((scores[masked] == -3e38).all()),
          f"K10 {name}: masked cells differ")
    tol = 1e-4 * ref[~masked].abs().max().item()
    err = max((scores[~masked] - ref[~masked]).abs().max().item(),
              (cmax - ref_cmax).abs().max().item())
    check(err <= tol, f"K10 {name}: max abs err {err} > {tol}")
    check(torch.equal(ids, k1_ids), f"K10 {name}: top-{k} ids differ from K1's")
    check(torch.allclose(vals, k1_vals, rtol=1e-5, atol=1e-4), f"K10 {name}: values")
    # one tensor-core tile, one walk: K1's values bit for bit
    check(torch.equal(torch.gather(scores, 1, k1_ids.long()), k1_vals),
          f"K10 {name}: scores at K1's hits differ from K1's values")
    again = mips_chunkmax(q, e, rb, ign)
    check(torch.equal(again[0], scores) and torch.equal(again[1], cmax),
          f"K10 {name}: a rerun differs")
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: mips_chunkmax(q, e, rb, ign))
        plain_ms = cuda_ms(lambda: mips_chunkmax_plain(q, e, rb, ign))
        # the yardstick: the same f32 scores from one GEMM, bf16 in and f32
        # out, or f32 with TF32 off (no single PyTorch call also gives the
        # chunk maxima or the masks)
        qd = q.to(dtype)
        lib_ms = cuda_ms(lambda: torch.mm(qd, e.T) if dtype == torch.float32
                         else torch.mm(qd, e.T, out_dtype=torch.float32))
    bound, cores = _route_bounds(nbytes(q.to(dtype), e, rb, ign, scores, cmax),
                                 2.0 * b * n * d, dtype)
    print(f"[K10] {name}: B={b} N={n} D={d} k={k} {dtype}, bias, 8 ignored ids: PASS "
          f"(scores and chunk maxima within {tol:.3e}: max abs err {err:.3e}; masked "
          f"cells equal; top-{k} ids equal to K1's, its scores there bit-equal to K1's "
          f"values; rerun bit-equal)"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.mm of the scores "
             f"{lib_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']})"
             f"{cores}, {bound['bound_ms'] / ms:.1%} of it" if timed else ""))
    return result(err, ms, plain_ms, bound, lib_ms), launches["mips_chunkmax"]


def phase_k10():
    import torch

    measured, launches = _k10_case("serving", 256, 131072, 768, 10, torch.bfloat16,
                                   timed=True)
    _k10_case("serving_f32", 256, 131072, 768, 10, torch.float32, timed=True)
    _k10_case("ragged_f32", 37, 777, 50, 7, torch.float32)
    return measured, launches


# ---------------------------------------------------------------------------
# phase 6: K8 on IVF indexes of 1M rows
# ---------------------------------------------------------------------------

K8_N, K8_D, K8_C, K8_NPROBE, K8_K = 1 << 20, 768, 1024, 32, 10


def _k8_check(what, args, k):
    """K8 against `ivf_probe_topk_plain` on the same probe ids: equal
    positions, except where the plain scores of the two candidates differ
    by less than the tolerance; values within 1e-4 x max|score| (the f32
    sums run in another order) → (max abs err, tolerance)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_scores_plain,
        ivf_probe_topk,
        ivf_probe_topk_plain,
    )

    vals, pos = ivf_probe_topk(*args, k)
    ref_v, ref_p = ivf_probe_topk_plain(*args, k)
    scores = ivf_probe_scores_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * scores[scores > -1e38].abs().max().item()
    err = (vals - ref_v).abs().max().item()
    check(err <= tol, f"K8 {what}: values differ by {err} > {tol}")
    differ = pos != ref_p
    if bool(differ.any()):
        at = lambda p: scores.gather(1, p.long().clamp(max=scores.shape[1] - 1))  # noqa: E731
        gap = (at(pos) - at(ref_p)).abs()[differ].max().item()
        check(gap <= tol, f"K8 {what}: positions differ where scores differ by {gap}")
    return err, tol, int(differ.sum())


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """Device ms per call of each CUDA kernel fn() launches, by kernel name
    (torch.profiler's key averages over ``reps`` calls after one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / 1e3 / reps for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0}


def _k8_case(what, args):
    """K8 on one set of probes: held against plain (`_k8_check`), timed
    beside its plain version and its bound (each distinct probed cluster
    read once), with the read amplification (probes per distinct cluster)
    and the device time of its passes → (err, ms, plain_ms, bound)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_topk,
        ivf_probe_topk_plain,
    )

    q, clustered, bias, scale, probes = args
    b, L, d = probes.shape[0], clustered.shape[1], clustered.shape[2]
    err, tol, n_swapped = _k8_check(what, args, K8_K)
    ms = cuda_ms(lambda: ivf_probe_topk(*args, K8_K))
    plain_ms = cuda_ms(lambda: ivf_probe_topk_plain(*args, K8_K))
    n_probed = int(torch.unique(probes).numel())
    row_bytes = d * clustered.element_size() + 4 * (1 if scale is None else 2)
    # f32 payloads run CUDA-core products; bf16 and int8 the bf16 tensor cores
    f32 = clustered.dtype == torch.float32
    ops = 2.0 * b * K8_NPROBE * L * d
    bound = roofline(n_probed * L * row_bytes + nbytes(q, probes) + b * K8_K * 8, ops, f32)
    # f32: the operations alone, on the CUDA cores and as split TF32
    ops_ms = (f"; operations alone {roofline(0, ops, True)['bound_ms']:.4f} ms on the f32 "
              f"CUDA cores, {roofline(0, ops, True, split_tf32=True)['bound_ms']:.4f} ms as "
              f"split TF32" if f32 else "")
    split = device_ms_by_kernel(lambda: ivf_probe_topk(*args, K8_K))
    pass1 = sum(v for n, v in split.items() if "ivf_partial_kernel" in n)
    merge = sum(v for n, v in split.items() if "ivf_merge" in n)
    rest = sum(split.values()) - pass1 - merge
    print(f"[K8] {what} nprobe={K8_NPROBE} k={K8_K}: PASS (positions equal but "
          f"{n_swapped} swapped near-ties within tol {tol:.3e}; values max abs err "
          f"{err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {n_probed} distinct clusters "
          f"of {b * K8_NPROBE} probes, read amplification {b * K8_NPROBE / n_probed:.2f}"
          f"{ops_ms}), {bound['bound_ms'] / ms:.1%} of it; device time per call (profiler): pass 1 "
          f"{pass1:.4f} ms, merge {merge:.4f} ms, grouping and query copy {rest:.4f} ms")
    return err, ms, plain_ms, bound


def phase_k8() -> dict:
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch.cli import gaussian_mixture, recall
    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        build_ivf_index,
        prepare_queries,
        probe_clusters,
    )
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import ivf_search_serving
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
        mips_topk,
        mips_topk_plain,
        quantize_corpus_sq8,
    )

    t0 = time.perf_counter()
    x_np, q_np = gaussian_mixture(K8_N, K8_D, 16, seed=0)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    queries = torch.from_numpy(np.ascontiguousarray(q_np)).cuda()
    print(f"[K8] corpus: {K8_N} rows x {K8_D} of the bench-index Gaussian mixture "
          f"(numpy, seed 0), made in {time.perf_counter() - t0:.1f} s")
    _, exact = mips_topk_plain(queries, x, K8_K)  # exact top-10 over the f32 rows
    measured = None
    for payload in ("int8", "bfloat16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = build_ivf_index(x, K8_C, dtype=payload, alpha=1.5, train_size=65536, seed=0,
                              keep_flat=False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        c, L, d = idx.clustered.shape
        check((c, L, d) == (K8_C, 1536, K8_D), f"K8: clustered shape {(c, L, d)}")
        if payload == "int8":  # the same rows as one flat payload, for K1
            flat, flat_scale = quantize_corpus_sq8(x)
        else:
            flat, flat_scale = x.to(getattr(torch, payload)), None
        print(f"[K8] IVF{K8_C},{'SQ8' if payload == 'int8' else 'Flat'} ({payload}) built in "
              f"{build_s:.3f} s (k-means on 65536 rows, 15 iterations; every row "
              f"assigned): L = {L}, spill rows {idx.n_spill}")
        for b in (4, 16):
            q = prepare_queries(idx, queries[:b])
            probes = probe_clusters(idx, q, K8_NPROBE).to(torch.int32).contiguous()
            args = (q, idx.clustered, idx.clustered_bias, idx.clustered_scale, probes)
            err, ms, plain_ms, bound = _k8_case(f"{payload} B={b}", args)
            flat_ms = cuda_ms(lambda: mips_topk(q, flat, K8_K, None, None, flat_scale))
            # K1's flat scan: the payload and its scales read once
            flat_bound = _route_bounds(nbytes(q, flat, flat_scale) + b * K8_K * 8,
                                       2.0 * b * K8_N * d, flat.dtype)[0]["bound_ms"]
            # the whole per-query route: probes, K8, ids, the spill by K1, merge
            route_ms = cuda_ms(lambda: ivf_search_serving(idx, queries[:b], k=K8_K,
                                                          nprobe=K8_NPROBE))
            _, ids = ivf_search_serving(idx, queries[:b], k=K8_K, nprobe=K8_NPROBE)
            rec = recall(ids, exact[:b])
            _, flat_ids = mips_topk(queries[:b], flat, K8_K, None, None, flat_scale)
            print(f"[K8] {payload} B={b}: K1 flat scan of the same {K8_N}-row payload "
                  f"{flat_ms:.3f} ms (bound {flat_bound:.3f} ms, bytes: "
                  f"{flat_bound / flat_ms:.1%} of it); the whole per-query route "
                  f"{route_ms:.3f} ms; recall@10 vs exact f32: IVF per-query {rec:.4f}, "
                  f"flat {recall(flat_ids, exact[:b]):.4f}")
            if measured is None:  # the reported case: SQ8, B = 4
                measured = result(err, ms, plain_ms, bound)
        # maximal sharing: 16 queries probe query 0's 32 clusters, each at
        # its own ranks
        b = 16
        q = prepare_queries(idx, queries[:b])
        probes = probe_clusters(idx, q, K8_NPROBE).to(torch.int32)
        g = torch.Generator(device="cuda").manual_seed(8)
        probes = torch.stack([probes[0][torch.randperm(K8_NPROBE, generator=g, device="cuda")]
                              for _ in range(b)]).contiguous()
        _k8_case(f"{payload} B={b} sharing", (q, idx.clustered, idx.clustered_bias,
                                              idx.clustered_scale, probes))
        del idx, flat, flat_scale
    del x
    torch.cuda.empty_cache()
    return measured


# ---------------------------------------------------------------------------
# phase 7b: K9, the 8-bit AdamW superleaf update
# ---------------------------------------------------------------------------

# f32 operations per element of the update (dequantise, EMA, step, the two
# requantisations); two more with weight decay
K9_OPS = 35


def capacity_superleaf() -> list[int]:
    """The sizes of the capacity slice's trainable leaves in superleaf
    order (the led_base RAG model of `train_slice_config`, on the meta
    device: shapes only)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import RAG
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import jax_leaf_order

    cfg = train_slice_config()
    with torch.device("meta"):
        params = dict(RAG(cfg.model).named_parameters())
    frozen = set(cfg.train.frozen_groups) | set(cfg.model.frozen_groups())
    return [params[n].numel() for n in jax_leaf_order(params)
            if n.split(".", 1)[0] not in frozen]


def _k9_case(name, sizes, wd, clip, *, timed, shard=None):
    """K9 against its plain version from a warm state (one plain update from
    zero moments): update within rtol 1e-6 + atol 1e-9, codes within 1, mu
    scales rtol 1e-6, the nu range rtol = atol = 1e-5 (the JAX package's
    kernel test). ``shard`` (d, D): the superleaf padded to a multiple of D
    rows and K9 run on data rank d's rows only, as the ZeRO-sharded 8-bit
    AdamW runs it; those rows must also equal, bit for bit, the same rows
    of K9 over the whole superleaf on the same inputs."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import (
        adam8bit_superleaf_update,
        adam8bit_superleaf_update_plain,
    )
    from retrieval_augmented_mds_tpu_torch.train import adam8bit as t8

    gen = torch.Generator(device="cuda").manual_seed(31)
    d, n_shards = shard or (0, 1)
    sizes, nbs, _, nb = t8._layout(sizes, n_shards)
    state = t8.init_state(sizes, "cuda", n_shards)
    mask = torch.arange(t8.BLOCK, device="cuda")[None, :] < state.nvalid

    def rand(scale):
        x = torch.randn((nb, t8.BLOCK), generator=gen, device="cuda")
        return x.mul_(scale).mul_(mask)

    adam = dict(b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    p2 = rand(0.02) if wd else None
    scal0 = torch.tensor([[0.1, 0.001, 0.0, 1.0]], device="cuda")
    _, mq, ms, nq, nlo, nhi = adam8bit_superleaf_update_plain(
        rand(1e-3), state.mu_q, state.mu_scale, state.nu_q, state.nu_lo, state.nu_hi,
        state.nvalid, p2, scal0, **adam)
    scal = torch.tensor([[1 - 0.9 ** 2, 1 - 0.999 ** 2, 3e-5, clip]], device="cuda")
    args = (rand(1e-3), mq, ms, nq, nlo, nhi, state.nvalid, p2, scal)
    whole = None
    if shard:
        whole = adam8bit_superleaf_update(*args, **adam)
        rows = slice(d * nb // n_shards, (d + 1) * nb // n_shards)
        args = tuple(None if a is None else a[rows].contiguous() if a.shape[0] == nb else a
                     for a in args)
        nb = rows.stop - rows.start
    got = adam8bit_superleaf_update(*args, **adam)
    ref = adam8bit_superleaf_update_plain(*args, **adam)
    torch.cuda.synchronize()
    if shard:
        check(all(torch.equal(a, b[rows]) for a, b in zip(got, whole)),
              f"K9 {name}: data rank {d}'s rows differ from the whole superleaf's")
        del whole
    err = (got[0] - ref[0]).abs().max().item()
    check(torch.allclose(got[0], ref[0], rtol=1e-6, atol=1e-9),
          f"K9 {name}: update differs (max abs err {err})")
    flips = []
    for k, what in ((1, "mu_q"), (3, "nu_q")):
        apart = (got[k].int() - ref[k].int()).abs()
        check(got[k].dtype == ref[k].dtype and apart.max().item() <= 1,
              f"K9 {name}: {what} differs by more than 1")
        flips.append(int((apart > 0).sum()))
    check(torch.allclose(got[2], ref[2], rtol=1e-6, atol=0), f"K9 {name}: mu_scale differs")
    for k in (4, 5):
        check(torch.allclose(got[k], ref[k], rtol=1e-5, atol=1e-5), f"K9 {name}: nu range")
    ms_k = plain_ms = None
    if timed:
        ms_k = cuda_ms(lambda: adam8bit_superleaf_update(*args, **adam))
        plain_ms = cuda_ms(lambda: adam8bit_superleaf_update_plain(*args, **adam))
    n = nb * t8.BLOCK
    bound = roofline(nbytes(*[a for a in args if a is not None], *got),
                     (K9_OPS + (2 if wd else 0)) * n, True)
    zeros = int((args[6] == 0).sum())
    print(f"[K9] {name}: {len(sizes)} leaves, {sum(sizes)} parameters, NB={nb}"
          + (f" (data rank {d}'s rows of {n_shards}, {zeros} of no valid element; bit-equal "
             f"to those rows of K9 over the whole superleaf)" if shard else "")
          + f", wd={wd}, "
          f"clip scale {clip}: PASS (update rtol 1e-6 atol 1e-9: max abs err {err:.3e}; "
          f"codes within 1: {flips[0]} mu and {flips[1]} nu codes differ by 1; scales)"
          + (f"; kernel {ms_k:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}: "
             f"{bound['bound_ms'] / ms_k:.1%} of it); library: none (no PyTorch call "
             f"computes blockwise 8-bit AdamW)" if timed else ""))
    return result(err, ms_k, plain_ms, bound)


def phase_k9() -> dict:
    import torch

    # the capacity slice's superleaf (wd 0 and clip as the config's run);
    # then tails, padding rows, weight decay and a clip below 1
    measured = _k9_case("led_base", capacity_superleaf(), 0.0, 0.25, timed=True)
    torch.cuda.empty_cache()
    _k9_case("tails", [16384 + 70, 300, 5, 1000, 129], 0.02, 0.5, timed=False)
    return measured


# ---------------------------------------------------------------------------
# phases 7 to 9: the small configs on the card and the CPU; the serving slice
# ---------------------------------------------------------------------------

SLICE_CONFIG = {
    "model": {"preset": "led_base", "mips_topk": 2, "memory_len": 512},
    "data": {
        "source": FIXTURE, "tokenizer": None, "max_length": 2048,
        "query_max_length": 512, "decoder_max_length": 256,
        "memory_len": 512, "batch_size": 4,
    },
    # configs/led_base_multi_x_science.yaml's index (sotasum/config.yaml:94)
    "index": {"factory": "IVF256,SQ8", "nprobe": 8, "dtype": "bfloat16"},
    "precision": "bfloat16",
    # configs/led_base_multi_x_science.yaml generation settings
    "generation": {
        "max_new_tokens": 256, "min_length": 16, "num_beams": 4,
        "no_repeat_ngram_size": 3, "early_stopping": False,
        "repetition_penalty": 1.0, "length_penalty": 1.0,
    },
    "seed": 0,
}


def phase_small_reference() -> None:
    """``predict`` on ``configs/smoke.yaml`` (tiny preset, f32) on the card,
    through the kernels, and on the CPU, through the plain versions, from
    the same seed: the retrieved ids and the generated ids are equal, the
    encoder states agree to atol=rtol=1e-4 (f32 summation order)."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    gpu, cpu = {}, {}
    out_gpu = cli.run_predict(cfg, device="cuda", report=gpu)
    out_cpu = cli.run_predict(cfg, device="cpu", report=cpu)
    idx_g, idx_c = gpu["enc"].retrieved_idx.cpu(), cpu["enc"].retrieved_idx
    check(torch.equal(idx_g, idx_c), f"small: retrieved ids {idx_g} != CPU {idx_c}")
    err = 0.0
    for name in ("enc_hidden", "memory", "mips_scores"):
        g, c = getattr(gpu["enc"], name).cpu(), getattr(cpu["enc"], name)
        err = max(err, (g - c).abs().max().item())
        check(torch.allclose(g, c, rtol=1e-4, atol=1e-4),
              f"small: {name} differs from the CPU run (max abs err {err})")
    check(torch.equal(gpu["ids"].cpu(), cpu["ids"]), "small: generated ids differ")
    check(out_gpu == out_cpu, "small: predictions differ")
    print(f"[small] configs/smoke.yaml predict, card vs CPU: retrieved ids and "
          f"generated ids equal; encoder states max abs err {err:.3e} "
          f"(atol=rtol=1e-4): PASS")


def _small_fit(tag: str, cfg, off_path: tuple[str, ...] = ()) -> dict:
    """``cli.run_fit`` of a small config on the card, through the kernels,
    and on the CPU, through the plain versions, from one seed: every kernel
    of the path launched (all but K8, K9, the long-source pair, K10 and
    ``off_path``), finite losses that agree to rtol 1e-3 (f32 summation
    order on two devices, passed through an Adam update, which divides each
    small gradient by its own size). Prints them → the card's launches."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli

    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(cfg, device="cuda", report=gpu))
    cli.run_fit(cfg, device="cpu", report=cpu)
    off = ("ivf_probe_topk", "adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH, *DECODE_ONLY,
           *off_path)
    check(all(n > 0 for name, n in launches.items() if name not in off),
          f"{tag}: a kernel not launched {launches}")
    check(len(gpu["refresh_s"]) == 1, f"{tag}: no store refresh")
    lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
    check(len(lg) == cfg.max_steps and bool(torch.isfinite(lg).all()), f"{tag} losses {lg}")
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    check(rel <= 1e-3, f"{tag}: card losses {lg.tolist()} vs CPU {lc.tolist()}")
    print(f"[{tag}] {cfg.max_steps} steps + 1 refresh, card vs CPU: losses "
          f"{[f'{x:.6f}' for x in lg.tolist()]} vs {[f'{x:.6f}' for x in lc.tolist()]}, "
          f"max rel err {rel:.3e} (rtol 1e-3): PASS; card launches {launches}")
    return launches


def small_fit_config(log_name: str, **over):
    """``configs/smoke.yaml`` (tiny preset, f32) for 3 steps with a store
    refresh before the third; ``over`` maps a section (model, data, train)
    to the fields it replaces."""
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), **v)
                                      for k, v in over.items()})
    return dataclasses.replace(
        cfg, max_steps=3, eval_every=0, ckpt_dir=None,
        index=dataclasses.replace(cfg.index, rebuild_every=2),
        logging=dataclasses.replace(cfg.logging, log_dir=os.path.join(OUT_DIR, log_name)))


def phase_small_fit() -> dict:
    """``fit`` on ``configs/smoke.yaml`` for 3 steps, card (decoder T=32,
    cross S=128) against CPU (`_small_fit`) → the card's launches."""
    return _small_fit("small", small_fit_config("small_fit"))


# the small modes' configs: a memory mode, or a remat policy
SMALL_MODES = {
    "target_only": {"model": {"memory_forcing": "target_only"}},
    "dual": {"data": {"dataset_mode": "dual"}},
    "dots_saveable": {"train": {"remat": "dots_saveable"}},
    "nothing_saveable": {"train": {"remat": "nothing_saveable"}},
    "everything_saveable": {"train": {"remat": "everything_saveable"}},
}


def phase_small_modes(standing: dict) -> None:
    """`_small_fit` of ``configs/smoke.yaml`` in each of `SMALL_MODES`: the
    memory modes ``target_only`` (one target slot, no search: K1 off its
    path) and dual (``data.dataset_mode: dual``: the first input documents
    in the memory), and the remat policies ``dots_saveable`` and
    ``nothing_saveable`` (the attention kernels' forwards recomputed in the
    backward: more K2 and K4 launches than the standing small fit's) and
    ``everything_saveable`` (nothing recomputed: the standing launches)."""
    for tag, over in SMALL_MODES.items():
        launches = _small_fit(f"small-{tag}", small_fit_config(f"small_{tag}", **over),
                              off_path=("mips_topk",) if tag == "target_only" else ())
        if tag == "target_only":
            check(launches["mips_topk"] == 0, f"small-{tag}: K1 launched {launches}")
        if tag in ("dots_saveable", "nothing_saveable"):
            for name in ("flash_sliding_attention", "flash_dense_attention"):
                check(launches[name] > standing[name],
                      f"small-{tag}: {name} not recomputed ({launches[name]} vs "
                      f"{standing[name]})")
        if tag == "everything_saveable":
            check(launches == standing, f"small-{tag}: launches {launches} differ from "
                  f"the run without remat {standing}")


def phase_small_fit_8bit() -> None:
    """``fit`` on ``configs/smoke.yaml`` with ``train.adam_8bit`` for 3
    steps with a refresh, on the card (K9 once per step) and on the CPU
    (its plain version): the losses agree to rtol 1e-3, as in
    `phase_small_fit`. Then the card's checkpoint loads back on the card
    into a fresh train state: parameters and 8-bit state bit for bit."""
    import shutil

    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import _ARRAYS
    from retrieval_augmented_mds_tpu_torch.train.trainer import TrainState
    from retrieval_augmented_mds_tpu_torch.utils.checkpoint import load_train_state

    cfg = small_fit_config("small_8bit", train={"adam_8bit": True})
    ckpt = os.path.join(OUT_DIR, "small_8bit_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(dataclasses.replace(cfg, ckpt_dir=ckpt),
                                                  device="cuda", report=gpu))
    cli.run_fit(cfg, device="cpu", report=cpu)
    check(launches["adam8bit_superleaf_update"] == 3, f"small 8-bit fit: K9 {launches}")
    check(all(n > 0 for name, n in launches.items()
              if name not in ("ivf_probe_topk", *LONG_ONLY, *NO_PATH, *DECODE_ONLY)),
          f"small 8-bit fit: a kernel not launched {launches}")
    lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
    check(len(lg) == 3 and bool(torch.isfinite(lg).all()), f"small 8-bit fit losses {lg}")
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    check(rel <= 1e-3, f"small 8-bit fit: card losses {lg.tolist()} vs CPU {lc.tolist()}")

    params = cli.build_params(cfg, torch.device("cuda"))
    tx = cli.build_tx(cfg, params)
    state, step = load_train_state(ckpt, TrainState.create(params, tx), tx)
    saved = gpu["state"]
    check(step == 3 and state.opt_state.count == saved.opt_state.count == 3,
          f"small 8-bit checkpoint: step {step}")
    for k in _ARRAYS:
        a, b = getattr(state.opt_state, k), getattr(saved.opt_state, k)
        check(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b),
              f"small 8-bit checkpoint: {k} differs")
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              saved.params.named_parameters()):
        check(torch.equal(a, b), f"small 8-bit checkpoint: {n} differs")
    print(f"[small-8bit] configs/smoke.yaml fit with adam_8bit, 3 steps + 1 refresh, card "
          f"vs CPU: losses {[f'{x:.6f}' for x in lg.tolist()]} vs "
          f"{[f'{x:.6f}' for x in lc.tolist()]}, max rel err {rel:.3e} (rtol 1e-3): PASS; "
          f"checkpoint (int8/uint8 moments, NB={saved.opt_state.mu_q.shape[0]}) saved and "
          f"loaded back on the card bit for bit: PASS; card launches {launches}")


SMALL_IVF = {"factory": "IVF16,SQ8", "nprobe": 2}  # C = 15 > B * nprobe = 8


def phase_small_ivf() -> None:
    """``configs/smoke.yaml`` on an ``IVF16,SQ8`` index (15 clusters of the
    123-row corpus, so B * nprobe = 8 < C and the per-query route runs):
    ``predict`` on the card (K8 + K1 on the spill) and on the CPU, equal
    retrieved and generated ids; ``fit`` for 3 steps with a refresh, the
    same losses to rtol 1e-3; then ``build-index`` → ``predict --index``
    on the card, the same retrieved ids as the card's own build."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.index import IVFIndex
    from retrieval_augmented_mds_tpu_torch.index.ivf import ivf_route
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(cfg, index=dataclasses.replace(cfg.index, **SMALL_IVF))
    gpu, cpu = {}, {}
    out_gpu, launches = run_counted(lambda: cli.run_predict(cfg, device="cuda", report=gpu))
    out_cpu = cli.run_predict(cfg, device="cpu", report=cpu)
    idx = gpu["store"].index
    route = ivf_route(idx, cfg.data.batch_size, cfg.model.mips_topk, cfg.index.nprobe,
                      gpu["batch"]["mips_ignore"].shape[1])
    check(isinstance(idx, IVFIndex) and route == "per_query", f"small IVF: route {route}")
    check(launches["ivf_probe_topk"] > 0, f"small IVF: K8 not launched {launches}")
    idx_g, idx_c = gpu["enc"].retrieved_idx.cpu(), cpu["enc"].retrieved_idx
    check(torch.equal(idx_g, idx_c), f"small IVF: retrieved ids {idx_g} != CPU {idx_c}")
    check(torch.equal(gpu["ids"].cpu(), cpu["ids"]) and out_gpu == out_cpu,
          "small IVF: generated ids differ")
    print(f"[small-ivf] configs/smoke.yaml on {SMALL_IVF['factory']} nprobe "
          f"{SMALL_IVF['nprobe']}: {idx.n_clusters} clusters of {idx.clustered.shape[1]} "
          f"rows over {idx.n} rows, spill {idx.n_spill}; route {route}; predict, card vs "
          f"CPU: retrieved ids {idx_g.tolist()} and generated ids equal: PASS; card "
          f"launches {launches}")

    fcfg = small_fit_config("small_ivf", index=SMALL_IVF)
    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(fcfg, device="cuda", report=gpu))
    cli.run_fit(fcfg, device="cpu", report=cpu)
    check(all(n > 0 for name, n in launches.items()
              if name not in ("adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH,
                              *DECODE_ONLY)),
          f"small IVF fit: a kernel not launched {launches}")
    check(len(gpu["refresh_s"]) == 1 and isinstance(gpu["store"].index, IVFIndex),
          "small IVF fit: no IVF refresh")
    lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
    check(len(lg) == 3 and bool(torch.isfinite(lg).all()), f"small IVF fit losses {lg}")
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    check(rel <= 1e-3, f"small IVF fit: card losses {lg.tolist()} vs CPU {lc.tolist()}")
    print(f"[small-ivf] fit, 3 steps + 1 refresh, card vs CPU: losses "
          f"{[f'{x:.6f}' for x in lg.tolist()]} vs {[f'{x:.6f}' for x in lc.tolist()]}, "
          f"max rel err {rel:.3e} (rtol 1e-3): PASS; card launches {launches}")

    path = os.path.join(OUT_DIR, "small_ivf_index")
    built = cli.run_build_index(cfg, path, device="cuda")
    rt = {}
    out_rt = cli.run_predict(cfg, path, device="cuda", report=rt)
    check(isinstance(rt["store"].index, IVFIndex) and rt["store"].nprobe == cfg.index.nprobe,
          "small IVF: --index did not load an IVF store")
    check(torch.equal(rt["enc"].retrieved_idx.cpu(), idx_g) and out_rt == out_gpu,
          "small IVF: predict --index differs from the card's own build")
    print(f"[small-ivf] build-index ({built['n']} rows) -> predict --index on the card: "
          f"the same retrieved ids and predictions: PASS")


def phase_slice(report: dict | None = None) -> dict:
    """The serving slice; ``report`` gets `cli.run_predict`'s report (the
    params, store, batch, encoder output and ids)."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.index import IVFIndex, index_to
    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        ivf_route,
        ivf_search,
        prepare_queries,
        probe_clusters,
    )
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_topk,
        ivf_probe_topk_plain,
    )
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import rag_decode
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(SLICE_CONFIG)
    report = {} if report is None else report
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = run_counted(lambda: cli.run_predict(cfg, device="cuda", report=report))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    store, enc, ids, batch = report["store"], report["enc"], report["ids"], report["batch"]
    b = cfg.data.batch_size
    n = store.index.n
    check(launches["mips_topk"] > 0 and launches["flash_sliding_attention"] > 0,
          f"kernel not launched: {launches}")  # K1: the IVF spill
    preds = out["predictions"]
    check(len(preds) == b and all(p.strip() for p in preds), "empty predictions")
    check(tuple(ids.shape) == (b, cfg.generation.max_new_tokens), f"ids {ids.shape}")
    idx = enc.retrieved_idx
    check(bool(((idx >= 0) & (idx < n)).all()), f"retrieved ids out of [0, {n})")
    ign = batch["mips_ignore"]
    check(not bool(((idx[:, :, None] == ign[:, None, :]) & (ign[:, None, :] >= 0)).any()),
          "a self-excluded corpus row was retrieved")
    for name in ("enc_hidden", "memory", "mips_scores", "query_cls"):
        check(bool(torch.isfinite(getattr(enc, name).float()).all()), f"{name} not finite")
    # the retrieval agrees with the plain IVF search (every kernel's plain
    # version, on the CPU) of the same store on these queries
    idx_obj, nprobe = store.index, store.nprobe
    route = ivf_route(idx_obj, b, cfg.model.mips_topk, nprobe, ign.shape[1])
    check(isinstance(idx_obj, IVFIndex) and route == "per_query", f"route {route}")
    check(launches["ivf_probe_topk"] > 0, f"K8 not launched: {launches}")
    decode_launches = 2 * cfg.model.led.dec_layers * cfg.generation.max_new_tokens
    check(launches["flash_decode_attention"] == decode_launches,
          f"the cached step's attention kernel launched {launches['flash_decode_attention']} "
          f"times, not {decode_launches} (self and cross, each decoder layer and token)")
    _, ref = ivf_search(index_to(idx_obj, "cpu"), enc.query_cls.cpu(), k=cfg.model.mips_topk,
                        nprobe=nprobe, ignore=ign.cpu())
    check(torch.equal(ref, idx.cpu()), f"retrieval {idx.tolist()} differs from the plain "
          f"IVF search {ref.tolist()}")
    # K8 at the slice's own shape: B queries, nprobe probes, k + I hits
    q = prepare_queries(idx_obj, enc.query_cls)
    probes = probe_clusters(idx_obj, q, nprobe).to(torch.int32).contiguous()
    args = (q, idx_obj.clustered, idx_obj.clustered_bias, idx_obj.clustered_scale, probes)
    k_fetch = cfg.model.mips_topk + ign.shape[1]
    err, tol, _ = _k8_check("slice", args, k_fetch)
    ms = cuda_ms(lambda: ivf_probe_topk(*args, k_fetch))
    plain_ms = cuda_ms(lambda: ivf_probe_topk_plain(*args, k_fetch))
    print(f"[slice] IVF index: {idx_obj.n_clusters} clusters x {idx_obj.clustered.shape[1]} "
          f"rows ({idx_obj.clustered.dtype}), spill {idx_obj.n_spill}, nprobe {nprobe}; "
          f"route {route}; retrieval equals the plain IVF search; K8 at B={b} "
          f"nprobe={nprobe} k={k_fetch}: max abs err {err:.3e} (tol {tol:.3e}), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms")
    # one cached decode step from the start token: finite log-probs
    from retrieval_augmented_mds_tpu_torch.models.led import init_decode_caches

    dtype = cli.compute_dtype(cfg)
    caches = init_decode_caches(report["params"].led, cfg.model.led, b, 2, dtype,
                                enc_hidden=enc.enc_hidden)
    start = torch.full((b, 1), cfg.generation.decoder_start_id, dtype=torch.int32,
                       device="cuda")
    logp, _, _ = rag_decode(report["params"], cfg.model, enc, start, caches=caches,
                            dtype=dtype)
    check(tuple(logp.shape) == (b, 1, cfg.model.led.vocab_size), "log-prob shape")
    check(bool(torch.isfinite(logp).all()), "non-finite log-probs")
    mass = logp.double().exp().sum(-1)
    check(bool(((mass - 1).abs() < 1e-2).all()), f"copy mixture mass {mass.tolist()}")

    tokens = b * cfg.generation.max_new_tokens
    print(f"[slice] led_base predict, B={b}, corpus rows {n}, beams "
          f"{cfg.generation.num_beams}, {cfg.generation.max_new_tokens} new tokens")
    print(f"[slice] store build {report['store_s']:.3f} s, rag_encode "
          f"{report['encode_s']:.3f} s, generate {report['generate_s']:.3f} s, "
          f"run_predict total {wall:.3f} s")
    print(f"[slice] decode {tokens / report['generate_s']:.1f} output tokens/s "
          f"(B x max_new_tokens / generate wall); peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[slice] launches during the run: {launches}")
    print(f"[slice] first prediction: {preds[0][:120]}")
    return launches


# ---------------------------------------------------------------------------
# phase 9c: the exported serving step; 9d: the custom op's host time;
# 9e: the host tail
# ---------------------------------------------------------------------------

EXPORT_KERNELS = ("mips_topk", "flash_sliding_attention", "ivf_probe_topk")


def _synced(fn):
    """(fn(), its wall seconds, the device synchronised before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_export(sliced: dict, card: str) -> dict:
    """``cli.run_export`` of the serving slice's config on the card (the
    encode program and the decode-step program, weights and store as
    inputs), then the loaded artifact served with ``[slice]``'s params,
    store and batch: its ids must equal ``[slice]``'s ``run_predict`` ids.
    K1, K2 and K8, launched through their custom ops by the exported
    encode, must launch as often as the eager ``rag_encode`` on the same
    inputs, and at least once each. Prints the export's and the load's
    wall time, the artifact's bytes, and the exported encode and serve
    wall times beside the eager ones (exported, eager, eager, exported).
    Returns the launches of the export and of one exported serve."""
    import shutil

    import torch

    from retrieval_augmented_mds_tpu_torch import cli, serving
    from retrieval_augmented_mds_tpu_torch.models.generate import generate
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import rag_encode
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(SLICE_CONFIG)
    out = os.path.join(OUT_DIR, "export")
    shutil.rmtree(out, ignore_errors=True)
    (manifest, export_s), exported = run_counted(
        lambda: _synced(lambda: cli.run_export(cfg, out, device="cuda")))
    check(manifest["platforms"] == ["cuda"], f"platforms {manifest['platforms']}")
    art, load_s = _synced(lambda: serving.load_serving(out))
    params, store, batch = sliced["params"], sliced["store"], sliced["batch"]
    dtype = cli.compute_dtype(cfg)

    def eager_encode():
        with torch.no_grad():
            return rag_encode(params, cfg.model, store, batch, dtype=dtype)

    (enc_x, enc_x_s), enc_x_l = run_counted(
        lambda: _synced(lambda: serving.serve_encode(art, params, store, batch)))
    (enc_e, enc_e_s), enc_e_l = run_counted(lambda: _synced(eager_encode))
    for name in EXPORT_KERNELS:
        check(enc_x_l[name] > 0 and enc_x_l[name] == enc_e_l[name],
              f"{name}: {enc_x_l[name]} launches in the exported encode, "
              f"{enc_e_l[name]} in the eager one")
    check(torch.equal(enc_x.retrieved_idx, enc_e.retrieved_idx),
          "the exported encode retrieved other rows than the eager one")
    hidden_err = (enc_x.enc_hidden.float() - enc_e.enc_hidden.float()).abs().max().item()

    def eager_serve():
        enc = eager_encode()
        return generate(params, cfg.model, enc, cfg.generation, dtype=dtype)

    runs = {"exported": [], "eager": []}
    served = None
    # the cached step's attention, through ramds::flash_decode in the program
    decode_launches = 2 * cfg.model.led.dec_layers * cfg.generation.max_new_tokens
    for kind in ("exported", "eager", "eager", "exported"):
        fn = (lambda: serving.serve(art, params, store, batch)) if kind == "exported" \
            else eager_serve
        (ids, sec), launches = run_counted(lambda: _synced(fn))
        check(torch.equal(ids.cpu(), sliced["ids"].cpu()),
              f"{kind} serve: ids differ from [slice]'s run_predict ids")
        check(launches["flash_decode_attention"] == decode_launches,
              f"{kind} serve: {launches['flash_decode_attention']} flash_decode launches, "
              f"not {decode_launches}")
        runs[kind].append(sec)
        if kind == "exported" and served is None:
            served = launches
    print(f"[export] led_base predict slice, {card}: run_export {export_s:.3f} s (store "
          f"build, two torch.export traces, save), load {load_s:.3f} s, artifact "
          f"{manifest['bytes']} bytes ({', '.join(os.path.basename(p) for p in manifest['artifact'])})")
    print(f"[export] launches in the exported encode: "
          f"{ {n: enc_x_l[n] for n in EXPORT_KERNELS} }, eager rag_encode: "
          f"{ {n: enc_e_l[n] for n in EXPORT_KERNELS} } (equal); encoder states max abs "
          f"diff {hidden_err:.3e}, retrieved rows equal")
    print(f"[export] encode wall: exported {enc_x_s:.4f} s, eager {enc_e_s:.4f} s; serve "
          f"wall (encode + {cfg.generation.max_new_tokens} decode steps, beam "
          f"{cfg.generation.num_beams}), exported, eager, eager, exported: "
          f"{runs['exported'][0]:.3f}, {runs['eager'][0]:.3f}, {runs['eager'][1]:.3f}, "
          f"{runs['exported'][1]:.3f} s; ids equal [slice]'s in all four, each with "
          f"{decode_launches} flash_decode launches")
    launches = {name: exported[name] + served[name] for name in exported}
    print(f"[export] launches of the phase (run_export, one exported serve): "
          f"{ {n: launches[n] for n in EXPORT_KERNELS} }")
    return launches


def phase_custom_op_overhead() -> None:
    """K2's host time per call through its custom op
    (``ramds::flash_sliding_fwd``, what every path calls) against the direct
    ctypes launch (`sliding_fwd_launch`), and through the whole wrapper
    (checks, op, launch), at the Longformer row's shape (B=8 nh=12 T=512
    dh=64 w=256 G=1 bf16): the host seconds of 200 enqueued calls (the
    device runs behind, the queue never fills), in turns A B B A, 3
    rounds. Launches here are not on a path."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops import flash_sliding as fs

    lf = (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100], [1] * 8)
    args, _, _ = _k2_inputs(*lf, torch.bfloat16, seed=0)
    calls = {"custom op": lambda: fs._sliding_fwd_op(*args),
             "direct ctypes": lambda: fs.sliding_fwd_launch(*args),
             "wrapper": lambda: fs.flash_sliding_attention(*args[:7], window=args[7])}
    ref = calls["direct ctypes"]()
    for name, fn in calls.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"K2 {name} differs")
    n = 200
    times: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(3):
        for name in ("custom op", "direct ctypes", "wrapper", "wrapper", "direct ctypes",
                     "custom op"):
            fn = calls[name]
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[custom_op] K2 host time per call, Longformer row shape, bf16 (us, median of "
          f"{len(times['wrapper'])} runs of {n}): custom op {med['custom op']:.1f}, direct "
          f"ctypes {med['direct ctypes']:.1f} (the op's dispatch: "
          f"{med['custom op'] - med['direct ctypes']:+.1f}), whole wrapper "
          f"{med['wrapper']:.1f}; runs {json.dumps({k: [round(x, 1) for x in v] for k, v in times.items()})}")


def phase_host_tail() -> None:
    """The host tail on the card's machine: `RAGDataModule.batches` through
    the native loader equals the Python gather over the fixture's full
    train epoch at the train slice's B=4 (and the host seconds of each);
    the native CPU MIPS search (`cpu_mips_search`) against f32 K1 on the
    ``bench-index`` mixture of 65536 rows (D = 768, 64 queries): equal ids,
    but where a near-tie swaps two rows (`_near_tie_swaps`); then
    ``bench-index`` at its defaults on the led_base config, printing its
    recalls against that CPU search."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict
    from retrieval_augmented_mds_tpu_torch.utils.cpu_baseline import cpu_mips_search

    cfg = train_slice_config()
    dm, _ = cli.build_data(cfg)
    b = cfg.data.batch_size
    t0 = time.perf_counter()
    nat = list(dm.batches(b, seed=cfg.seed, split="train"))
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = list(dm.batches(b, seed=cfg.seed, split="train", native=False))
    py_s = time.perf_counter() - t0
    check(len(nat) == len(py) > 0, f"{len(nat)} native batches, {len(py)} gathered")
    for i, (bn, bp) in enumerate(zip(nat, py)):
        check(sorted(bn) == sorted(bp) and all(np.array_equal(bn[k], bp[k]) for k in bp),
              f"native batch {i} differs from the Python gather")
    print(f"[host_tail] the fixture's train epoch, B={b}: {len(nat)} native batches equal "
          f"the Python gather's; {nat_s:.3f} s native, {py_s:.3f} s gathered")

    x, q = cli.gaussian_mixture(65536, 768, 64, cfg.seed)
    t0 = time.perf_counter()
    ref_v, ref_i = cpu_mips_search(x, q, 10)
    cpu_s = time.perf_counter() - t0
    qc, xc = torch.from_numpy(q).cuda(), torch.from_numpy(x).cuda()
    vals, ids = mips_topk(qc, xc, 10)
    ref_i, ref_v = torch.from_numpy(ref_i).cuda(), torch.from_numpy(ref_v).cuda()
    swaps, gap, _ = _near_tie_swaps("cpu_baseline", qc, xc, None, ids, ref_i, ref_v)
    err = (vals - ref_v).abs().max().item()
    check(err <= 1e-4 + 1e-5 * ref_v.abs().max().item(), f"K1 values {err:.3e} from the CPU's")
    print(f"[host_tail] cpu_mips_search (native, {cpu_s:.3f} s on the host) against f32 K1: "
          f"65536 x 768 mixture, 64 queries, k=10: ids equal but {swaps} near-tie swaps "
          f"(exact gap {gap:.2e}), values max abs diff {err:.3e}")
    bench = cli.run_bench_index(config_from_dict(SLICE_CONFIG), device="cuda")
    # the bf16 flat index against the exact f32 top-10: bf16 rounding moves
    # scores by ~1 where neighbours sit tens apart
    check(bench["flat_recall"] >= 0.9, f"bench-index flat recall {bench['flat_recall']}")
    print(f"[host_tail] bench-index at its defaults (led_base width): {json.dumps(bench)}")


# ---------------------------------------------------------------------------
# phases 10 and 11: the training slice, and with the capacity knobs on
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4


def train_slice_dict() -> dict:
    """``configs/led_base_multi_x_science.yaml`` cut to a few steps: its
    ``IVF256,SQ8`` index (nprobe 8; 131 clusters over the fixture's 1055
    rows) refreshed every 2 steps, no pretrained weights (seeded random
    init), the hash tokenizer over the committed 2000-example fixture, no
    eval and no checkpoints. Widths, lengths, batch, top-k, memory encoder,
    index and precision are the file's."""
    import yaml

    with open(os.path.join(REPO, "configs", "led_base_multi_x_science.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"] = {k: v for k, v in d["model"].items() if not k.endswith("_weights")}
    d["data"].update(source=FIXTURE, tokenizer=None)
    d["index"].update(rebuild_every=2)
    d.update(max_steps=TRAIN_STEPS, eval_every=0, ckpt_dir=None,
             logging={"log_dir": os.path.join(OUT_DIR, "train_slice"),
                      "run_name": "led_base_train"})
    return d


def train_slice_config():
    """`train_slice_dict` as a config."""
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    return config_from_dict(train_slice_dict())


def _train_run(cfg, tag: str, off_path: tuple[str, ...]) -> tuple[dict, dict]:
    """``cli.run_fit`` of ``cfg`` on the card with the launch counts read
    around it and the peak device memory → (launches, summary). Every
    kernel launches, but those in ``off_path`` and the decoding kernel
    (the fit evaluates nothing), which must not."""
    import gc

    import torch

    from retrieval_augmented_mds_tpu_torch import cli

    off_path = (*off_path, *DECODE_ONLY)
    report: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = run_counted(lambda: cli.run_fit(cfg, device="cuda", report=report))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    losses = report["losses"]
    check(out["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"{tag} slice ran {out['steps']} steps")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    check(math.isfinite(out["grad_norm"]) and out["grad_norm"] > 0,
          f"{tag}: grad_norm {out['grad_norm']}")
    check(len(report["refresh_s"]) == 1, f"{tag}: {len(report['refresh_s'])} store refreshes")
    check(all(n > 0 for name, n in launches.items() if name not in off_path),
          f"{tag}: kernel not launched: {launches}")
    check(all(launches[name] == 0 for name in off_path),
          f"{tag}: a kernel off this path launched: {launches}")
    if "adam8bit_superleaf_update" not in off_path:
        check(launches["adam8bit_superleaf_update"] == TRAIN_STEPS,
              f"{tag}: K9 launches {launches}")
    store = report["store"]
    check(type(store.index).__name__ == "IVFIndex" and store.nprobe == cfg.index.nprobe,
          f"the {tag} slice's store is not the config's IVF index")
    params = report["state"].params
    check(all(bool(torch.isfinite(p).all()) for p in params.parameters()),
          f"{tag}: non-finite parameters after the steps")
    d, t = cfg.data, cfg.train
    print(f"[{tag}] led_base fit, B={d.batch_size}, max_length {d.max_length}, decoder "
          f"{d.decoder_max_length}, query {d.query_max_length}, memory {d.memory_len} "
          f"x top-{cfg.model.mips_topk}, {cfg.precision} compute, f32 master weights, "
          f"memory_model_fixed={cfg.model.memory_model_fixed}, corpus rows "
          f"{store.index.n}, index {cfg.index.factory} ({store.index.n_clusters} clusters, "
          f"nprobe {store.nprobe}), {sum(p.numel() for p in params.parameters())} "
          f"parameters; optimizer {'8-bit AdamW' if t.adam_8bit else 'AdamW, bf16 mu'}, "
          f"remat {t.remat!r}")
    print(f"[{tag}] losses {[f'{x:.5f}' for x in losses]}; last metrics "
          f"{json.dumps({k: round(v, 6) for k, v in out.items()})}")
    print(f"[{tag}] step wall s {[f'{x:.3f}' for x in report['step_s']]} (each phase "
          f"synchronised)")
    for i, ph in enumerate(report["phase_s"]):
        print(f"[{tag}]   step {i}: forward {ph['forward']:.3f} s, backward "
              f"{ph['backward']:.3f} s, optimizer {ph['optimizer']:.3f} s")
    print(f"[{tag}] store build {report['store_s']:.3f} s, refresh "
          f"{report['refresh_s'][0]:.3f} s, run_fit total {wall:.3f} s (data and "
          f"init included); peak device memory {peak / 2**30:.2f} GiB")
    print(f"[{tag}] launches during the run: {launches}")
    # the steady steps: the last two (the first pays the kernels' first
    # calls, the third follows the store refresh)
    steady = report["step_s"][-2:]
    summary = {"peak_gib": peak / 2**30, "step_s": sum(steady) / len(steady), "losses": losses,
               "retrieved": [r.cpu() for r in report["retrieved"]],
               "copy_force": report["copy_force"],
               **{k: sum(ph[k] for ph in report["phase_s"][-2:]) / 2
                  for k in ("forward", "backward", "optimizer")}}
    print(f"[{tag}] steady (mean of the last two steps): step {summary['step_s']:.3f} s "
          f"({cfg.data.batch_size / summary['step_s']:.2f} examples/s), forward "
          f"{summary['forward']:.3f} s, backward {summary['backward']:.3f} s, optimizer "
          f"{summary['optimizer']:.3f} s")
    return launches, summary


def phase_train_slice() -> tuple[dict, dict]:
    return _train_run(train_slice_config(), "train",
                      off_path=("adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH))


def phase_train_f32_slice() -> tuple[dict, dict]:
    """The train slice in f32: `train_slice_config` with ``precision:
    float32``, the JAX package's and the port's default, so the decoder's
    attention runs f32 K4/K5 (split TF32) and the encoders f32 K2/K3. Each
    decoder layer launches K4 and K5 once for its causal self-attention and
    once for its cross-attention on every step. Its losses are printed in
    full, for an A/B of two trees (steps 0 and 1 run before the store
    refresh)."""
    cfg = train_slice_config()
    cfg = dataclasses.replace(
        cfg, precision="float32",
        logging=dataclasses.replace(cfg.logging, run_name="led_base_f32"))
    launches, summary = _train_run(
        cfg, "train_f32", off_path=("adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH))
    per_run = 2 * cfg.model.led.dec_layers * TRAIN_STEPS
    for name in ("flash_dense_attention", "flash_dense_backward"):
        check(launches[name] == per_run,
              f"train_f32: {name} launched {launches[name]} times, not {per_run} (self "
              f"and cross per decoder layer and step)")
    print(f"[train_f32] f32 K4/K5 launched {per_run} times each ({cfg.model.led.dec_layers} "
          f"decoder layers x self + cross x {TRAIN_STEPS} steps); losses in full "
          f"{[repr(x) for x in summary['losses']]}")
    return launches, summary


def phase_train_target_in_slice() -> dict:
    """The train slice under ``model.memory_forcing: target_in`` with
    ``copy_forcing: 0.5``: the gold target's memory slot first, then the
    top-2 retrieved rows, so the memory and mips encoders (K2/K3) run over
    B x 3 rows of 512 tokens and the decoder's copy head attends 3 x 512
    memory positions. `run_fit` draws each step's flag from (seed, step);
    a step whose flag is off masks the target slot whole. Checks: the flags
    equal the numpy draw, every step's memory is [B, 3 x 512, 768], the
    target slot is masked off exactly on the steps whose flag is off,
    finite losses and gradient norm (`_train_run`) → the launches."""
    import numpy as np

    from retrieval_augmented_mds_tpu_torch.train import trainer

    cfg = train_slice_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, memory_forcing="target_in",
                                       copy_forcing=0.5),
        logging=dataclasses.replace(cfg.logging, run_name="led_base_target_in"))
    seen = []  # per step: the memory's shape, and whether the target slot is open
    forward = trainer.rag_forward

    def recorded(*args, **kw):
        out = forward(*args, **kw)
        enc = out[2]
        seen.append((tuple(enc.memory.shape),
                     enc.memory_mask[:, :cfg.data.memory_len].any().detach()))
        return out

    trainer.rag_forward = recorded
    try:
        launches, summary = _train_run(cfg, "train_target_in", off_path=(
            "adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH))
    finally:
        trainer.rag_forward = forward
    want = [bool(np.random.default_rng([cfg.seed, s]).random() < cfg.model.copy_forcing)
            for s in range(TRAIN_STEPS)]
    flags = summary["copy_force"]
    check(flags == want, f"train_target_in: flags {flags}, the numpy draw {want}")
    shape = (cfg.data.batch_size, cfg.model.memory_slots * cfg.data.memory_len,
             cfg.model.memory_enc.d_model)
    check(len(seen) == TRAIN_STEPS and all(sh == shape for sh, _ in seen),
          f"train_target_in: memory shapes {[sh for sh, _ in seen]}, not {shape}")
    open_ = [bool(o) for _, o in seen]
    check(open_ == flags, f"train_target_in: target slot open {open_} on flags {flags}")
    print(f"[train_target_in] copy_force per step {flags} (= default_rng([seed, step])"
          f".random() < {cfg.model.copy_forcing}); memory {list(shape)} on every step; the "
          f"target slot masked whole on the steps whose flag is off: PASS")
    return launches


def phase_predict_sample() -> dict:
    """The predict slice with sampled decoding and copy traces: one beam,
    ``do_sample`` (temperature 0.8, top-k 50, top-p 0.95) and
    ``output_copy_probs``, 256 new tokens. The traces' teacher-forced
    decoder pass runs K4 (f32, as the JAX package's `copy_trace` runs it)
    for each decoder layer's self- and cross-attention. Checks: the traces
    serialise with ``json.dumps`` as they are; the same seed gives the
    same ids bit for bit; top-k 1 gives the greedy ids bit for bit; and
    `copy_trace` on the card against the same call on the CPU (the plain
    versions, on the same encoder outputs and ids): gate and mass within
    2^-8 of the CPU's, relatively (a bf16 step), the top-4 positions equal
    wherever the 4th and 5th probabilities are more than 2^-8 of the 4th
    apart → the launches."""
    import copy

    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models.generate import copy_trace, generate
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    d = copy.deepcopy(SLICE_CONFIG)
    d["generation"].update(num_beams=1, do_sample=True, temperature=0.8, top_k=50,
                           top_p=0.95, output_copy_probs=True)
    cfg = config_from_dict(d)
    report: dict = {}
    out, launches = run_counted(lambda: cli.run_predict(cfg, device="cuda", report=report))
    params, enc, ids = report["params"], report["enc"], report["ids"]
    b, t = ids.shape
    dec_layers = cfg.model.led.dec_layers
    check(launches["flash_dense_attention"] == 2 * dec_layers,
          f"predict_sample: K4 launched {launches['flash_dense_attention']} times, not "
          f"{2 * dec_layers} (self + cross per decoder layer)")
    check(launches["mips_topk"] > 0 and launches["ivf_probe_topk"] > 0
          and launches["flash_sliding_attention"] > 0, f"predict_sample: launches {launches}")
    text = json.dumps(out)
    traces = out["copy_traces"]
    check(list(traces) == ["copy_gate", "copy_mass", "top_mem_pos", "top_mem_tok",
                           "top_mem_prob"], f"predict_sample: trace keys {list(traces)}")
    check(len(traces["top_mem_pos"]) == b and len(traces["top_mem_pos"][0]) == t
          and len(traces["top_mem_pos"][0][0]) == 4, "predict_sample: trace shapes")
    dtype = cli.compute_dtype(cfg)
    check(torch.equal(generate(params, cfg.model, enc, cfg.generation, dtype=dtype), ids),
          "predict_sample: the same seed gave other ids")
    greedy = generate(params, cfg.model, enc,
                      dataclasses.replace(cfg.generation, do_sample=False), dtype=dtype)
    top1 = generate(params, cfg.model, enc, dataclasses.replace(cfg.generation, top_k=1),
                    dtype=dtype)
    check(torch.equal(top1, greedy), "predict_sample: top-k 1 sampling is not greedy")
    check(not torch.equal(ids, greedy), "predict_sample: sampling gave the greedy ids")

    tol, p = 2.0 ** -8, 4
    start = cfg.generation.decoder_start_id
    card = copy_trace(params, cfg.model, enc, ids, decoder_start_id=start,
                      top_positions=p + 1)
    cpu_enc = dataclasses.replace(enc, **{f.name: getattr(enc, f.name).cpu()
                                          for f in dataclasses.fields(enc)
                                          if getattr(enc, f.name) is not None})
    ref = copy_trace(cli.build_params(cfg, torch.device("cpu")), cfg.model, cpu_enc,
                     ids.cpu(), decoder_start_id=start, top_positions=p + 1)
    errs = {k: ((card[k].cpu() - ref[k]).abs() / ref[k].abs()).max().item()
            for k in ("copy_gate", "copy_mass")}
    check(all(e <= tol for e in errs.values()), f"predict_sample: copy_trace card vs CPU {errs}")
    probs = ref["top_mem_prob"]
    clear = (probs[..., p - 1] - probs[..., p]) > tol * probs[..., p - 1]
    same = (card["top_mem_pos"][..., :p].cpu() == ref["top_mem_pos"][..., :p]).all(-1)
    check(bool(clear.any()) and bool(same[clear].all()),
          f"predict_sample: top positions differ from the CPU's ({int(clear.sum())} clear)")
    tokens = b * t
    print(f"[predict_sample] led_base predict, B={b}, 1 beam, sampled (temperature 0.8, "
          f"top-k 50, top-p 0.95), {t} new tokens, output_copy_probs: generate "
          f"{report['generate_s']:.3f} s ({tokens / report['generate_s']:.1f} output "
          f"tokens/s), copy_trace {report['copy_trace_s']:.3f} s (K4 launched "
          f"{launches['flash_dense_attention']} times), traces {len(text)} bytes of JSON")
    print(f"[predict_sample] one seed twice: equal ids; top-k 1 = greedy: PASS; copy_trace "
          f"card vs CPU: max rel err gate {errs['copy_gate']:.3e}, mass "
          f"{errs['copy_mass']:.3e} (tol 2^-8), top-{p} positions equal at the "
          f"{int(clear.sum())} of {clear.numel()} tokens whose 4th and 5th probabilities "
          f"are more than 2^-8 of the 4th apart: PASS")
    print(f"[predict_sample] launches during the run: {launches}")
    return launches


def phase_capacity_slice(standing: tuple[dict, dict]) -> dict:
    """The train slice with the capacity knobs on: ``train.adam_8bit``
    (kernel K9, one launch per step) and ``train.remat: true`` (every layer
    of every encoder and of the decoder recomputed in the backward, so the
    forward kernels K2 and K4 launch again there). Its peak memory and
    steady step beside the standing slice's, from this call."""
    cfg = train_slice_config()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, adam_8bit=True, remat=True),
        logging=dataclasses.replace(cfg.logging, run_name="led_base_capacity"))
    launches, cap = _train_run(cfg, "capacity", off_path=(*LONG_ONLY, *NO_PATH))
    base_launches, base = standing
    for name in ("flash_sliding_attention", "flash_dense_attention"):
        check(launches[name] > base_launches[name],
              f"capacity: {name} not recomputed ({launches[name]} vs {base_launches[name]})")
    print("[capacity] against the standing train slice of this call (steady = mean of "
          "the last two steps): " + "; ".join(
              f"{k} {base[k]:.3f} -> {cap[k]:.3f}" + (" GiB" if k == "peak_gib" else " s")
              for k in ("peak_gib", "step_s", "forward", "backward", "optimizer")))
    return launches


LONG_SOURCE = 16384  # the LED's max_src_len (models/config.py)
# a step whose search retrieved another row for an example than the
# standing slice's. On an H100 the refresh swapped the second row of every
# example (554 for 556), which moved the loss by 6.9e-4 and 1.24e-3,
# against 4.3e-5 and 5.3e-5 at the steps that retrieved the same rows:
# held at 4x the larger swap. The same rows in another order count as the
# same rows (losses within 4.3e-5 of each other on an H100)
RETRIEVAL_FLIP_RTOL = 5e-3


def phase_long_slice(standing: tuple[dict, dict]) -> dict:
    """The train slice on long sources: ``data.max_length`` 16384, the
    rest of the config as `train_slice_config`. The sources are padded to
    16384 tokens, so every kernel does the full-length work: K2/K3 over
    16384 rows per LED encoder layer, K6/K7 over 16384 keys per decoder
    layer's cross-attention (once per layer and step each), K4/K5 only for
    the decoder's causal self-attention. When no source of its steps is cut
    at the standing slice's 2048 tokens, both slices see the same tokens,
    and each step's loss is held to the standing slice's. A step that
    retrieved the same rows in both must agree to rtol 1e-4 (bf16 roundings
    differ: K4 and K6 run one forward kernel, which rounds p to bf16 as an
    operand and skips the same padded tiles in both slices, but K7
    recomputes p from one LSE where K5 recomputes it from m and l, and the
    GEMMs around them run over 16384 source rows instead of 2048). Those
    roundings also move
    the parameters a little, so after a store refresh a nearly tied search
    (random weights) may retrieve another row for an example; the memory
    then differs, and such a step is held to `RETRIEVAL_FLIP_RTOL`."""
    import numpy as np

    from retrieval_augmented_mds_tpu_torch import cli

    cfg = train_slice_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, max_length=LONG_SOURCE),
        logging=dataclasses.replace(cfg.logging, run_name="led_base_long"))
    check(cfg.model.led.max_src_len == LONG_SOURCE, "the LED's max_src_len is not 16384")
    dm, _ = cli.build_data(cfg)
    batches = dm.batches(cfg.data.batch_size, seed=cfg.seed, split="train")
    lengths = [int(n) for _, bt in zip(range(TRAIN_STEPS), batches)
               for n in bt["attention_mask"].sum(1)]
    print(f"[long] sources padded to {LONG_SOURCE} tokens; valid source tokens of the "
          f"{len(lengths)} examples of the {TRAIN_STEPS} steps: mean "
          f"{np.mean(lengths):.1f}, min {min(lengths)}, max {max(lengths)} (the rest is "
          f"padding, which every kernel computes)")
    launches, summary = _train_run(cfg, "long",
                                   off_path=("adam8bit_superleaf_update", *NO_PATH))
    per_step = cfg.model.led.dec_layers * TRAIN_STEPS
    for name in (*LONG_ONLY, "flash_dense_attention", "flash_dense_backward"):
        check(launches[name] == per_step,
              f"long: {name} launched {launches[name]} times, not {per_step} (one per "
              f"decoder layer and step)")
    print(f"[long] K6/K7 launched {per_step} times each (the decoder's cross-attention, "
          f"{cfg.model.led.dec_layers} layers x {TRAIN_STEPS} steps), K4/K5 {per_step} "
          f"times each (its causal self-attention only)")
    base = standing[1]
    if max(lengths) <= train_slice_config().data.max_length:
        ref, got = np.asarray(base["losses"]), np.asarray(summary["losses"])
        rel = np.abs(got - ref) / np.abs(ref)
        check(len(base["retrieved"]) == len(summary["retrieved"]) == TRAIN_STEPS,
              "long: a step searched no store")
        for i, (a, b) in enumerate(zip(base["retrieved"], summary["retrieved"])):
            # the same rows in another order (a near tie) is the same memory
            swapped = (a.sort(1).values != b.sort(1).values).any(1).nonzero().flatten().tolist()
            tol = RETRIEVAL_FLIP_RTOL if swapped else 1e-4
            check(rel[i] <= tol, f"long: step {i} loss {got[i]} differs from the standing "
                  f"slice's {ref[i]} on the same tokens by rel {rel[i]:.3e} > {tol}")
            print(f"[long] step {i}: the same tokens as the standing train slice (no source "
                  f"passes its 2048), " + (
                      f"other rows retrieved for example(s) {swapped} (standing "
                      f"{a[swapped].tolist()}, long {b[swapped].tolist()}): loss within "
                      f"rtol {tol}" if swapped else
                      f"the same rows retrieved{' (in another order)' if (a != b).any() else ''}: "
                      f"loss within rtol {tol}")
                  + f", rel diff {rel[i]:.3e}: PASS")
    print("[long] against the standing train slice of this call: " + "; ".join(
        f"{k} {base[k]:.3f} -> {summary[k]:.3f}" + (" GiB" if k == "peak_gib" else " s")
        for k in ("peak_gib", "step_s", "forward", "backward", "optimizer")))
    return launches


# ---------------------------------------------------------------------------
# phase 13: the retriever slice (pretrain-retriever, then the handoff)
# ---------------------------------------------------------------------------

RET_STEPS, RET_EVAL_EVERY = 4, 2  # one periodic full-KB validation, then the last


def led_base_config(name: str, model: dict | None = None, **over):
    """``configs/led_base_multi_x_science.yaml`` AS WRITTEN (its four
    ``*_weights`` hub names kept), over the committed 2000-example fixture
    with the hash tokenizer, its logs and checkpoints under
    ``OUT_DIR/<name>``; ``model`` updates the model fields, ``over``
    replaces top-level fields."""
    import yaml

    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    with open(os.path.join(REPO, "configs", "led_base_multi_x_science.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source=FIXTURE, tokenizer=None)
    d["model"].update(model or {})
    d.update(ckpt_dir=os.path.join(OUT_DIR, name, "ckpt"),
             logging={"log_dir": os.path.join(OUT_DIR, name), "run_name": name}, **over)
    return config_from_dict(d)


def _skips(fn):
    """fn() with the warnings it gives recorded → (result, the ``[weights]
    SKIPPING`` messages among them)."""
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w if "[weights] SKIPPING" in str(x.message)]


def phase_retriever_slice(report: dict | None = None) -> dict:
    """``pretrain-retriever`` at full width: the Longformer-base query and
    mips encoders of the led_base preset (768 wide, 12 heads, 12 layers,
    window 256; queries and positives 512 tokens), B=4, f32 (as the JAX
    package trains them), AdamW as the config builds it, over the 1997
    positive pairs of the fixture; `RET_STEPS` steps with a full-KB
    validation after step 2 and at the end (each encodes 2 x 1997 rows in
    batches of 64 and searches them with K1 in f32), ``encoders.npz``
    exported at the best. Then ``--mode test`` and ``--mode predict`` on that
    file, and the summarizer's ``predict`` on the same config with
    ``model.encoder_state_path`` set to it (the handoff). The config keeps
    its hub names: each run warns for each one and keeps the seeded init
    (no hub is reachable here). Checks: finite losses; the file holds the
    weights of the exporting validation; test's metrics equal that
    validation's; the handoff's query and mips encoders equal the file; K1,
    K2 and K3 launched in training, and K10 nowhere. ``report`` receives
    the training run's report (losses, validations and their wall times)."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.checkpoint import load_arrays

    cfg = led_base_config("retriever", max_steps=RET_STEPS, eval_every=RET_EVAL_EVERY)
    report = {} if report is None else report
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (out, launches), skipped = _skips(lambda: run_counted(
        lambda: cli.run_pretrain_retriever(cfg, device="cuda", report=report)))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = report["losses"]
    check(len(losses) == RET_STEPS and all(math.isfinite(x) for x in losses),
          f"retriever: losses {losses}")
    check(len(skipped) == 2, f"retriever: {len(skipped)} weight skips, not 2: {skipped}")
    check(len(report["val"]) == 2, f"retriever: {len(report['val'])} validations")
    for name in ("mips_topk", "flash_sliding_attention", "flash_sliding_backward"):
        check(launches[name] > 0, f"retriever: {name} not launched: {launches}")
    check(launches["mips_topk"] == 2 and launches["mips_chunkmax"] == 0,
          f"retriever: K1 once per validation, K10 never: {launches}")
    path = os.path.join(cfg.ckpt_dir, "encoders.npz")
    saved = load_arrays(path)
    exported = report["exported"]
    check(len(saved) == len(exported) and all(
        torch.equal(saved[k.replace(".", "/")], v.cpu()) for k, v in exported.items()),
        "retriever: encoders.npz differs from the weights of the exporting validation")
    at = report["val"][[RET_EVAL_EVERY, RET_STEPS].index(report["export_step"])]
    n_pairs = len(report["pairs"]["query_input_ids"])
    classes = np.bincount(cli.positive_classes(report["pairs"]))
    enc = cfg.model.query_enc
    print(f"[retriever] pretrain-retriever, {cfg.model.led.d_model}-wide led_base preset's "
          f"encoders ({enc.n_layers} layers, {enc.d_model} wide, {enc.n_heads} heads, window "
          f"{enc.window}), f32, B={cfg.data.batch_size}, query/positive {cfg.data.query_max_length}/"
          f"{cfg.data.memory_len} tokens, {n_pairs} pairs ({len(classes)} distinct "
          f"positives, classes up to {classes.max()}), "
          f"{sum(p.numel() for p in report['state'].params.parameters())} parameters; "
          f"{len(skipped)} hub names skipped (seeded init)")
    print(f"[retriever] losses {[f'{x:.5f}' for x in losses]}; validations "
          f"{[{k: round(v, 6) for k, v in vm.items()} for vm in report['val']]}; "
          f"exported at step {report['export_step']}")
    steady = report["step_s"][-2:]
    step_s = sum(steady) / len(steady)
    print(f"[retriever] step wall s {[f'{x:.3f}' for x in report['step_s']]}; steady (mean "
          f"of the last two) {step_s:.3f} s ({cfg.data.batch_size / step_s:.2f} examples/s); "
          f"full-KB validation wall s {[f'{x:.3f}' for x in report['val_s']]}; run total "
          f"{wall:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
    print(f"[retriever] launches during the training run: {launches}")

    counted = dict(launches)
    for mode, run in (("test", cli.run_pretrain_retriever_test),
                      ("predict", cli.run_pretrain_retriever_predict)):
        t0 = time.perf_counter()
        (res, n), skipped = _skips(lambda: run_counted(lambda: run(cfg, device="cuda")))
        check(len(skipped) == 2, f"retriever {mode}: {len(skipped)} weight skips")
        check(n["mips_topk"] == 1 and n["flash_sliding_attention"] > 0,
              f"retriever {mode}: launches {n}")
        counted = {k: counted[k] + n[k] for k in counted}
        if mode == "test":
            check(res["n_queries"] == n_pairs and all(
                abs(res[f"test_{k}"] - v) <= 1e-6 for k, v in at.items()),
                f"retriever test: {res} differs from the exporting validation's {at}")
        else:
            with open(os.path.join(cfg.logging.log_dir, "retriever_predictions.json")) as f:
                dump = json.load(f)
            check(len(dump) == n_pairs == res["n_queries"], "retriever predict: dump size")
            check(all(abs(res[k] - v) <= 1e-6 for k, v in at.items()),
                  f"retriever predict: {res} differs from {at}")
        print(f"[retriever] --mode {mode}: {json.dumps(res)} in "
              f"{time.perf_counter() - t0:.3f} s (data and set-up included); equal to the "
              f"exporting validation's: PASS")

    hand = led_base_config("handoff", model={"encoder_state_path": path})
    check(hand.model.led_weights and hand.model.memory_encoder_weights,
          "handoff: the config's weight names were dropped")
    rep: dict = {}
    t0 = time.perf_counter()
    (pred, n), skipped = _skips(lambda: run_counted(
        lambda: cli.run_predict(hand, device="cuda", report=rep)))
    check(len(skipped) == 4, f"handoff: {len(skipped)} weight skips, not 4")
    params = dict(rep["params"].named_parameters())
    check(all(torch.equal(params[k.replace("/", ".")].cpu(), v) for k, v in saved.items()),
          "handoff: the summarizer's encoders differ from encoders.npz")
    check(len(pred["predictions"]) == hand.data.batch_size
          and all(p.strip() for p in pred["predictions"]), "handoff: empty predictions")
    check(bool(torch.isfinite(rep["enc"].enc_hidden.float()).all()), "handoff: non-finite")
    counted = {k: counted[k] + n[k] for k in counted}
    print(f"[handoff] predict on configs/led_base_multi_x_science.yaml as written + "
          f"model.encoder_state_path: 4 hub names skipped; query/mips encoders equal "
          f"encoders.npz ({len(saved)} arrays): PASS; {time.perf_counter() - t0:.3f} s; "
          f"launches {n}")
    check(counted["mips_chunkmax"] == 0, "retriever slice: K10 launched")
    return counted


# ---------------------------------------------------------------------------
# the BART and T5 baselines (`fit` with `baseline:`)
# ---------------------------------------------------------------------------

DENSE_PAIR = ("flash_dense_attention", "flash_dense_backward")


def _baseline_launches(tag, cfg, launches, steps, val_batches) -> None:
    """BART launches K4 once per encoder layer and twice per decoder layer
    (causal self, cross) on every step, K5 as many, and for each val batch's
    greedy decoding K4 once per encoder layer and the cached step's
    attention kernel twice per decoder layer and token; T5 launches no
    kernel (its attention is plain, as in the JAX package); no other kernel
    is on either path."""
    led = cfg.model.led
    per_step = led.enc_layers + 2 * led.dec_layers
    if cfg.baseline == "bart":
        want = {"flash_dense_attention": per_step * steps + led.enc_layers * val_batches,
                "flash_dense_backward": per_step * steps,
                "flash_decode_attention": 2 * led.dec_layers
                * cfg.generation.max_new_tokens * val_batches}
    else:
        want = {name: 0 for name in DENSE_PAIR}
    want = {name: want.get(name, 0) for name in launches}
    check(launches == want, f"{tag}: launches {launches}, not {want}")


def baseline_small_config(family: str):
    """``configs/baseline_bart.yaml`` (tiny preset, f32, 6 steps, one val
    batch of 3 rows padded to 4) with ``baseline: family`` and its logs
    under ``OUT_DIR/baseline_small_<family>``."""
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "baseline_bart.yaml"))
    return dataclasses.replace(cfg, baseline=family, logging=dataclasses.replace(
        cfg.logging, log_dir=os.path.join(OUT_DIR, f"baseline_small_{family}")))


def phase_baseline_small() -> None:
    """``run_fit_baseline`` of ``configs/baseline_bart.yaml``, BART and T5,
    on the card (BART's attention on K4/K5) and on the CPU (the plain
    versions), from one seed: finite losses within rtol 1e-3, as
    `_small_fit`'s, equal greedy val ids, and the launches of
    `_baseline_launches`. Then the BART run again through ``fit --profile``
    (`cli.main`): its losses those of the first card run within rtol 1e-6,
    and its Chrome trace under ``<log_dir>/trace`` naming the K4/K5 kernels
    (``mma_fwd_kernel``; ``mma_dq_kernel`` and ``mma_dkv_kernel``)."""
    import numpy as np
    import torch
    import yaml

    from retrieval_augmented_mds_tpu_torch import cli

    for family in ("bart", "t5"):
        cfg = baseline_small_config(family)
        gpu, cpu = {}, {}
        t0 = time.perf_counter()
        _, launches = run_counted(lambda: cli.run_fit_baseline(cfg, device="cuda", report=gpu))
        wall = time.perf_counter() - t0
        cli.run_fit_baseline(cfg, device="cpu", report=cpu)
        lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
        check(len(lg) == cfg.max_steps and bool(torch.isfinite(lg).all()),
              f"baseline_small {family}: losses {lg}")
        rel = ((lg - lc).abs() / lc.abs()).max().item()
        check(rel <= 1e-3, f"baseline_small {family}: card losses {lg.tolist()} vs CPU "
              f"{lc.tolist()}")
        check(len(gpu["val_ids"]) == len(cpu["val_ids"]) == 1
              and all(np.array_equal(a, b) for a, b in zip(gpu["val_ids"], cpu["val_ids"])),
              f"baseline_small {family}: greedy ids differ: {gpu['val_ids']} vs "
              f"{cpu['val_ids']}")
        _baseline_launches(f"baseline_small {family}", cfg, launches, cfg.max_steps, 1)
        print(f"[baseline_small] {family}: configs/baseline_bart.yaml, card vs CPU: losses "
              f"{[f'{x:.6f}' for x in lg.tolist()]} vs {[f'{x:.6f}' for x in lc.tolist()]}, "
              f"max rel err {rel:.3e} (rtol 1e-3); greedy val ids equal "
              f"({gpu['val_ids'][0].shape}); card launches {launches}: PASS; card run "
              f"{wall:.3f} s")
        if family != "bart":
            continue
        log_dir = os.path.join(OUT_DIR, "baseline_small_profile")
        d = dataclasses.asdict(dataclasses.replace(cfg, logging=dataclasses.replace(
            cfg.logging, log_dir=log_dir)))
        d["model"] = {"preset": "tiny"}
        path = os.path.join(OUT_DIR, "baseline_small_profile.yaml")
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        trace_dir = os.path.join(log_dir, "trace")
        if os.path.isdir(trace_dir):
            for name in os.listdir(trace_dir):
                os.remove(os.path.join(trace_dir, name))
        metrics = os.path.join(log_dir, f"{cfg.logging.run_name}_bart.metrics.jsonl")
        if os.path.exists(metrics):
            os.remove(metrics)
        code, prof = run_counted(lambda: cli.main(["fit", "--config", path, "--profile"]))
        check(code == 0 and prof == launches, f"fit --profile: exit {code}, launches {prof}")
        with open(metrics) as f:
            lp = torch.tensor([json.loads(x)["loss"] for x in f])
        check(torch.allclose(lp, lg, rtol=1e-6, atol=0), f"fit --profile losses {lp} vs {lg}")
        (name,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        found = {k: sum(k in n for n in kernels) for k in
                 ("mma_fwd_kernel", "mma_dq_kernel", "mma_dkv_kernel")}
        check(all(found.values()), f"fit --profile: K4/K5 kernels not in the trace "
              f"({found}; {len(kernels)} kernel names)")
        print(f"[baseline_small] bart through `fit --profile`: losses equal the card run's "
              f"(rtol 1e-6); trace {os.path.relpath(os.path.join(trace_dir, name), REPO)} "
              f"({os.path.getsize(os.path.join(trace_dir, name))} bytes, {len(events)} "
              f"events, {len(kernels)} kernel names) names K4/K5: {found}: PASS")


BASELINE_STEPS = 4
BASELINE_NEW_TOKENS = 128


def baseline_config(family: str, steps: int = BASELINE_STEPS,
                    new_tokens: int = BASELINE_NEW_TOKENS, tag: str = "") -> dict:
    """The baseline's config at its reference width (a dict of the config
    schema), seeded random weights, over the committed 2000-example fixture
    with the hash tokenizer: BART on the ``led_large`` preset with
    ``facebook/bart-large``'s vocabulary and 1024 positions (d 1024, 16
    heads, 12 + 12 layers, FFN 4096), sources of 1024 tokens; T5 at
    ``t5-large``'s shape (d 1024, 16 heads, 24 + 24 layers, FFN 4096,
    vocabulary 32128), sources of 512 tokens; targets of 512, B = 4,
    ``steps`` steps, then greedy decoding of one val batch for
    ``new_tokens`` tokens; logs under ``OUT_DIR/baseline_<family><tag>``.
    Everything else is the config schema's default (lr 3e-5, warmup 1000,
    clip 0.1, bf16 mu, f32)."""
    if family == "bart":
        led, max_length = {"vocab_size": 50265, "max_src_len": 1024, "max_tgt_len": 1024}, 1024
    else:
        led = {"vocab_size": 32128, "d_model": 1024, "n_heads": 16, "enc_layers": 24,
               "dec_layers": 24, "d_ffn": 4096, "max_src_len": 512, "max_tgt_len": 512}
        max_length = 512
    return {
        "baseline": family, "model": {"preset": "led_large", "led": led},
        "data": {"source": FIXTURE, "tokenizer": None, "max_length": max_length,
                 "decoder_max_length": 512, "batch_size": 4},
        "generation": {"max_new_tokens": new_tokens},
        "max_steps": steps, "eval_max_batches": 1, "seed": 0,
        "logging": {"log_dir": os.path.join(OUT_DIR, f"baseline_{family}{tag}"),
                    "run_name": f"{family}_large"}}


def phase_baseline(family: str, card: str) -> dict:
    """``run_fit_baseline`` of `baseline_config` on the card, with the launch
    counts read around it (`_baseline_launches`) and the peak device
    memory: finite losses and parameters, the greedy ids of the val batch;
    prints the steady step (the mean of the last two), the ``generate``
    time and the peak beside the card → the launches."""
    import gc

    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    tag = f"baseline_{family}"
    cfg = config_from_dict(baseline_config(family))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep: dict = {}
    t0 = time.perf_counter()
    out, launches = run_counted(lambda: cli.run_fit_baseline(cfg, device="cuda", report=rep))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = rep["losses"]
    check(out["steps"] == BASELINE_STEPS == len(losses)
          and all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    params = rep["state"].params
    n_params = sum(p.numel() for p in params.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in params.parameters()),
          f"{tag}: non-finite parameters after the steps")
    (ids,) = rep["val_ids"]
    check(ids.shape == (cfg.data.batch_size, BASELINE_NEW_TOKENS)
          and bool(((ids >= 0) & (ids < cfg.model.led.vocab_size)).all()),
          f"{tag}: greedy ids {ids.shape}")
    _baseline_launches(tag, cfg, launches, BASELINE_STEPS, 1)
    led, d = cfg.model.led, cfg.data
    steady = sum(rep["step_s"][-2:]) / 2
    gen_s = rep["generate_s"][0]
    print(f"[{tag}] {family} at d {led.d_model}, {led.n_heads} heads, {led.enc_layers} + "
          f"{led.dec_layers} layers, FFN {led.d_ffn}, vocabulary {led.vocab_size}: "
          f"{n_params} parameters, f32, AdamW (bf16 mu); B={d.batch_size}, sources "
          f"{d.max_length}, targets {d.decoder_max_length}")
    print(f"[{tag}] losses {[f'{x:.5f}' for x in losses]}; step wall s "
          f"{[f'{x:.3f}' for x in rep['step_s']]}; greedy ids of the val batch "
          f"{[row[:8].tolist() for row in ids]}...")
    print(f"[{tag}] steady step {steady:.3f} s ({d.batch_size / steady:.2f} examples/s); "
          f"generate {gen_s:.3f} s for {d.batch_size} x {BASELINE_NEW_TOKENS} tokens "
          f"({d.batch_size * BASELINE_NEW_TOKENS / gen_s:.1f} tokens/s); peak device memory "
          f"{peak / 2**30:.2f} GiB; run_fit_baseline {wall:.3f} s (data and init included); "
          f"launches {launches}; card {card}")
    del rep, params, out
    gc.collect()
    torch.cuda.empty_cache()
    phase_baseline_profile(family, card, steady, gen_s)
    return launches


PROFILE_STEPS = 2
PROFILE_NEW_TOKENS = 32


def _kernel_class(name: str) -> str:
    if any(k in name for k in ("mma_fwd_kernel", "mma_dq_kernel", "mma_dkv_kernel")):
        return "K4/K5"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM"
    if "softmax" in low or "reduce" in low or "norm" in low:
        return "softmax/reduce/norm"
    if "multi_tensor" in low or "foreach" in low:
        return "foreach"
    return "other"


def trace_ranges(path: str, names: tuple[str, ...]) -> dict[str, list[dict]]:
    """Each `torch.profiler.record_function` range of ``names`` in a Chrome
    trace → its host wall ms, the device's busy ms within it (the union of
    the kernels' intervals clipped to the range) and the busy ms of each
    kernel class (`_kernel_class`) and of the four kernels that take most."""
    from collections import defaultdict

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    out: dict[str, list[dict]] = {name: [] for name in names}
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("name") not in out:
            continue
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy, end = 0.0, lo
        by_class, by_name = defaultdict(float), defaultdict(float)
        for a, b, name in kernels:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            by_class[_kernel_class(name)] += (b - a) / 1e3
            by_name[name] += (b - a) / 1e3
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        out[e["name"]].append({"wall_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
                               "classes": dict(by_class),
                               "top": [(n[:60], ms) for n, ms in top]})
    return out


def phase_baseline_profile(family: str, card: str, steady_s: float, gen_s: float) -> None:
    """`baseline_config` with `PROFILE_STEPS` steps and `PROFILE_NEW_TOKENS`
    new tokens through ``fit --profile`` (`cli.main`): the launches of
    `_baseline_launches`, and from its trace (`trace_ranges`) the last
    step's and the decoding's wall and device busy time by kernel class.
    The busy time is also given as a share of the unprofiled run's steady
    step (``steady_s``) and of its ``generate`` time per token
    (``gen_s`` / `BASELINE_NEW_TOKENS`)."""
    import gc

    import torch
    import yaml

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    tag = f"baseline_{family}"
    d = baseline_config(family, PROFILE_STEPS, PROFILE_NEW_TOKENS, "_profile")
    cfg = config_from_dict(d)
    trace_dir = os.path.join(cfg.logging.log_dir, "trace")
    if os.path.isdir(trace_dir):
        for name in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, name))
    path = os.path.join(OUT_DIR, f"{tag}_profile.yaml")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    t0 = time.perf_counter()
    code, launches = run_counted(lambda: cli.main(["fit", "--config", path, "--profile"]))
    wall = time.perf_counter() - t0
    check(code == 0, f"{tag} fit --profile: exit {code}")
    _baseline_launches(f"{tag} fit --profile", cfg, launches, PROFILE_STEPS, 1)
    (name,) = os.listdir(trace_dir)
    trace = os.path.join(trace_dir, name)
    ranges = trace_ranges(trace, ("baseline_step", "baseline_generate"))
    check(len(ranges["baseline_step"]) == PROFILE_STEPS
          and len(ranges["baseline_generate"]) == 1,
          f"{tag} fit --profile: ranges {[(k, len(v)) for k, v in ranges.items()]}")
    step, gen = ranges["baseline_step"][-1], ranges["baseline_generate"][0]
    check(step["busy_ms"] > 0 and gen["busy_ms"] > 0, f"{tag}: no kernel in the trace")
    for what, r, unprofiled_ms in (
            ("step", step, steady_s * 1e3),
            (f"generate ({PROFILE_NEW_TOKENS} tokens)", gen,
             gen_s * 1e3 * PROFILE_NEW_TOKENS / BASELINE_NEW_TOKENS)):
        classes = ", ".join(f"{k} {v:.2f}" for k, v in
                            sorted(r["classes"].items(), key=lambda kv: -kv[1]))
        print(f"[{tag}] profiled {what}: wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['busy_ms']:.2f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f}% of the "
              f"profiled wall, {100 * r['busy_ms'] / unprofiled_ms:.1f}% of the unprofiled "
              f"{unprofiled_ms:.2f} ms); by class ms: {classes}; top kernels ms: "
              f"{[(n, round(ms, 2)) for n, ms in r['top']]}")
    print(f"[{tag}] fit --profile ({PROFILE_STEPS} steps, {PROFILE_NEW_TOKENS} tokens): "
          f"{wall:.3f} s, trace {os.path.getsize(trace)} bytes; launches {launches}: PASS; "
          f"card {card}")
    os.remove(trace)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: evaluation over a (data, shard) mesh of 4 ranks on the one card
# ---------------------------------------------------------------------------

MESH_BATCHES = 2  # val batches of the mesh run (the fixture's val split holds 50)
MESH_TIMEOUT = 480  # s: the 4-rank launch is killed after this, and the phase fails
CLI_TIMEOUT = 300  # s: the same for `torchrun ... cli validate`
# the LED encoder states of the mesh against the single-device run: bf16 on
# both, the sharded global rows' softmax in f32 where one device rounds its
# probabilities to bf16, and GEMMs over half the rows; twice and three times
# the largest and the mean error of a correct mesh on the H100 (PERF.md)
MESH_ENC_TOL = 0.025  # x max|ref|, the largest error
MESH_ENC_MEAN_TOL = 2e-3  # the mean absolute error
# the full-length f32 LED check (`_full_length_led`): split-TF32 roundoff and
# the global rows' sums across ranks in another order
MESH_FULL_TOL = 1e-4  # x max|ref|


def mesh_eval_config(name: str, mesh: bool = True, precision: str = "bfloat16") -> dict:
    """`SLICE_CONFIG` over a (2, 2) mesh with the LED sequence-sharded
    (``mesh`` False: the same without a mesh), in ``precision``, its logs
    under ``OUT_DIR/<name>``."""
    d = json.loads(json.dumps(SLICE_CONFIG))
    d["precision"] = precision
    d["model"]["sequence_shard"] = True
    d["logging"] = {"log_dir": os.path.join(OUT_DIR, name), "run_name": name}
    if mesh:
        d["mesh"] = {"data": 2, "shard": 2}
    return d


def mesh_eval_rank(init: str, cfg_dict: dict, out_dir: str, device: str = "cuda") -> dict:
    """One rank of `phase_mesh_eval`: `cli.run_validate` over the mesh for
    `MESH_BATCHES` val batches, with the launches counted, then
    `_full_length_led` → what the parent checks. Its own rows' LED encoder
    states go to ``out_dir``."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # 4 ranks on the host's 8 cores
    init_distributed(device, init_method=init)
    cfg = config_from_dict(cfg_dict)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rep: dict = {}
    t0 = time.perf_counter()
    rouge, launches = run_counted(lambda: cli.run_validate(
        cfg, "val", device=device, max_batches=MESH_BATCHES, report=rep))
    wall = time.perf_counter() - t0
    mesh, store = rep["mesh"], rep["store"]
    full = _full_length_led(rep["params"].led, cfg.model.led, mesh)
    index = store.index
    enc_path = os.path.join(out_dir, f"enc_rank{mesh.rank}.pt")
    torch.save([e.enc_hidden.cpu() for e in rep["enc"]], enc_path)
    part = {}
    if mesh.d == 0:  # the clusters this shard holds; rank 0 also the rest
        names = ("clustered", "clustered_ids", "clustered_bias", "clustered_scale")
        if mesh.s == 0:
            names += ("centroids", "centroid_bias", "spill", "spill_ids", "spill_bias",
                      "spill_scale")
            part["static"] = {"n": index.n, "metric": index.metric,
                              "normalized": index.normalized, "n_spill": index.n_spill}
            part["tokens"] = {"token_ids": store.token_ids.cpu().numpy(),
                              "token_mask": store.token_mask.cpu().numpy()}
        part.update({k: getattr(index, k).cpu() for k in names})
    return {"rank": mesh.rank, "d": mesh.d, "s": mesh.s, "backend": mesh.backend,
            "device": str(mesh.device), "rouge": rouge, "launches": launches,
            "wall": wall, "batch_s": rep["batch_s"], "bytes": rep["collective_bytes"],
            "calls": rep["collective_calls"],
            "peak": torch.cuda.max_memory_allocated() if cuda else 0, "shards": index.shards,
            "n_clusters": index.n_clusters, "ids": [i.cpu() for i in rep["ids"]],
            "retrieval": _retrieval(rep), "full": full, "enc_path": enc_path, "index": part}


def _full_length_led(led_params, led_cfg, mesh) -> tuple[float, float]:
    """The LED encoder sequence-sharded over ``mesh`` against the same
    encoder unsharded on this rank, in f32, on 2 rows whose real tokens
    cross the block boundary at 1024 (2048 and 1500 of 2048 tokens) with
    global tokens in both blocks. The val split's sources end before that
    boundary (at most 550 tokens in `MESH_BATCHES` batches), so only this
    input sends real rows through the halo exchange → (max abs err,
    max|ref|)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.models.led import led_encode

    g = torch.Generator().manual_seed(18)
    t = 2048
    ids = torch.randint(4, led_cfg.vocab_size, (2, t), generator=g)
    mask = torch.ones((2, t), dtype=torch.int32)
    mask[1, 1500:] = 0
    glob = torch.zeros((2, t), dtype=torch.int32)
    glob[:, [0, 300, 1100, 1400]] = 1
    ids, mask, glob = (x.to(mesh.device) for x in (ids, mask, glob))
    with torch.no_grad():
        out = led_encode(led_params, led_cfg, ids, mask, glob, seq_mesh=mesh)
        ref = led_encode(led_params, led_cfg, ids, mask, glob)
    return (out - ref).abs().max().item(), ref.abs().max().item()


def _retrieval(rep: dict) -> list:
    """Each batch of an eval loop's report → (queries, ignore ids, retrieved
    ids, scores) on the CPU."""
    return [(e.query_cls.cpu(), b["mips_ignore"].cpu(), e.retrieved_idx.cpu(),
             e.faiss_scores.cpu()) for b, e in zip(rep["batch"], rep["enc"])]


def _assemble_ivf(results) -> str:
    """The whole IVF index of a mesh run, put back together from its data
    rank 0's shards (`mesh_eval_rank`), saved with its corpus as a
    ``build-index`` directory → the directory."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf import IVFIndex, save_ivf_index

    parts = sorted((r for r in results if r["d"] == 0), key=lambda r: r["s"])
    whole = dict(parts[0]["index"])
    for k in ("clustered", "clustered_ids", "clustered_bias", "clustered_scale"):
        whole[k] = torch.cat([p["index"][k] for p in parts])
    static, tokens = whole.pop("static"), whole.pop("tokens")
    path = os.path.join(OUT_DIR, "mesh_eval_index")
    save_ivf_index(IVFIndex(**whole, **static), path)
    np.savez(os.path.join(path, "corpus_tokens.npz"), **tokens)
    return path


def _ivf_exact_rows(index) -> tuple:
    """A CPU IVF index's rows by doc id, dequantized, and their biases, in
    f64 → ([n, D_pad], [n]): the rows `_near_tie_swaps` scores exactly."""
    import torch

    rows = torch.zeros((index.n, index.dim), dtype=torch.float64)
    bias = torch.zeros(index.n, dtype=torch.float64)
    scale = (None if index.clustered_scale is None else index.clustered_scale.reshape(-1),
             index.spill_scale)
    for x, ids, b, sc in ((index.clustered.reshape(-1, index.dim),
                           index.clustered_ids.reshape(-1), index.clustered_bias.reshape(-1),
                           scale[0]),
                          (index.spill, index.spill_ids, index.spill_bias, scale[1])):
        ok = ids >= 0
        x = x[ok].double()
        rows[ids[ok].long()] = x if sc is None else x * sc[ok].double()[:, None]
        bias[ids[ok].long()] = b[ok].double()
    return rows, bias


def _hold_ivf_to_plain(name, index, exact, k, nprobe, query, ignore, ids, vals):
    """A search's hits over the IVF ``index`` (on the CPU) against the plain
    union-probe search of the same queries, ``ivf_search(serving=False)``
    on the CPU (every kernel's plain version): the values within K1's SQ8
    tolerance (rtol 1e-4, atol 1e-3), the ids equal but where a near-tie
    swaps two rows (`_near_tie_swaps` on ``exact``, `_ivf_exact_rows`: the
    same rows, exact gaps within rtol 1e-5, atol 1e-4; a row missing or
    added fails) → (ranks swapped, the largest exact gap among them)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf import ivf_search

    ref_v, ref_i = ivf_search(index, query, k=k, nprobe=nprobe, ignore=ignore, serving=False)
    check(torch.allclose(vals, ref_v, rtol=1e-4, atol=1e-3),
          f"{name}: retrieval scores {vals.tolist()} differ from the plain IVF search's "
          f"{ref_v.tolist()}")
    swapped, gap, _ = _near_tie_swaps(name, _k1_queries(index, query), *exact, ids, ref_i,
                                      ref_v)
    return swapped, gap


def _k1_queries(index, query):
    """An IVF search's queries as K1 reads them: prepared for the index and
    rounded to its payload's query type, in f32."""
    from retrieval_augmented_mds_tpu_torch.index.ivf import prepare_queries
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import _query_dtype

    return prepare_queries(index, query).to(_query_dtype(index.clustered)).float()


def _k1_union_case(card: str, index, query, nprobe: int, kk: int) -> None:
    """K1 at `[mesh_eval]`'s own shapes, as `ivf_search_sharded` calls it:
    on each shard rank's probed union (`owned_probed_rows`: its clusters
    among the whole batch's probes) and on the replicated spill, a data
    rank's 2 queries, k + I candidates, no ignore ids; against the plain
    version (`_k1_case`'s SQ8 tolerance: the same ids, values rtol 1e-4
    atol 1e-3). ``index`` is the mesh's whole index on the card, ``query``
    a batch's 4 queries."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        owned_probed_rows,
        prepare_queries,
        probe_clusters,
        shard_ivf_index,
    )
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk, mips_topk_plain

    q_all = prepare_queries(index, query)
    probes = probe_clusters(index, q_all, nprobe)
    q = q_all[:2].contiguous()  # data rank 0's
    cases = []
    for s in (0, 1):
        part = shard_ivf_index(index, types.SimpleNamespace(shard=2, s=s))
        corpus, bias, _, scale = owned_probed_rows(part, probes, s)
        cases.append((f"shard {s}'s probed union ({corpus.shape[0] // part.clustered.shape[1]}"
                      f" cluster slots of its {part.clustered.shape[0]})",
                      (q, corpus.contiguous(), kk, bias.contiguous(), None,
                       scale.reshape(-1).contiguous())))
    cases.append((f"the spill ({index.n_spill} rows)",
                  (q, index.spill, min(kk, index.spill.shape[0]), index.spill_bias, None,
                   index.spill_scale)))
    for what, args in cases:
        vals, ids = mips_topk(*args)
        ref_v, ref_i = mips_topk_plain(*args)
        torch.cuda.synchronize()
        err = (vals - ref_v).abs().max().item()
        check(all(set(a) == set(r) for a, r in zip(ids.tolist(), ref_i.tolist())),
              f"K1 {what}: ids {ids.tolist()} vs plain {ref_i.tolist()}")
        check(torch.allclose(vals, ref_v, rtol=1e-4, atol=1e-3),
              f"K1 {what}: values differ (max abs err {err})")
        ms = cuda_ms(lambda: mips_topk(*args))
        plain_ms = cuda_ms(lambda: mips_topk_plain(*args))
        corpus = args[1]
        bound = roofline(nbytes(q, corpus, args[3], args[5], vals, ids),
                         2.0 * q.shape[0] * corpus.shape[0] * corpus.shape[1], False)
        print(f"[mesh_eval] K1 on {what}: B={q.shape[0]} N={corpus.shape[0]} "
              f"D={corpus.shape[1]} k={args[2]} SQ8: PASS (ids equal, values rtol 1e-4 "
              f"atol 1e-3: {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); {card}")


def _k2_sharded_case(card: str) -> None:
    """K2 on a shard rank's extended block of the `[mesh_eval]` LED layer:
    a data rank's 2 rows, T/S = 1024 tokens of T = 2048 with w = 512
    neighbour rows on each side (zeros and a -1e9 bias past the sequence)
    and w dummy query rows on each side, G = 64 (the fixture's padding and
    valid globals): against the plain version (bf16 tolerance of
    `_k2_case`), and its block's rows against K2 over the whole sequence."""
    import torch
    import torch.nn.functional as F

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        local_rows_plain,
    )

    w, tl = 512, 1024
    args, _, _ = _k2_inputs(2, 12, 2048, 64, w, 64, FIXTURE_LENGTHS[:2],
                                    FIXTURE_GLOBALS[:2], torch.bfloat16, seed=11)
    q, k, v, key_bias, kg, vg, g_bias, _ = args
    whole = flash_sliding_attention(q, k, v, key_bias, kg, vg, g_bias, window=w)
    for s in (0, 1):
        off = s * tl
        kp, vp = (F.pad(x, (0, 0, w, w)) for x in (k, v))
        ext = (F.pad(q[:, :, off:off + tl], (0, 0, w, w)), kp[:, :, off:off + tl + 2 * w]
               .contiguous(), vp[:, :, off:off + tl + 2 * w].contiguous(),
               F.pad(key_bias, (w, w), value=-1e9)[:, off:off + tl + 2 * w].contiguous(),
               kg, vg, g_bias)
        out = flash_sliding_attention(*ext, window=w)
        ref = local_rows_plain(*ext, w)
        torch.cuda.synchronize()
        rows = slice(w, w + tl)
        e = (out[:, :, rows].float() - ref[:, :, rows].float()).abs().max().item()
        ref_max = ref[:, :, rows].float().abs().max().item()
        check(e <= 2e-2 * ref_max, f"K2 sharded block s={s}: max abs err {e} > 2e-2 x "
              f"{ref_max}")
        e_whole = (out[:, :, rows].float() - whole[:, :, off:off + tl].float()).abs().max()
        ms = cuda_ms(lambda: flash_sliding_attention(*ext, window=w))
        plain_ms = cuda_ms(lambda: local_rows_plain(*ext, w))
        kb_ext = ext[3]
        flops = 4 * 64 * _sliding_pairs(kb_ext, g_bias, w, 12)
        r_, keys, window = _sliding_reads(kb_ext, g_bias, w, torch.ones_like(kb_ext,
                                                                             dtype=torch.bool))
        n_bytes = 12 * 64 * 2 * (r_ + 2 * keys + window) + nbytes(*ext[3:], out)
        bound, _ = _route_bounds(n_bytes, flops, torch.bfloat16)
        print(f"[mesh_eval] K2 on shard {s}'s extended block (B=2 nh=12 T/S={tl} + 2 x "
              f"{w} rows, dh=64, G=64, bf16): PASS (its {tl} rows within 2e-2 x max|ref| "
              f"of plain: {e:.3e} of {ref_max:.3e}; against K2 over the whole T=2048: "
              f"{e_whole.item():.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}); {card}")


def _k1_shard_case(card: str) -> None:
    """K1 on shard 1's rows of a 4000-row SQ8 flat index over 2 shards
    (2048 rows: 1952 real, 96 padding with a -3e38 bias), a data rank's 2
    queries, k = 2, 8 ignore ids per query shifted by the shard's offset
    (ids of shard 0 fall below 0, and are no-ops): against the plain
    version (`_k1_case`'s SQ8 tolerance), no ignored id returned."""
    import torch

    from retrieval_augmented_mds_tpu_torch.index.flat import build_flat_index
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk, mips_topk_plain

    g = torch.Generator(device="cuda").manual_seed(18)
    n, d, b, k = 4000, 768, 2, 2
    e = torch.randn((n, d), generator=g, device="cuda")
    q = torch.randn((b, d), generator=g, device="cuda")
    idx = build_flat_index(e, dtype="int8", mesh=types.SimpleNamespace(shard=2, s=1))
    rows, off = idx.embeddings.shape[0], 2048
    top = (q @ e.T).topk(4).indices.int()  # the best rows, all shards
    ign = torch.cat([top, torch.randint(0, n, (b, 4), generator=g, device="cuda",
                                        dtype=torch.int32)], 1) - off
    args = (q, idx.embeddings, k, idx.row_bias, ign.contiguous(), idx.row_scale)
    vals, ids = mips_topk(*args)
    ref_v, ref_i = mips_topk_plain(*args)
    torch.cuda.synchronize()
    hits = sum(len(set(a) & set(r)) for a, r in zip(ids.tolist(), ref_i.tolist()))
    check(hits == b * k, f"K1 shard: ids {ids.tolist()} vs plain {ref_i.tolist()}")
    check(torch.allclose(vals, ref_v, rtol=1e-4, atol=1e-3), "K1 shard: values differ")
    check(not bool(((ids[:, :, None] == ign[:, None, :]) & (ign[:, None, :] >= 0)).any()),
          "K1 shard: an ignored id was returned")
    check(bool((ids < n - off).all()), "K1 shard: a padding row was returned")
    ms = cuda_ms(lambda: mips_topk(*args))
    plain_ms = cuda_ms(lambda: mips_topk_plain(*args))
    bound = roofline(nbytes(q, idx.embeddings, idx.row_bias, idx.row_scale, ign, vals, ids),
                     2.0 * b * rows * d, False)
    print(f"[mesh_eval] K1 on shard 1's rows (B={b} N={rows} ({n - off} real) D={d} k={k} "
          f"SQ8, 8 ignore ids shifted by {off}): PASS (ids equal, values rtol 1e-4 atol "
          f"1e-3: {(vals - ref_v).abs().max().item():.3e}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
          f"{card}")


def _mesh_cli(card: str) -> None:
    """``python -m torch.distributed.run --standalone --nproc-per-node 4 -m
    retrieval_augmented_mds_tpu_torch.cli validate`` on ``configs/smoke.yaml``
    with a (2, 2) mesh and the LED sequence-sharded, through to rank 0's
    JSON line. Killed (its whole process group) after `CLI_TIMEOUT`."""
    import signal

    import yaml

    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"]["sequence_shard"] = True
    d["mesh"] = {"data": 2, "shard": 2}
    d["logging"] = {"log_dir": os.path.join(OUT_DIR, "mesh_cli"), "run_name": "mesh_cli"}
    path = os.path.join(OUT_DIR, "mesh_cli.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "retrieval_augmented_mds_tpu_torch.cli",
           "validate", "--config", path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"mesh_eval: torchrun validate killed after {CLI_TIMEOUT} s")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"mesh_eval: torchrun validate exit {proc.returncode}, JSON lines {lines}; "
          f"stderr tail {err[-2000:]}")
    res = json.loads(lines[0])
    check("rouge1" in res, f"mesh_eval: torchrun validate printed {res}")
    backends = sorted(set(re.findall(r"backend (\w+)", err)))
    print(f"[mesh_eval] torchrun --nproc-per-node 4 -m retrieval_augmented_mds_tpu_torch.cli "
          f"validate (configs/smoke.yaml, mesh 2 x 2, sequence_shard): exit 0 in {wall:.1f} s, "
          f"backend {backends}, rank 0's line {lines[0]}; {card}")


def phase_mesh_eval(card: str, precision: str = "bfloat16") -> dict:
    """`[mesh_eval]`: `cli.run_validate` of the serving slice's config over a
    (data 2, shard 2) mesh with the LED sequence-sharded, 4 ranks sharing
    the one card over gloo (`parallel.launch`, a process-group timeout of
    60 s, the launch's `MESH_TIMEOUT`), for `MESH_BATCHES` val batches;
    then the same batches on one device over the same 130-cluster index
    (the mesh's shards put back together), searched by the same route (the
    union probe: `ivf_search(serving=False)`, which the sharded search
    is). Checks each rank's K1 and K2 launches, the retrieved rows of the
    mesh and of the one device against the plain search on the CPU
    (`_hold_ivf_to_plain`) and against each other (both up to near-tie
    swaps, `_near_tie_swaps`), the LED encoder states against the one
    device's (the largest error within `MESH_ENC_TOL` x max|ref|, the mean
    within `MESH_ENC_MEAN_TOL`) and, where real tokens cross the block
    boundary, against the unsharded encoder (`_full_length_led`, within
    `MESH_FULL_TOL` x max|ref|), and prints how many generated sequences
    equal, the walls per batch, each rank's peak memory and its
    collectives a batch. Then the CLI under torchrun and K1/K2 at the
    sharded shapes → the launches of the 4 ranks, summed. ``precision``
    "float32" runs the mesh and the single device in f32 (a diagnostic of
    where their generated ids part: `chip_smoke.py` runs bf16)."""
    import functools
    import gc

    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.index import index_to
    from retrieval_augmented_mds_tpu_torch.index.ivf import load_ivf_index
    from retrieval_augmented_mds_tpu_torch.models import retriever_generator as rg
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    tests = os.path.join(REPO, "tests")  # the local launcher of the mesh tests
    if tests not in sys.path:
        sys.path.append(tests)
    from torch_mesh_launch import launch, store_url

    gc.collect()
    torch.cuda.empty_cache()
    work = os.path.join(OUT_DIR, "mesh_eval_ranks")
    t0 = time.perf_counter()
    results = launch("chip_smoke:mesh_eval_rank", 4, workdir=work, timeout=MESH_TIMEOUT,
                     args=(store_url(work), mesh_eval_config("mesh_eval", True, precision),
                           work))
    mesh_wall = time.perf_counter() - t0
    results.sort(key=lambda r: r["rank"])
    for r in results:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0" and r["shards"] == 2
              and r["n_clusters"] == 130,
              f"mesh_eval rank {r['rank']}: {r['backend']} {r['device']} shards "
              f"{r['shards']} clusters {r['n_clusters']}")
        for name in ("mips_topk", "flash_sliding_attention"):
            check(r["launches"][name] > 0, f"mesh_eval rank {r['rank']}: {name} not "
                  f"launched {r['launches']}")
        check(r["launches"]["ivf_probe_topk"] == 0,
              f"mesh_eval rank {r['rank']}: K8 launched on the sharded route")
    ids0 = results[0]["ids"]
    for r in results[1:]:
        check(all(torch.equal(a, b) for a, b in zip(r["ids"], ids0)) and
              r["rouge"] == results[0]["rouge"], f"mesh_eval: rank {r['rank']} differs")

    index_dir = _assemble_ivf(results)
    single_cfg = config_from_dict(mesh_eval_config("mesh_eval_single", False, precision))
    rep: dict = {}
    search = rg.ivf_search
    rg.ivf_search = functools.partial(search, serving=False)
    try:
        torch.cuda.reset_peak_memory_stats()
        rouge_1, single_l = run_counted(lambda: cli.run_validate(
            single_cfg, "val", index_dir, device="cuda", max_batches=MESH_BATCHES,
            report=rep))
    finally:
        rg.ivf_search = search
    single_peak = torch.cuda.max_memory_allocated()

    # retrieval: data rank d's rows are [2d, 2d + 2); the mesh and the one
    # device each against the plain search on the CPU
    index = load_ivf_index(index_dir)
    exact = _ivf_exact_rows(index)
    k, nprobe = single_cfg.model.mips_topk, single_cfg.index.nprobe
    by_d = {r["d"]: r for r in results if r["s"] == 0}
    single = _retrieval(rep)
    swaps, gap = dict.fromkeys(("mesh", "single", "both"), 0), dict.fromkeys(
        ("mesh", "single", "both"), 0.0)
    for i in range(MESH_BATCHES):
        mesh_i = [torch.cat([by_d[d]["retrieval"][i][j] for d in (0, 1)]) for j in range(4)]
        found = {who: _hold_ivf_to_plain(f"mesh_eval batch {i} ({who})", index, exact, k,
                                         nprobe, *hits)
                 for who, hits in (("mesh", mesh_i), ("single", single[i]))}
        # and the mesh's ids against one device's, by the same near-tie rule
        found["both"] = _near_tie_swaps(
            f"mesh_eval batch {i} (mesh against one device)", _k1_queries(index, mesh_i[0]),
            *exact, mesh_i[2], single[i][2], single[i][3])[:2]
        for who, (n, g) in found.items():
            swaps[who], gap[who] = swaps[who] + n, max(gap[who], g)

    # encoder states
    enc_err, enc_max, enc_sum, enc_n = 0.0, 0.0, 0.0, 0
    encs = {d: torch.load(by_d[d]["enc_path"]) for d in by_d}
    for i, e1 in enumerate(rep["enc"]):
        enc_m = torch.cat([encs[d][i] for d in (0, 1)]).float()
        ref = e1.enc_hidden.cpu().float()
        diff = (enc_m - ref).abs()
        enc_err = max(enc_err, diff.max().item())
        enc_sum, enc_n = enc_sum + diff.sum().item(), enc_n + diff.numel()
        enc_max = max(enc_max, ref.abs().max().item())
    enc_mean = enc_sum / enc_n
    check(enc_err <= MESH_ENC_TOL * enc_max and enc_mean <= MESH_ENC_MEAN_TOL,
          f"mesh_eval: LED encoder states differ by {enc_err} (tol {MESH_ENC_TOL} x max|ref| "
          f"{enc_max}), mean {enc_mean} (tol {MESH_ENC_MEAN_TOL})")
    full = [r["full"] for r in results]
    check(all(e <= MESH_FULL_TOL * m for e, m in full),
          f"mesh_eval: the full-length f32 LED encoder, sharded against unsharded, by rank "
          f"(max abs err, max|ref|): {full} (tol {MESH_FULL_TOL} x max|ref|)")
    same = sum(int(torch.equal(a, b)) for x, y in zip(ids0, rep["ids"])
               for a, b in zip(x.cpu(), y.cpu()))
    total = sum(len(x) for x in ids0)
    launches = {name: sum(r["launches"][name] for r in results) for name in results[0]["launches"]}
    print(f"[mesh_eval] led_base validate over a (data 2, shard 2) mesh, 4 ranks on one "
          f"{card} over gloo, LED sequence-sharded (1024 of 2048 tokens a rank), IVF 130 "
          f"clusters (65 a shard), B=4 (2 a data rank), {MESH_BATCHES} val batches: launch "
          f"{mesh_wall:.1f} s; each rank's run_validate {[round(r['wall'], 1) for r in results]} s")
    print(f"[mesh_eval] launches by rank: "
          + "; ".join(f"{r['rank']} (d={r['d']}, s={r['s']}) K1 {r['launches']['mips_topk']} "
                      f"K2 {r['launches']['flash_sliding_attention']}" for r in results)
          + f"; the single-device run: K1 {single_l['mips_topk']} K2 "
            f"{single_l['flash_sliding_attention']}")
    print(f"[mesh_eval] retrieved rows against the plain IVF search on the CPU (the same "
          f"index, the union probe; ids equal but at near-tie swaps, values rtol 1e-4 atol "
          f"1e-3): mesh {swaps['mesh']} swapped ranks (largest exact gap "
          f"{gap['mesh']:.3e}), one device {swaps['single']} ({gap['single']:.3e}); the "
          f"mesh against one device {swaps['both']} ({gap['both']:.3e}): PASS")
    print(f"[mesh_eval] against one device: LED encoder states ({precision}) max abs err "
          f"{enc_err:.4e} of max|ref| {enc_max:.3f} (tol {MESH_ENC_TOL} x), mean "
          f"{enc_mean:.3e} (tol {MESH_ENC_MEAN_TOL}): PASS; generated sequences equal {same} "
          f"of {total}; ROUGE mesh {results[0]['rouge']} single {rouge_1}")
    print(f"[mesh_eval] the LED encoder on 2 full-length rows (2048 and 1500 real tokens, "
          f"globals in both blocks), f32, sharded against unsharded: max abs err by rank "
          f"{[f'{e:.3e}' for e, _ in full]} of max|ref| {[round(m, 3) for _, m in full]} "
          f"(tol {MESH_FULL_TOL} x): PASS")
    walls = [max(r["batch_s"][i] for r in results) for i in range(MESH_BATCHES)]
    print(f"[mesh_eval] wall per batch (s; the slowest rank): mesh {[round(x, 3) for x in walls]}"
          f", single {[round(x, 3) for x in rep['batch_s']]}; peak memory GiB by rank "
          f"{[round(r['peak'] / 2**30, 2) for r in results]}, single "
          f"{single_peak / 2**30:.2f}; collectives per batch by rank (calls, bytes "
          f"received) {[list(zip(r['calls'], r['bytes'])) for r in results]}; {card}")
    _mesh_cli(card)
    _k2_sharded_case(card)
    q0 = torch.cat([by_d[d]["retrieval"][0][0] for d in (0, 1)]).cuda()
    kk = k + by_d[0]["retrieval"][0][1].shape[1]
    _k1_union_case(card, index_to(index, "cuda"), q0, nprobe, kk)
    _k1_shard_case(card)
    return launches


# ---------------------------------------------------------------------------
# phase 18: training over a (data, shard) mesh of 4 ranks on the one card
# ---------------------------------------------------------------------------

MESH_FIT_STEPS = 3  # the store refreshed before the third
# 4 ranks' allocators on one card: segments that grow in place, so that a
# rank's freed blocks are not stranded in its cache when another needs them
SHARED_CARD_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
MESH_FIT_TIMEOUT = 720  # s: the 4-rank launch of both forms is killed after this
MESH_FIT_FORMS = {  # form: its train knobs over `train_slice_dict`'s
    "standing": {},  # AdamW, bf16 mu: ZeRO-sharded over data
    "capacity": {"adam_8bit": True, "remat": True},  # K9 on each data rank's rows
}
# a mesh step's loss against one device's from the same state: bf16 on both,
# the batch split over data and the LED over shard; three times the largest
# gap of a correct mesh on the H100 (6.3e-5; PERF.md, mesh fit)
MESH_FIT_LOSS_RTOL = 2e-4
# each leaf's gradient norm against one device's, beside a floor of the
# step's global norm (a leaf's own roundoff where its gradient is ~0), at the
# steps where both retrieved the same rows: about 8 x the largest gap of a
# correct mesh there (1.3e-3; PERF.md, mesh fit); a dropped or doubled
# reduction moves whole groups of leaves by 0.5 or 1
MESH_FIT_NORM_RTOL = 1e-2
MESH_FIT_NORM_FLOOR = 1e-4


def mesh_fit_config(form: str, mesh: bool = True) -> dict:
    """`train_slice_dict` in ``form`` (`MESH_FIT_FORMS`) for `MESH_FIT_STEPS`
    steps with the LED sequence-sharded, over a (data 2, shard 2) mesh
    (``mesh`` False: the same on one device)."""
    d = train_slice_dict()
    d["model"]["sequence_shard"] = True
    d["train"].update(MESH_FIT_FORMS[form])
    name = f"mesh_fit_{form}" + ("" if mesh else "_single")
    d.update(max_steps=MESH_FIT_STEPS,
             logging={"log_dir": os.path.join(OUT_DIR, name), "run_name": name})
    if mesh:
        d["mesh"] = {"data": 2, "shard": 2}
    else:  # the cluster count the mesh's 2 shards round the fixture's 131 to
        d["index"]["factory"] = "IVF130,SQ8"
    return d


class _GradNorms:
    """An optimizer that records every leaf's gradient norm at each update
    (the gradients it is handed: over a mesh, the reduced ones), then runs
    the optimizer it wraps, which answers everything else."""

    def __init__(self, tx):
        self.tx, self.norms = tx, []

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, params, grads, state):
        import torch

        norms = torch.stack(torch._foreach_norm([g.float() for g in grads.values()]))
        self.norms.append(dict(zip(grads, norms.tolist())))
        return self.tx.update(params, grads, state)


def _fit_recorded(cfg_dict: dict, device: str = "cuda"):
    """``cli.run_fit`` of the config on ``device``, its launches counted and
    its optimizer recording the gradient norms → (out, launches, report,
    norms by step)."""
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    build, made = cli.build_tx, []

    def recording(*a, **k):
        made.append(_GradNorms(build(*a, **k)))
        return made[-1]

    rep: dict = {}
    cli.build_tx = recording
    try:
        out, launches = run_counted(lambda: cli.run_fit(config_from_dict(cfg_dict),
                                                        device=device, report=rep))
    finally:
        cli.build_tx = build
    return out, launches, rep, made[0].norms


def _state_bytes(opt_state) -> int:
    return sum(v.numel() * v.element_size() for v in vars(opt_state).values()
               if hasattr(v, "element_size"))


def _peak(device: str) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _reset(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _mesh_fit_single(form: str, forms: dict, device: str = "cuda") -> dict:
    """`mesh_fit_config` of ``form`` on one device → its losses, gradient
    norms, retrieved rows, step times, peak memory and state bytes; its
    final parameters saved for the ranks to read."""
    import torch

    _reset(device)
    out, launches, rep, norms = _fit_recorded(forms[form], device)
    state = rep["state"]
    path = os.path.join(OUT_DIR, f"mesh_fit_{form}_single.pt")
    torch.save({n: p.detach().cpu() for n, p in state.params.named_parameters()}, path)
    summary = {"losses": rep["losses"], "norms": norms, "launches": launches,
               "retrieved": [r.cpu() for r in rep["retrieved"]], "step_s": rep["step_s"],
               "phase_s": rep["phase_s"], "peak": _peak(device),
               "state_bytes": _state_bytes(state.opt_state), "path": path,
               "grad_norm": out["grad_norm"]}
    del rep, state
    _reset(device)
    return summary


def _adam_bound(cfg_dict: dict, steps: int) -> float:
    """The most two AdamW trajectories from one start can part on an
    element, whatever their gradients (`tests/test_torch_train.py`
    `_adam_bound`, b1 taken whole: a step moves an element by at most lr_t
    x sqrt(sum a_j^2 / c_j) of its bias-corrected moment weights, plus the
    decay); 8-bit moments within twice that."""
    from retrieval_augmented_mds_tpu_torch.train.optimizer import linear_warmup_schedule

    t = cfg_dict["train"]
    sched = linear_warmup_schedule(t["lr"], t["warmup_steps"], t["total_steps"])
    gap = 0.0
    for count in range(1, steps + 1):
        lr = float(sched(count - 1))
        bc1, bc2 = 1 - 0.9 ** count, 1 - 0.999 ** count
        r2 = sum(((1 - 0.9) * 0.9 ** (count - j) / bc1) ** 2
                 / ((1 - 0.999) * 0.999 ** (count - j) / bc2) for j in range(1, count + 1))
        gap = gap * (1 + lr * t.get("weight_decay", 0.0)) + 2 * lr * math.sqrt(r2)
    return gap * (2 if t.get("adam_8bit") else 1)


def _same_update_as_one_device(cfg_dict: dict, state, tx, mesh) -> tuple | None:
    """One more update of the mesh's ZeRO-sharded optimizer ``tx`` from the
    run's final state, on gradients drawn from one seed (equal on every
    rank); on rank 0 the same update by the one-device optimizer of the
    config from the mesh's gathered state and a copy of the parameters.
    Both must agree bit for bit, parameters and gathered state (the 8-bit
    codes and scales, or the bf16 mu and f32 nu) → on rank 0 (parameters,
    state arrays) compared, else None."""
    import copy

    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import _ARRAYS as ADAM8BIT_ARRAYS
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import AdamW8bit
    from retrieval_augmented_mds_tpu_torch.train.adam8bit import _layout as adam8bit_layout
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    params, opt = state.params, state.opt_state
    dev = next(params.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(19)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for n, p in params.named_parameters()}
    flat = tx.state_arrays(params, opt)  # gathered over data
    rows = None  # the one device's superleaf rows (a mesh may pad one more)
    if mesh.rank == 0:
        one = cli.build_tx(config_from_dict(cfg_dict), params, None)
        if isinstance(one, AdamW8bit):
            _, train = one._layout(params)
            sizes = [dict(params.named_parameters())[n].numel() for n in train]
            rows = adam8bit_layout(sizes)[3]
            flat = {k: v[:rows] if k.rsplit(".", 1)[-1] in ADAM8BIT_ARRAYS else v
                    for k, v in flat.items()}
        twin = copy.deepcopy(params)
        twin_state = one.load_state_arrays(twin, flat)
    del flat
    tx.update(params, grads, opt)
    after = tx.state_arrays(params, opt)
    if mesh.rank != 0:
        return None
    one.update(twin, grads, twin_state)
    ref = one.state_arrays(twin, twin_state)
    check(set(after) == set(ref), f"mesh_fit: state keys {set(after) ^ set(ref)}")
    for k, r in ref.items():
        a = after[k]
        if rows is not None and k.rsplit(".", 1)[-1] in ADAM8BIT_ARRAYS:
            a = a[:rows]
        same = (torch.equal(a.cpu(), r.cpu()) if hasattr(r, "cpu") else a == r)
        check(same, f"mesh_fit: the ZeRO state's {k} after one update differs from one "
              f"device's on the same gradients")
    for (n, p), (_, q) in zip(params.named_parameters(), twin.named_parameters()):
        check(torch.equal(p, q), f"mesh_fit: parameter {n} after one update differs from "
              f"one device's on the same gradients")
    return (len(grads), len(ref))


def mesh_fit_rank(init: str, forms: dict, refs: dict, device: str = "cuda") -> dict:
    """One rank of `phase_mesh_fit`: ``cli.run_fit`` of each form's config
    over the (2, 2) mesh with the launches counted and the gradient norms
    recorded, then its parameters against one device's (``refs``: the
    saved single-device run of the form), and on rank 0 its gathered
    optimizer state → what the parent checks."""
    import torch

    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # 4 ranks on the host's 8 cores
    init_distributed(device, init_method=init)
    results = {}
    for form, cfg_dict in forms.items():
        _reset(device)
        t0 = time.perf_counter()
        out, launches, rep, norms = _fit_recorded(cfg_dict, device)
        wall = time.perf_counter() - t0
        peak = _peak(device)
        mesh, state, tx = rep["mesh"], rep["state"], rep["tx"]
        ref = torch.load(refs[form], mmap=True, weights_only=True)
        bound = _adam_bound(cfg_dict, MESH_FIT_STEPS)
        worst = max(((p.detach().cpu() - ref[n]).abs().max().item(), n)
                    for n, p in state.params.named_parameters())
        res = {"rank": mesh.rank, "d": mesh.d, "s": mesh.s, "backend": mesh.backend,
               "device": str(mesh.device), "shards": rep["store"].index.shards,
               "losses": rep["losses"], "norms": norms, "launches": launches, "wall": wall,
               "step_s": rep["step_s"], "phase_s": rep["phase_s"],
               "collectives": rep["collectives"], "peak": peak,
               "zero_bytes": _state_bytes(state.opt_state),
               "retrieved": [r.cpu() for r in rep["retrieved"]],
               "param_err": worst, "param_bound": bound, "grad_norm": out["grad_norm"],
               "same_update": _same_update_as_one_device(cfg_dict, state, tx.tx, mesh)}
        results[form] = res
        del rep, state, tx, ref
    return results


def _norms_apart(mesh_norms, single_norms, steps) -> tuple[float, int, str]:
    """The largest |mesh - one device| / one device's over the leaf gradient
    norms of ``steps`` above `MESH_FIT_NORM_FLOOR` x the step's global
    norm, the leaves held, and the worst leaf; fails beyond
    `MESH_FIT_NORM_RTOL` (with the floor) on those steps."""
    worst, held, where = 0.0, 0, ""
    for i in steps:
        a, b = mesh_norms[i], single_norms[i]
        total = math.sqrt(sum(v * v for v in b.values()))
        for n, ref in b.items():
            gap = abs(a[n] - ref)
            if ref >= MESH_FIT_NORM_FLOOR * total:
                held += 1
                rel = gap / ref
                if rel > worst:
                    worst, where = rel, f"step {i} {n}"
            check(gap <= MESH_FIT_NORM_RTOL * ref + MESH_FIT_NORM_FLOOR * total,
                  f"mesh_fit: step {i} {n} gradient norm {a[n]} against one device's {ref}")
    return worst, held, where


def _k3_block_case(card: str) -> None:
    """K3 on a shard rank's extended block of the `[mesh_fit]` LED layer,
    as the sequence-sharded backward runs it: a data rank's 2 rows, T/S =
    1024 tokens of T = 2048 with w = 512 neighbour rows on each side and w
    dummy query rows on each side whose cotangent is zero, G = 64 (the
    fixture's padding and valid globals; the model's zero cotangent on
    padded and global rows): against the plain backward from the same m,
    l and delta (bf16 tolerance of `_k3_case`)."""
    import torch
    import torch.nn.functional as F

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        row_delta,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
        sliding_backward_plain,
    )

    w, tl, nh, dh = 512, 1024, 12, 64
    args, rows_ok, is_global = _k2_inputs(2, nh, 2048, dh, w, 64, FIXTURE_LENGTHS[:2],
                                          FIXTURE_GLOBALS[:2], torch.bfloat16, seed=11)
    q, k, v, key_bias, kg, vg, g_bias, _ = args
    for s in (0, 1):
        off = s * tl
        kp, vp = (F.pad(x, (0, 0, w, w)) for x in (k, v))
        ext = (F.pad(q[:, :, off:off + tl], (0, 0, w, w)).contiguous(),
               kp[:, :, off:off + tl + 2 * w].contiguous(),
               vp[:, :, off:off + tl + 2 * w].contiguous(),
               F.pad(key_bias, (w, w), value=-1e9)[:, off:off + tl + 2 * w].contiguous(),
               kg, vg, g_bias)
        out, m, l = flash_sliding_attention(*ext, window=w, return_stats=True)
        live = F.pad((rows_ok & ~is_global).int(), (w, w))[:, off:off + tl + 2 * w].bool()
        live[:, :w] = False  # the dummy rows
        live[:, w + tl:] = False
        g = torch.Generator(device="cuda").manual_seed(12 + s)
        do = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        do = do.masked_fill(~live[:, None, :, None], 0.0)
        bwd = (*ext, do, m, l, row_delta(do, out))
        got = flash_sliding_backward(*bwd, window=w)
        ref = sliding_backward_plain(*bwd, w)
        torch.cuda.synchronize()
        tol = _grad_tol(torch.bfloat16)
        err = _compare(f"K3 shard {s}'s extended block", got, ref, tol)
        ms = cuda_ms(lambda: flash_sliding_backward(*bwd, window=w))
        plain_ms = cuda_ms(lambda: sliding_backward_plain(*bwd, w))
        kb = ext[3]
        flops = 10 * dh * _sliding_pairs(kb, g_bias, w, nh, live)
        rows, keys, window = _sliding_reads(kb, g_bias, w, live)
        n_bytes = (nh * dh * 2 * (rows + 2 * (keys + window)) + rows * nh * 3 * m.element_size()
                   + nbytes(*ext[3:7], do, *got))
        bound, _ = _route_bounds(n_bytes, flops, torch.bfloat16)
        print(f"[mesh_fit] K3 on shard {s}'s extended block (B=2 nh=12 T/S={tl} + 2 x {w} "
              f"halo and dummy rows, dh=64, G=64, bf16, dO zero on the dummy, padded and "
              f"global rows): PASS (dq, dk, dv, dkg, dvg within {tol} x max|ref|: max abs err "
              f"{err:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); {card}")


def _torchrun(args: list[str], what: str, timeout: float) -> tuple[str, str, float]:
    """``python -m torch.distributed.run --standalone --nproc-per-node 4``
    of ``args`` from the repo root, its whole process group killed after
    ``timeout`` → (stdout, stderr, wall s); fails on a non-zero exit."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True,
                            env=dict(os.environ, **SHARED_CARD_ENV))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{what}: torchrun killed after {timeout} s")
    check(proc.returncode == 0, f"{what}: torchrun exit {proc.returncode}; stderr tail "
          f"{err[-2000:]}")
    return out, err, time.perf_counter() - t0


def _mesh_fit_cli(card: str) -> None:
    """``torchrun ... cli fit`` on ``configs/smoke.yaml`` over the (2, 2)
    mesh with the LED sequence-sharded, 2 steps and a checkpoint; then one
    device resumes from it for 2 more steps, against one device that was
    never interrupted (the store refreshed before step 2 there, built from
    the resumed weights here: the same weights); then the dry run
    (`retrieval_augmented_mds_tpu_torch.dryrun`) on 4 ranks."""
    import shutil

    import yaml

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        base = yaml.safe_load(f)
    base["model"]["sequence_shard"] = True
    base["index"]["rebuild_every"] = 2

    def config(name, **over):
        d = json.loads(json.dumps(base))
        d.update(eval_every=0, ckpt_dir=os.path.join(OUT_DIR, name, "ckpt"),
                 logging={"log_dir": os.path.join(OUT_DIR, name), "run_name": name})
        d.update(over)
        return d

    shutil.rmtree(os.path.join(OUT_DIR, "mesh_fit_cli"), ignore_errors=True)
    d = config("mesh_fit_cli", max_steps=2, mesh={"data": 2, "shard": 2})
    os.makedirs(os.path.join(OUT_DIR, "mesh_fit_cli"), exist_ok=True)
    path = os.path.join(OUT_DIR, "mesh_fit_cli", "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    out, err, wall = _torchrun(["-m", "retrieval_augmented_mds_tpu_torch.cli", "fit",
                                "--config", path], "mesh_fit cli fit", CLI_TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(lines) == 1 and json.loads(lines[0])["steps"] == 2,
          f"mesh_fit: torchrun fit printed {lines}")
    ckpt = os.path.join(OUT_DIR, "mesh_fit_resume", "ckpt")
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    shutil.copytree(d["ckpt_dir"], ckpt)
    resumed, whole = {}, {}
    cli.run_fit(config_from_dict(config("mesh_fit_resume", max_steps=4)), device="cuda",
                report=resumed)
    cli.run_fit(config_from_dict(config("mesh_fit_whole", max_steps=4, ckpt_dir=None)),
                device="cuda", report=whole)
    check(len(resumed["losses"]) == 2, f"mesh_fit: the resume ran {resumed['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], whole["losses"][2:]))
    check(rel <= 1e-4, f"mesh_fit: resumed losses {resumed['losses']} against the "
          f"uninterrupted run's {whole['losses'][2:]}")
    print(f"[mesh_fit] torchrun --nproc-per-node 4 -m retrieval_augmented_mds_tpu_torch.cli fit "
          f"(configs/smoke.yaml, mesh 2 x 2, sequence_shard, 2 steps, a checkpoint): exit 0 in "
          f"{wall:.1f} s, rank 0's line {lines[0][:160]}; one device resumed from its "
          f"checkpoint for steps 2-3: losses {[round(x, 6) for x in resumed['losses']]} "
          f"against the uninterrupted run's {[round(x, 6) for x in whole['losses'][2:]]} "
          f"(rtol 1e-4: {rel:.2e}): PASS; {card}")
    out, err, wall = _torchrun(["-m", "retrieval_augmented_mds_tpu_torch.dryrun"],
                               "mesh_fit dryrun", CLI_TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    check(len(lines) == 1, f"mesh_fit: the dry run printed {out[-500:]}")
    print(f"[mesh_fit] torchrun --nproc-per-node 4 -m retrieval_augmented_mds_tpu_torch.dryrun "
          f"in {wall:.1f} s: {lines[0]}; {card}")


def mesh_fit_runs(single_cfgs: dict, mesh_cfgs: dict, device: str = "cuda",
                  rank_fn: str = "chip_smoke:mesh_fit_rank"):
    """One device's run of each form (`_mesh_fit_single`), then the 4-rank
    launch of ``rank_fn`` over the mesh configs → (the ranks' results by
    rank, the single runs by form, the launch's wall s)."""
    tests = os.path.join(REPO, "tests")  # the local launcher of the mesh tests
    if tests not in sys.path:
        sys.path.append(tests)
    from torch_mesh_launch import launch, store_url

    singles = {form: _mesh_fit_single(form, single_cfgs, device) for form in single_cfgs}
    _reset(device)
    work = os.path.join(OUT_DIR, "mesh_fit_ranks")
    t0 = time.perf_counter()
    results = launch(rank_fn, 4, workdir=work, timeout=MESH_FIT_TIMEOUT, env=SHARED_CARD_ENV,
                     args=(store_url(work), mesh_cfgs,
                           {f: singles[f]["path"] for f in mesh_cfgs}, device))
    results.sort(key=lambda r: next(iter(r.values()))["rank"])
    return results, singles, time.perf_counter() - t0


def phase_mesh_fit(card: str) -> dict:
    """`[mesh_fit]`: the train slice's config (`mesh_fit_config`) over a
    (data 2, shard 2) mesh, the LED sequence-sharded, 4 ranks sharing the
    one card over gloo, `MESH_FIT_STEPS` steps with a store refresh, in
    both `MESH_FIT_FORMS`, against one device's run of each form from the
    same seed and batches: every step's loss (`MESH_FIT_LOSS_RTOL`, or
    `RETRIEVAL_FLIP_RTOL` where the refresh swapped a retrieved row), every
    leaf's gradient norm at every step (`_norms_apart`: a dropped or
    doubled reduction moves whole groups of leaves by 2x), the parameters
    after the last step (within `_adam_bound`), the gathered optimizer
    state (the 8-bit codes' agreement; AdamW's moment norms), each rank's
    ZeRO state bytes, K1-K5 (and K9) launched on every rank, the walls,
    peaks and collectives. Then K3 on a rank's extended LED block and K9
    on a data rank's row shard against their plain versions, and
    `_mesh_fit_cli` → the launches of the 4 ranks, summed."""
    import gc

    import torch

    results, singles, launch_s = mesh_fit_runs(
        {f: mesh_fit_config(f, mesh=False) for f in MESH_FIT_FORMS},
        {f: mesh_fit_config(f) for f in MESH_FIT_FORMS})
    launches = check_mesh_fit(results, singles, card)
    print(f"[mesh_fit] the 4-rank launch of both forms: {launch_s:.1f} s")
    _k3_block_case(card)
    gc.collect()
    torch.cuda.empty_cache()
    _k9_case("led_base_row_shard", capacity_superleaf(), 0.0, 0.25, timed=True, shard=(1, 2))
    torch.cuda.empty_cache()
    _k9_case("tails_row_shard", [16384 + 70, 300, 5, 1000, 129], 0.02, 0.5, timed=False,
             shard=(1, 2))
    _mesh_fit_cli(card)
    return launches


def check_mesh_fit(results: list, singles: dict, card: str,
                   device: str = "cuda:0") -> dict:
    """`phase_mesh_fit`'s checks and lines for each form's ranks against its
    single-device run → the launches of the ranks, summed."""
    import torch

    launches = {}
    for form, single in singles.items():
        rs = [r[form] for r in results]
        path = ["mips_topk", "flash_sliding_attention", "flash_sliding_backward",
                "flash_dense_attention", "flash_dense_backward"]
        if MESH_FIT_FORMS[form].get("adam_8bit"):
            path.append("adam8bit_superleaf_update")
        for r in rs:
            check(r["backend"] == "gloo" and r["device"] == device and r["shards"] == 2,
                  f"mesh_fit {form} rank {r['rank']}: {r['backend']} {r['device']} "
                  f"shards {r['shards']}")
            check(device == "cpu" or all(r["launches"][k] > 0 for k in path)
                  and r["launches"]["ivf_probe_topk"] == 0,
                  f"mesh_fit {form} rank {r['rank']}: launches {r['launches']}")
            check(r["losses"] == rs[0]["losses"] and r["norms"] == rs[0]["norms"],
                  f"mesh_fit {form}: rank {r['rank']}'s losses or gradients differ from rank 0's")
            check(r["param_err"][0] <= r["param_bound"],
                  f"mesh_fit {form} rank {r['rank']}: parameter {r['param_err'][1]} "
                  f"{r['param_err'][0]} from one device's (bound {r['param_bound']})")
        if MESH_FIT_FORMS[form].get("adam_8bit") and device != "cpu":
            check(all(r["launches"]["adam8bit_superleaf_update"] == MESH_FIT_STEPS for r in rs),
                  f"mesh_fit capacity: K9 launches {[r['launches'] for r in rs]}")
        # losses: data rank d's retrieved rows are one device's rows [2d, 2d + 2)
        rels = []
        for i, (a, b) in enumerate(zip(rs[0]["losses"], single["losses"])):
            same = all(torch.equal(r["retrieved"][i], single["retrieved"][i][2 * r["d"]:
                                                                          2 * r["d"] + 2])
                       for r in rs)
            rel = abs(a - b) / abs(b)
            tol = MESH_FIT_LOSS_RTOL if same else RETRIEVAL_FLIP_RTOL
            check(rel <= tol, f"mesh_fit {form}: step {i} loss {a} against one device's {b} "
                  f"(rtol {tol}, same rows retrieved: {same})")
            rels.append((rel, same))
        # the gradients where every rank retrieved one device's rows; after a
        # swap the memory encoders see other rows (printed, not held)
        same_steps = [i for i, (_, same) in enumerate(rels) if same]
        worst, held, where = _norms_apart(rs[0]["norms"], single["norms"], same_steps)
        flipped = [i for i in range(len(rels)) if i not in same_steps]
        flip_worst = max((abs(rs[0]["norms"][i][n] - v) / v for i in flipped
                          for n, v in single["norms"][i].items()
                          if v >= MESH_FIT_NORM_FLOOR * math.sqrt(
                              sum(x * x for x in single["norms"][i].values()))), default=0.0)
        zero = max(r["zero_bytes"] for r in rs)
        check(zero <= 0.6 * single["state_bytes"],
              f"mesh_fit {form}: a rank's ZeRO state {zero} bytes against one device's "
              f"{single['state_bytes']}")
        n_leaves, n_arrays = rs[0]["same_update"]
        state_txt = (f"one more update on seeded gradients equal to one device's from the "
                     f"gathered state, bit for bit: {n_leaves} parameters, {n_arrays} state "
                     f"arrays")
        steps = [max(r["step_s"][i] for r in rs) for i in range(MESH_FIT_STEPS)]
        print(f"[mesh_fit] {form} ({'8-bit AdamW + remat' if form == 'capacity' else 'AdamW, '
              'bf16 mu'}, ZeRO over data): led_base fit over (data 2, shard 2), 4 ranks on one "
              f"{card} over gloo, LED 1024 of 2048 tokens a rank, B=4 (2 a data rank), "
              f"{MESH_FIT_STEPS} steps, store refreshed before step 2")
        print(f"[mesh_fit] {form} losses mesh {[round(x, 6) for x in rs[0]['losses']]} one "
              f"device {[round(x, 6) for x in single['losses']]} (rel {[f'{r:.2e}' for r, _ in rels]}"
              f", same rows {[s for _, s in rels]}): PASS; gradient norms of {held} leaf-steps "
              f"of steps {same_steps} within {MESH_FIT_NORM_RTOL} (worst {worst:.3e} at "
              f"{where}; at steps {flipped}, after a swapped row, {flip_worst:.3e}); grad_norm "
              f"{rs[0]['grad_norm']:.6f} vs {single['grad_norm']:.6f}; parameters within the "
              f"Adam bound {rs[0]['param_bound']:.3e} (largest {max(r['param_err'][0] for r in rs):.3e})"
              f"; state: {state_txt}")
        print(f"[mesh_fit] {form} step wall (s, slowest rank) {[round(x, 3) for x in steps]}, one "
              f"device {[round(x, 3) for x in single['step_s']]}; phases rank 0 "
              + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in ph.items())
                          for ph in rs[0]["phase_s"])
              + f"; peak GiB by rank {[round(r['peak'] / 2**30, 2) for r in rs]}, one device "
              f"{single['peak'] / 2**30:.2f}; ZeRO state bytes by rank "
              f"{[r['zero_bytes'] for r in rs]}, one device {single['state_bytes']}; "
              f"collectives a step (calls, bytes received) rank 0 {rs[0]['collectives']}; "
              f"run_fit wall by rank {[round(r['wall'], 1) for r in rs]} s; {card}")
        print(f"[mesh_fit] {form} launches by rank: " + "; ".join(
            f"{r['rank']} K1 {r['launches']['mips_topk']} K2 "
            f"{r['launches']['flash_sliding_attention']} K3 "
            f"{r['launches']['flash_sliding_backward']} K4 {r['launches']['flash_dense_attention']}"
            f" K5 {r['launches']['flash_dense_backward']} K9 "
            f"{r['launches']['adam8bit_superleaf_update']}" for r in rs)
            + f"; one device {single['launches']}")
        for r in rs:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the led_base config names hub weights: they must fail at once (and
    # warn), never reach for a network
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    try:
        import retrieval_augmented_mds_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = phase_env()
        measured = {"mips_topk": phase_k1(), "flash_sliding_attention": phase_k2(),
                    "flash_sliding_backward": phase_k3()}
        measured["flash_dense_attention"], measured["flash_dense_backward"] = phase_k45()
        measured["flash_dense_blocked"], measured["flash_dense_blocked_backward"] = phase_k67()
        measured["flash_decode_attention"] = phase_decode_attn()
        measured["mips_chunkmax"], k10_launches = phase_k10()
        measured["ivf_probe_topk"] = phase_k8()
        measured["adam8bit_superleaf_update"] = phase_k9()
        phase_small_reference()
        small = phase_small_fit()
        phase_small_modes(small)
        phase_small_fit_8bit()
        phase_small_ivf()
        sliced: dict = {}
        served = phase_slice(sliced)
        exported = phase_export(sliced, card)
        del sliced
        phase_custom_op_overhead()
        phase_host_tail()
        sampled = phase_predict_sample()
        standing = phase_train_slice()
        train_f32, _ = phase_train_f32_slice()
        target_in = phase_train_target_in_slice()
        capacity = phase_capacity_slice(standing)
        long = phase_long_slice(standing)
        retriever = phase_retriever_slice()
        phase_baseline_small()
        bart = phase_baseline("bart", card)
        t5 = phase_baseline("t5", card)
        mesh = phase_mesh_eval(card)
        mesh_fit = phase_mesh_fit(card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # (kernel wrapper, source, TPU kernel body it replaces)
    sources = [
        ("mips_topk", "mips_topk.cu", "ops/mips_topk.py:52"),
        ("flash_sliding_attention", "flash_sliding_fwd.cu", "ops/flash_sliding.py:54"),
        ("flash_sliding_backward", "flash_sliding_bwd.cu", "ops/flash_sliding_bwd.py:44"),
        ("flash_dense_attention", "flash_dense_fwd.cu", "ops/flash_dense.py:75"),
        ("flash_dense_backward", "flash_dense_bwd.cu", "ops/flash_dense.py:88"),
        ("ivf_probe_topk", "ivf_probe_topk.cu", "index/ivf_serving.py:36"),
        ("adam8bit_superleaf_update", "adam8bit_update.cu", "ops/adam8bit_update.py:68"),
        ("flash_dense_blocked", "flash_dense_fwd.cu", "ops/flash_dense.py:259"),
        ("flash_dense_blocked_backward", "flash_dense_bwd.cu",
         "ops/flash_dense.py:300 (and :371, :410)"),
        ("mips_chunkmax", "mips_chunkmax.cu", "ops/mips_topk.py:254"),
        ("flash_decode_attention", "flash_decode.cu",
         "models/core.py attention (XLA einsums: no TPU kernel)"),
    ]
    # launches on the paths (the eight slices, the exported serving step, the two
    # baselines and the mesh runs' four ranks, evaluating and training); K10's paths
    # launch it 0 times (checked), so
    # its count is that of its own phase
    launches = {name: served[name] + exported[name] + sampled[name] + standing[0][name]
                + train_f32[name] + target_in[name] + capacity[name] + long[name]
                + retriever[name] + bart[name] + t5[name] + mesh[name] + mesh_fit[name]
                for name, _, _ in sources}
    launches["mips_chunkmax"] += k10_launches
    kernels = [{"name": name, "route": "cuda",
                "source": f"retrieval_augmented_mds_tpu_torch/csrc/{src}",
                "replaces": f"retrieval_augmented_mds_tpu/{tpu}",
                "launches": launches[name], **measured[name]}
               for name, src, tpu in sources]
    # why a row has no library call, or what its yardstick leaves out
    notes = {
        "mips_topk": "library_ms null: no single PyTorch call gives the distinct-value "
                     "top-k of masked scores (torch.topk needs the [B, N] scores first)",
        "ivf_probe_topk": "library_ms null: no PyTorch call searches the probed clusters",
        "adam8bit_superleaf_update": "library_ms null: no PyTorch call computes blockwise "
                                     "8-bit AdamW (torch._fused_adamw_ keeps f32/bf16 moments)",
        "mips_chunkmax": "no path calls mips_topk_blocked (as in the JAX package): launches "
                         "are its phase's one mips_topk_blocked call, 0 on every slice; "
                         "library_ms: torch.mm of the same f32 scores, without the masks "
                         "and the chunk maxima",
    }
    for row in kernels:
        if row["name"] in notes:
            row["note"] = notes[row["name"]]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
