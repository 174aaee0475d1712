#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. environment: the card's name and power limit, torch/CUDA/nvcc
     versions; builds every CUDA kernel of
     ``retrieval_augmented_mds_tpu_torch/csrc`` (one nvcc each, in parallel).
  2. kernel K1 (MIPS top-k) against its plain PyTorch version;
  3. kernel K2 (sliding-window local rows, forward) against its plain version;
  4. kernel K3 (its backward) against the plain backward, at the LED and
     Longformer shapes of the train step;
  5. kernels K4/K5 (dense attention rows, forward and backward) against
     their plain versions, at the decoder's self and cross shapes and at
     S = 8192;
  6. ``predict`` on ``configs/smoke.yaml`` on the card and on the CPU (the
     plain versions), from one seed: equal retrieved and generated ids;
     then ``fit`` on the same config for 3 steps, card against CPU: the
     same losses;
  7. the serving slice: ``cli.run_predict`` of the port on the led_base
     preset (seeded random weights) over the committed 2000-example
     fixture, with the kernels' launch counts read around that run;
  8. the training slice: ``cli.run_fit`` on
     ``configs/led_base_multi_x_science.yaml`` (a Flat bf16 index, no
     pretrained weights, the hash tokenizer, the same fixture) for 4 steps
     with one store refresh, with the launch counts read around it.

The line before the last is the per-kernel JSON summary (launches summed
over the two slices); the last line is ``{"ok": true, "device": {...}}``.
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

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(
    REPO, "retrieval_augmented_mds_tpu", "data", "fixtures",
    "multi_x_science_2000.json.gz",
)
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # logs of the fit runs
WARMUP, REPS = 2, 10


class SmokeFailure(AssertionError):
    pass


def _counters() -> dict:
    """Each kernel's wrapper by name; ``wrapper.launches`` is its count."""
    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        flash_dense_attention,
        flash_dense_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk

    return {f.__name__: f for f in (mips_topk, flash_sliding_attention,
                                    flash_sliding_backward, flash_dense_attention,
                                    flash_dense_backward)}


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


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device time of fn() in ms over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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

def _k1_case(name, b, n, d, k, dtype, *, bias=False, ignore=False, timed=False):
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
    ign = None
    if ignore:
        _, top = mips_topk_plain(q, e, 1, rb, None, scale)
        ign = torch.randint(-1, n, (b, 8), generator=g, device="cuda",
                            dtype=torch.int32)
        ign[:, 0] = top[:, 0]  # the true best hit must disappear
    vals, ids = mips_topk(q, e, k, rb, ign, scale)
    ref_v, ref_i = mips_topk_plain(q, e, k, rb, ign, scale)
    torch.cuda.synchronize()
    err = (vals - ref_v).abs().max().item()
    if dtype == torch.float32:
        # f32: the same ids; values to f32 summation-order noise
        check(torch.equal(ids, ref_i), f"K1 {name}: ids differ from plain")
        check(torch.allclose(vals, ref_v, rtol=1e-5, atol=1e-4),
              f"K1 {name}: values differ (max abs err {err})")
        tol = "ids equal, values rtol 1e-5 atol 1e-4"
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
    print(f"[K1] {name}: B={b} N={n} D={d} k={k} {dtype}: PASS ({tol}); "
          f"max_abs_err {err:.3e}"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else ""))
    return err, ms, plain_ms


def phase_k1():
    import torch

    serving = _k1_case("serving", 256, 131072, 768, 10, torch.bfloat16, timed=True)
    _k1_case("f32_bias_ignore", 64, 100003, 768, 10, torch.float32, bias=True,
             ignore=True, timed=True)
    _k1_case("sq8", 64, 65613, 768, 10, "int8", timed=True)
    _k1_case("f32_k128", 16, 20000, 256, 128, torch.float32, bias=True, ignore=True)
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
    return (q, k, v, key_bias, take(k), take(v), g_bias, w), ~padded


def _k2_case(name, shape, dtype, *, timed=True):
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        local_rows_plain,
    )

    args, rows_ok = _k2_inputs(*shape, dtype=dtype, seed=7)
    *tensors, w = args
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    ref, ref_m, ref_l = local_rows_plain(*tensors, w, return_stats=True)
    torch.cuda.synchronize()
    b, nh, t, dh = out.shape
    sel = rows_ok[:, None, :].expand(b, nh, t)
    err = (out.float() - ref.float()).abs()[sel].max().item()
    m_err = (m - ref_m).abs().max().item()
    l_rel = ((l - ref_l).abs() / ref_l).max().item()
    if dtype == torch.float32:
        tol_out, tol_m, tol_l = 1e-4, 1e-4, 1e-4
    else:
        tol_out, tol_m, tol_l = 2e-2, 1e-3, 1e-3
    check(err <= tol_out, f"K2 {name}: out max abs err {err} > {tol_out}")
    check(torch.allclose(m, ref_m, rtol=1e-6, atol=tol_m), f"K2 {name}: m err {m_err}")
    check(l_rel <= tol_l, f"K2 {name}: l max rel err {l_rel} > {tol_l}")
    check(bool(torch.isfinite(out).all()), f"K2 {name}: non-finite output")
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_attention(*tensors, window=w))
        plain_ms = cuda_ms(lambda: local_rows_plain(*tensors, w))
    print(f"[K2] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]}: PASS (out on non-padded "
          f"rows atol {tol_out}: {err:.3e}; m atol {tol_m}+rtol 1e-6: {m_err:.3e}; "
          f"l rtol {tol_l}: {l_rel:.3e})"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else ""))
    return err, ms, plain_ms


def phase_k2():
    import torch

    # LED-base encoder layer: padded keys, invalid globals, and a batch
    # whose globals are all invalid (its tail rows are fully masked)
    led = (4, 12, 2048, 64, 512, 64, [2048, 1800, 1000, 512], [64, 10, 3, 0])
    # Longformer-base query/memory encoder layer: CLS as the one global
    lf = (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100],
          [1] * 8)
    served = _k2_case("led_base", led, torch.bfloat16)
    _k2_case("led_base", led, torch.float32)
    _k2_case("longformer_base", lf, torch.bfloat16)
    _k2_case("longformer_base", lf, torch.float32)
    return served


# ---------------------------------------------------------------------------
# phases 4 and 5: the backward of K2 (K3); dense attention rows (K4, K5)
# ---------------------------------------------------------------------------

def _grad_tol(dtype) -> float:
    """Relative to the largest magnitude of each reference: f32 summation
    order, or one bf16 rounding of a result both versions take in f32."""
    import torch

    return 1e-4 if dtype == torch.float32 else 2e-2


def _compare(what: str, got, ref, tol: float) -> float:
    """max |got - ref| over the tensors, each within tol x max(1, |ref|)."""
    err = 0.0
    for g, r in zip(got, ref):
        e = (g.float() - r.float()).abs().max().item()
        bound = tol * max(1.0, r.float().abs().max().item())
        check(e <= bound and math.isfinite(e), f"{what}: max abs err {e} > {bound}")
        err = max(err, e)
    return err


def _k3_case(name, shape, dtype, *, timed=True):
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        row_delta,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
        sliding_backward_plain,
    )

    args, _ = _k2_inputs(*shape, dtype=dtype, seed=11)
    *tensors, w = args
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    bwd = (*tensors, do, m, l, row_delta(do, out))
    got = flash_sliding_backward(*bwd, window=w)
    ref = sliding_backward_plain(*bwd, w)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    err = _compare(f"K3 {name} {dtype}", got, ref, tol)
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_backward(*bwd, window=w))
        plain_ms = cuda_ms(lambda: sliding_backward_plain(*bwd, w))
    print(f"[K3] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]}: PASS (dq, dk, dv, dkg, dvg "
          f"on every row, fully masked ones included, within {tol} x max|ref|: "
          f"max abs err {err:.3e})"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else ""))
    return err, ms, plain_ms


def phase_k3():
    import torch

    # the train step's shapes: LED encoder layer; Longformer query encoder
    # (B=4) and memory re-encode (B*k = 8 rows), CLS the one global
    led = (4, 12, 2048, 64, 512, 64, [2048, 1800, 1000, 512], [64, 10, 3, 0])
    query = (4, 12, 512, 64, 256, 1, [512, 500, 300, 130], [1] * 4)
    memory = (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100], [1] * 8)
    served = _k3_case("led_base", led, torch.bfloat16)
    _k3_case("led_base", led, torch.float32)
    _k3_case("longformer_query", query, torch.bfloat16)
    _k3_case("longformer_memory", memory, torch.bfloat16)
    return served


def _dense_case(name, b, t, s, causal, lengths, dtype, *, timed=True):
    """K4 against `dense_rows_plain` (out, m, l) and K5 against
    `dense_backward_plain` (dq, dk, dv from the same m, l, delta); a source
    of length 0 is all padding (its rows are uniform over the S keys)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
        dense_backward_plain,
        dense_rows_plain,
        flash_dense_attention,
        flash_dense_backward,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import row_delta

    nh, dh = 12, 64
    g = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((b, nh, t, dh), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    pos = torch.arange(s, device="cuda")
    kb = torch.where(pos[None, :] < torch.tensor(lengths, device="cuda")[:, None],
                     0.0, -1e9).float()
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    ref, ref_m, ref_l = dense_rows_plain(q, k, v, kb, causal, return_stats=True)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    bwd = (q, k, v, kb, do, m, l, row_delta(do, out))
    got = flash_dense_backward(*bwd, causal=causal)
    ref_g = dense_backward_plain(*bwd, causal)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    what = f"{name} {dtype}"
    err4 = _compare(f"K4 {what}", [out], [ref], tol)
    check(torch.allclose(m, ref_m, rtol=1e-6, atol=1e-3), f"K4 {what}: m differs")
    check(bool(((l - ref_l).abs() / ref_l).max() <= 1e-3), f"K4 {what}: l differs")
    err5 = _compare(f"K5 {what}", got, ref_g, tol)
    times = [None] * 4
    if timed:
        times = [cuda_ms(lambda: flash_dense_attention(q, k, v, kb, causal=causal)),
                 cuda_ms(lambda: dense_rows_plain(q, k, v, kb, causal)),
                 cuda_ms(lambda: flash_dense_backward(*bwd, causal=causal)),
                 cuda_ms(lambda: dense_backward_plain(*bwd, causal))]
    shape = f"B={b} nh={nh} T={t} S={s} dh={dh} causal={causal} lengths={lengths}"
    print(f"[K4] {what}: {shape}: PASS (out within {tol} x max|ref|: {err4:.3e}; "
          f"m atol 1e-3, l rtol 1e-3)"
          + (f"; kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms" if timed else ""))
    print(f"[K5] {what}: {shape}: PASS (dq, dk, dv within {tol} x max|ref|: "
          f"{err5:.3e})"
          + (f"; kernel {times[2]:.3f} ms, plain {times[3]:.3f} ms" if timed else ""))
    return (err4, times[0], times[1]), (err5, times[2], times[3])


def phase_k45():
    import torch

    # decoder self-attention (causal) and cross-attention over the padded
    # 2048-token source of the train step, B=4; then S = 8192 (the long-S
    # computation of the TPU's blocked kernels)
    _dense_case("decoder_self", 4, 512, 512, True, [512] * 4, torch.bfloat16)
    cross = _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0],
                        torch.bfloat16)
    _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0],
                torch.float32, timed=False)
    _dense_case("long_source", 4, 256, 8192, False, [8192, 6000, 3000, 100],
                torch.bfloat16)
    return cross


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

SLICE_CONFIG = {
    "model": {"preset": "led_base", "mips_topk": 2, "memory_len": 512},
    "data": {
        "source": FIXTURE, "tokenizer": None, "max_length": 2048,
        "query_max_length": 512, "decoder_max_length": 256,
        "memory_len": 512, "batch_size": 4,
    },
    "index": {"factory": "Flat", "dtype": "bfloat16"},
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


def phase_small_fit() -> None:
    """``fit`` on ``configs/smoke.yaml`` (tiny preset, f32) for 3 steps with
    a store refresh before the third, on the card through the kernels
    (decoder T=32, cross S=128) and on the CPU through the plain versions,
    from one seed: the losses agree to rtol 1e-3 (f32 summation order on
    two devices, passed through an Adam update, which divides each small
    gradient by its own size)."""
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(
        cfg, max_steps=3, eval_every=0, ckpt_dir=None,
        index=dataclasses.replace(cfg.index, rebuild_every=2),
        logging=dataclasses.replace(cfg.logging, log_dir=os.path.join(OUT_DIR, "small_fit")))
    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(cfg, device="cuda", report=gpu))
    cli.run_fit(cfg, device="cpu", report=cpu)
    check(all(n > 0 for n in launches.values()), f"small fit: a kernel not launched {launches}")
    check(len(gpu["refresh_s"]) == 1, "small fit: no store refresh")
    lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
    check(len(lg) == 3 and bool(torch.isfinite(lg).all()), f"small fit losses {lg}")
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    check(rel <= 1e-3, f"small fit: card losses {lg.tolist()} vs CPU {lc.tolist()}")
    print(f"[small] configs/smoke.yaml fit, 3 steps + 1 refresh, card vs CPU: losses "
          f"{[f'{x:.6f}' for x in lg.tolist()]} vs {[f'{x:.6f}' for x in lc.tolist()]}, "
          f"max rel err {rel:.3e} (rtol 1e-3): PASS; card launches {launches}")


def phase_slice() -> dict:
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import rag_decode
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk_plain
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(SLICE_CONFIG)
    report: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = run_counted(lambda: cli.run_predict(cfg, device="cuda", report=report))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    store, enc, ids, batch = report["store"], report["enc"], report["ids"], report["batch"]
    b = cfg.data.batch_size
    n = store.index.n
    check(launches["mips_topk"] > 0 and launches["flash_sliding_attention"] > 0,
          f"kernel not launched: {launches}")
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
    # the kernel's retrieval agrees with the plain search on these queries
    _, ref = mips_topk_plain(enc.query_cls, store.index.embeddings, cfg.model.mips_topk,
                             store.index.row_bias, ign, store.index.row_scale)
    check(torch.equal(ref, idx), "retrieval differs from the plain search")
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
# phase 8: the training slice
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4


def train_slice_config():
    """``configs/led_base_multi_x_science.yaml`` cut to a few steps: a Flat
    bf16 index (IVF needs a kernel not ported yet) refreshed every 2
    steps, no pretrained weights (seeded random init), the hash tokenizer
    over the committed 2000-example fixture, no eval and no checkpoints.
    Widths, lengths, batch, top-k, memory encoder and precision are the
    file's."""
    import yaml

    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    with open(os.path.join(REPO, "configs", "led_base_multi_x_science.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"] = {k: v for k, v in d["model"].items() if not k.endswith("_weights")}
    d["data"].update(source=FIXTURE, tokenizer=None)
    d["index"].update(factory="Flat", rebuild_every=2)
    d.update(max_steps=TRAIN_STEPS, eval_every=0, ckpt_dir=None,
             logging={"log_dir": os.path.join(OUT_DIR, "train_slice"),
                      "run_name": "led_base_train"})
    return config_from_dict(d)


def phase_train_slice() -> dict:
    import torch

    from retrieval_augmented_mds_tpu_torch import cli

    cfg = train_slice_config()
    report: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = run_counted(lambda: cli.run_fit(cfg, device="cuda", report=report))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    losses = report["losses"]
    check(out["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"train slice ran {out['steps']} steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(math.isfinite(out["grad_norm"]) and out["grad_norm"] > 0,
          f"grad_norm {out['grad_norm']}")
    check(len(report["refresh_s"]) == 1, f"{len(report['refresh_s'])} store refreshes")
    check(all(n > 0 for n in launches.values()), f"kernel not launched: {launches}")
    params = report["state"].params
    check(all(bool(torch.isfinite(p).all()) for p in params.parameters()),
          "non-finite parameters after the steps")
    d = cfg.data
    print(f"[train] led_base fit, B={d.batch_size}, max_length {d.max_length}, decoder "
          f"{d.decoder_max_length}, query {d.query_max_length}, memory {d.memory_len} "
          f"x top-{cfg.model.mips_topk}, {cfg.precision} compute, f32 master weights, "
          f"memory_model_fixed={cfg.model.memory_model_fixed}, corpus rows "
          f"{report['store'].index.n}, {sum(p.numel() for p in params.parameters())} "
          f"parameters")
    print(f"[train] losses {[f'{x:.5f}' for x in losses]}; last metrics "
          f"{json.dumps({k: round(v, 6) for k, v in out.items()})}")
    print(f"[train] step wall s {[f'{x:.3f}' for x in report['step_s']]} (each phase "
          f"synchronised)")
    for i, ph in enumerate(report["phase_s"]):
        print(f"[train]   step {i}: forward {ph['forward']:.3f} s, backward "
              f"{ph['backward']:.3f} s, optimizer {ph['optimizer']:.3f} s")
    print(f"[train] store build {report['store_s']:.3f} s, refresh "
          f"{report['refresh_s'][0]:.3f} s, run_fit total {wall:.3f} s (data and "
          f"init included); peak device memory {peak / 2**30:.2f} GiB")
    print(f"[train] launches during the run: {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
        phase_small_reference()
        phase_small_fit()
        served = phase_slice()
        trained = phase_train_slice()
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
    ]
    kernels = []
    for name, src, tpu in sources:
        err, ms, plain_ms = measured[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"retrieval_augmented_mds_tpu_torch/csrc/{src}",
            "replaces": f"retrieval_augmented_mds_tpu/{tpu}",
            "launches": served[name] + trained[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
