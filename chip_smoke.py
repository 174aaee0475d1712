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
  6. kernel K8 (the per-query IVF probe top-k) against its plain version on
     the same probe ids, on IVF indexes (C = 1024, SQ8 and bf16) built by
     the port over 1,048,576 rows of the ``bench-index`` Gaussian mixture
     (D = 768), at B = 4 and 16, nprobe = 32, k = 10; with the K1 flat scan
     of the same payload, the build time and recall@10;
  7. ``predict`` on ``configs/smoke.yaml`` on the card and on the CPU (the
     plain versions), from one seed: equal retrieved and generated ids;
     then ``fit`` on the same config for 3 steps, card against CPU: the
     same losses;
  8. the same config on an ``IVF16,SQ8`` index (the per-query route):
     ``predict`` and a 3-step ``fit``, card against CPU, then a
     ``build-index`` → ``predict --index`` round trip on the card;
  9. the serving slice: ``cli.run_predict`` of the port on the led_base
     preset (seeded random weights) over the committed 2000-example
     fixture, on the config's ``IVF256,SQ8`` index (nprobe 8), with the
     kernels' launch counts read around that run;
  7b. kernel K9 (the 8-bit AdamW superleaf update) against its plain
     version at the capacity slice's superleaf (613,192,286 parameters)
     and on a small superleaf with tails, padding, weight decay and a clip;
  8b. ``fit`` on ``configs/smoke.yaml`` with ``train.adam_8bit``, card
     against CPU, and its checkpoint loaded back on the card;
 10. the training slice: ``cli.run_fit`` on
     ``configs/led_base_multi_x_science.yaml`` (its ``IVF256,SQ8`` index,
     no pretrained weights, the hash tokenizer, the same fixture) for 4
     steps with one store refresh, with the launch counts read around it;
 11. the capacity training slice: the same with ``train.adam_8bit`` and
     ``train.remat`` on, its peak memory and step time beside 10's.

The line before the last is the per-kernel JSON summary (launches summed
over the three slices; ms, plain_ms and library_ms measured here with CUDA
events; bound_ms the least time for the same work on an H100 SXM from
these inputs); the last line is ``{"ok": true, "device": {...}}``.
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
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # fit logs, saved indexes
WARMUP, REPS = 2, 10
# H100 SXM (NVIDIA data sheet, dense): HBM bytes/s; peak operations/s of
# the f32 CUDA cores and the bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32, PEAK_BF16 = 67e12, 989e12


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
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import ivf_probe_topk
    from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import (
        adam8bit_superleaf_update,
    )
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk

    return {f.__name__: f for f in (mips_topk, flash_sliding_attention,
                                    flash_sliding_backward, flash_dense_attention,
                                    flash_dense_backward, ivf_probe_topk,
                                    adam8bit_superleaf_update)}


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
    """Mean device time of fn() in ms over ``reps`` launches (CUDA events).
    The launches queue behind ~10 ms of device sleep, so the host's launch
    overhead shows only where fn() itself waits for the device."""
    import torch

    for _ in range(WARMUP):
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


def roofline(n_bytes: float, n_ops: float, f32: bool) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of the inputs' type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (PEAK_F32 if f32 else PEAK_BF16) * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


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
    bound = roofline(nbytes(q, e, rb, scale, ign, vals, ids), 2.0 * b * n * d,
                     dtype == torch.float32)
    print(f"[K1] {name}: B={b} N={n} D={d} k={k} {dtype}: PASS ({tol}); "
          f"max_abs_err {err:.3e}"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']})" if timed else ""))
    return result(err, ms, plain_ms, bound)


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


def _sliding_pairs(key_bias, g_bias, w, nh) -> float:
    """Visible (query, key) pairs of the sliding rows: for every row, the
    unmasked keys within w of it plus the valid globals, times the heads."""
    import torch

    b, t = key_bias.shape
    ok = torch.nn.functional.pad((key_bias == 0).long().cumsum(1), (1, 0))
    i = torch.arange(t, device=key_bias.device)
    hi, lo = torch.clamp(i + w + 1, max=t), torch.clamp(i - w, min=0)
    window = (ok[:, hi] - ok[:, lo]).sum()
    return float(nh * (window + t * (g_bias == 0).sum()))


def _k2_case(name, shape, dtype, *, timed=True, library=False):
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        local_rows_plain,
    )

    args, rows_ok, is_global = _k2_inputs(*shape, dtype=dtype, seed=7)
    *tensors, w = args
    flops = 4 * shape[3] * _sliding_pairs(tensors[3], tensors[6], w, shape[1])
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
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_attention(*tensors, window=w))
        plain_ms = cuda_ms(lambda: local_rows_plain(*tensors, w))
    if library:
        q, k, v = tensors[:3]
        mask = _band_global_mask(tensors[3], is_global, w, dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    bound = roofline(nbytes(*tensors, out), flops, dtype == torch.float32)
    print(f"[K2] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]}: PASS (out on non-padded "
          f"rows atol {tol_out}: {err:.3e}; m atol {tol_m}+rtol 1e-6: {m_err:.3e}; "
          f"l rtol {tol_l}: {l_rel:.3e})"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, {flops / 1e9:.2f} GFLOP)"
             if timed else "")
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


def _k3_case(name, shape, dtype, *, timed=True, library=False):
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        row_delta,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
        flash_sliding_backward,
        sliding_backward_plain,
    )

    args, _, is_global = _k2_inputs(*shape, dtype=dtype, seed=11)
    *tensors, w = args
    flops = 10 * shape[3] * _sliding_pairs(tensors[3], tensors[6], w, shape[1])
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    bwd = (*tensors, do, m, l, row_delta(do, out))
    got = flash_sliding_backward(*bwd, window=w)
    ref = sliding_backward_plain(*bwd, w)
    torch.cuda.synchronize()
    tol = _grad_tol(dtype)
    err = _compare(f"K3 {name} {dtype}", got, ref, tol)
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: flash_sliding_backward(*bwd, window=w))
        plain_ms = cuda_ms(lambda: sliding_backward_plain(*bwd, w))
    if library:
        # the backward of one SDPA call under the equivalent mask
        q2, k2, v2 = (x.detach().requires_grad_() for x in tensors[:3])
        mask = _band_global_mask(tensors[3], is_global, w, dtype)
        lib_out = torch.nn.functional.scaled_dot_product_attention(q2, k2, v2,
                                                                   attn_mask=mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (q2, k2, v2), do,
                                                     retain_graph=True))
    bound = roofline(nbytes(*bwd, *got), flops, dtype == torch.float32)
    print(f"[K3] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]}: PASS (dq, dk, dv, dkg, dvg "
          f"on every row, fully masked ones included, within {tol} x max|ref|: "
          f"max abs err {err:.3e})"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, {flops / 1e9:.2f} GFLOP)"
             if timed else "")
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
    # visible (query, key) pairs: keys inside the source, and not after the
    # query when causal; 4 (forward) and 10 (backward) x dh operations each
    j = torch.arange(s, device="cuda")
    vis = j[None, None, :] < torch.tensor(lengths, device="cuda")[:, None, None]
    if causal:
        vis = vis & (j[None, None, :] <= torch.arange(t, device="cuda")[None, :, None])
    pairs = float(nh * vis.expand(b, t, s).sum())
    f32 = dtype == torch.float32
    bound4 = roofline(nbytes(q, k, v, kb, out, m, l), 4 * dh * pairs, f32)
    bound5 = roofline(nbytes(*bwd, *got), 10 * dh * pairs, f32)
    times = [None] * 6
    if timed:
        # the library's yardstick: one scaled_dot_product_attention call with
        # the same additive key mask, and its backward
        mask = kb[:, None, None, :].expand(b, 1, t, s)
        if causal:
            later = j[None, :] > torch.arange(t, device="cuda")[:, None]
            mask = mask + torch.where(later, -1e9, 0.0)
        mask = mask.to(dtype)
        q2, k2, v2 = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(q2, k2, v2, attn_mask=mask)
        times = [cuda_ms(lambda: flash_dense_attention(q, k, v, kb, causal=causal)),
                 cuda_ms(lambda: dense_rows_plain(q, k, v, kb, causal)),
                 cuda_ms(lambda: flash_dense_backward(*bwd, causal=causal)),
                 cuda_ms(lambda: dense_backward_plain(*bwd, causal)),
                 cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask)),
                 cuda_ms(lambda: torch.autograd.grad(lib_out, (q2, k2, v2), do,
                                                     retain_graph=True))]
    shape = f"B={b} nh={nh} T={t} S={s} dh={dh} causal={causal} lengths={lengths}"
    print(f"[K4] {what}: {shape}: PASS (out within {tol} x max|ref|: {err4:.3e}; "
          f"m atol 1e-3, l rtol 1e-3)"
          + (f"; kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms, sdpa {times[4]:.3f} ms, "
             f"bound {bound4['bound_ms']:.3f} ms ({bound4['bound_by']})" if timed else ""))
    print(f"[K5] {what}: {shape}: PASS (dq, dk, dv within {tol} x max|ref|: "
          f"{err5:.3e})"
          + (f"; kernel {times[2]:.3f} ms, plain {times[3]:.3f} ms, sdpa backward "
             f"{times[5]:.3f} ms, bound {bound5['bound_ms']:.3f} ms ({bound5['bound_by']})"
             if timed else ""))
    return (result(err4, times[0], times[1], bound4, times[4]),
            result(err5, times[2], times[3], bound5, times[5]))


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


def phase_k8() -> dict:
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch.cli import gaussian_mixture, recall
    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        build_ivf_index,
        prepare_queries,
        probe_clusters,
    )
    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_topk,
        ivf_probe_topk_plain,
        ivf_search_serving,
    )
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
    for payload in ("int8", "bfloat16"):
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
            flat, flat_scale = x.to(torch.bfloat16), None
        print(f"[K8] IVF{K8_C},{'SQ8' if payload == 'int8' else 'Flat'} ({payload}) built in "
              f"{build_s:.3f} s (k-means on 65536 rows, 15 iterations; every row "
              f"assigned): L = {L}, spill rows {idx.n_spill}")
        for b in (4, 16):
            q = prepare_queries(idx, queries[:b])
            probes = probe_clusters(idx, q, K8_NPROBE).to(torch.int32).contiguous()
            args = (q, idx.clustered, idx.clustered_bias, idx.clustered_scale, probes)
            err, tol, n_swapped = _k8_check(f"{payload} B={b}", args, K8_K)
            ms = cuda_ms(lambda: ivf_probe_topk(*args, K8_K))
            plain_ms = cuda_ms(lambda: ivf_probe_topk_plain(*args, K8_K))
            flat_ms = cuda_ms(lambda: mips_topk(q, flat, K8_K, None, None, flat_scale))
            # the whole per-query route: probes, K8, ids, the spill by K1, merge
            route_ms = cuda_ms(lambda: ivf_search_serving(idx, queries[:b], k=K8_K,
                                                          nprobe=K8_NPROBE))
            # each probed cluster read once: its rows, their bias and scale
            n_probed = int(torch.unique(probes).numel())
            row_bytes = d * idx.clustered.element_size() + 4 * (
                1 if idx.clustered_scale is None else 2)
            bound = roofline(n_probed * L * row_bytes + nbytes(q, probes) + b * K8_K * 8,
                             2.0 * b * K8_NPROBE * L * d, False)
            _, ids = ivf_search_serving(idx, queries[:b], k=K8_K, nprobe=K8_NPROBE)
            rec = recall(ids, exact[:b])
            _, flat_ids = mips_topk(queries[:b], flat, K8_K, None, None, flat_scale)
            print(f"[K8] {payload} B={b} nprobe={K8_NPROBE} k={K8_K}: PASS (positions equal "
                  f"but {n_swapped} swapped near-ties within tol {tol:.3e}; values max abs "
                  f"err {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, K1 flat "
                  f"scan of the same {K8_N}-row payload {flat_ms:.3f} ms; bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {n_probed} distinct "
                  f"clusters of {b * K8_NPROBE} probes), {bound['bound_ms'] / ms:.1%} of it; "
                  f"the whole per-query route {route_ms:.3f} ms; recall@10 vs exact f32: "
                  f"IVF per-query {rec:.4f}, flat {recall(flat_ids, exact[:b]):.4f}")
            if measured is None:  # the reported case: SQ8, B = 4
                measured = result(err, ms, plain_ms, bound)
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


def _k9_case(name, sizes, wd, clip, *, timed):
    """K9 against its plain version from a warm state (one plain update from
    zero moments): update within rtol 1e-6 + atol 1e-9, codes within 1, mu
    scales rtol 1e-6, the nu range rtol = atol = 1e-5 (the JAX package's
    kernel test)."""
    import torch

    from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import (
        adam8bit_superleaf_update,
        adam8bit_superleaf_update_plain,
    )
    from retrieval_augmented_mds_tpu_torch.train import adam8bit as t8

    gen = torch.Generator(device="cuda").manual_seed(31)
    sizes, nbs, _, nb = t8._layout(sizes)
    state = t8.init_state(sizes, "cuda")
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
    got = adam8bit_superleaf_update(*args, **adam)
    ref = adam8bit_superleaf_update_plain(*args, **adam)
    torch.cuda.synchronize()
    err = (got[0] - ref[0]).abs().max().item()
    check(torch.allclose(got[0], ref[0], rtol=1e-6, atol=1e-9),
          f"K9 {name}: update differs (max abs err {err})")
    flips = []
    for k, what in ((1, "mu_q"), (3, "nu_q")):
        d = (got[k].int() - ref[k].int()).abs()
        check(got[k].dtype == ref[k].dtype and d.max().item() <= 1,
              f"K9 {name}: {what} differs by more than 1")
        flips.append(int((d > 0).sum()))
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
    print(f"[K9] {name}: {len(sizes)} leaves, {sum(sizes)} parameters, NB={nb}, wd={wd}, "
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
    check(all(n > 0 for name, n in launches.items()
              if name not in ("ivf_probe_topk", "adam8bit_superleaf_update")),
          f"small fit: a kernel not launched {launches}")
    check(len(gpu["refresh_s"]) == 1, "small fit: no store refresh")
    lg, lc = torch.tensor(gpu["losses"]), torch.tensor(cpu["losses"])
    check(len(lg) == 3 and bool(torch.isfinite(lg).all()), f"small fit losses {lg}")
    rel = ((lg - lc).abs() / lc.abs()).max().item()
    check(rel <= 1e-3, f"small fit: card losses {lg.tolist()} vs CPU {lc.tolist()}")
    print(f"[small] configs/smoke.yaml fit, 3 steps + 1 refresh, card vs CPU: losses "
          f"{[f'{x:.6f}' for x in lg.tolist()]} vs {[f'{x:.6f}' for x in lc.tolist()]}, "
          f"max rel err {rel:.3e} (rtol 1e-3): PASS; card launches {launches}")


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
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(
        cfg, max_steps=3, eval_every=0, ckpt_dir=None,
        train=dataclasses.replace(cfg.train, adam_8bit=True),
        index=dataclasses.replace(cfg.index, rebuild_every=2),
        logging=dataclasses.replace(cfg.logging, log_dir=os.path.join(OUT_DIR, "small_8bit")))
    ckpt = os.path.join(OUT_DIR, "small_8bit_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(dataclasses.replace(cfg, ckpt_dir=ckpt),
                                                  device="cuda", report=gpu))
    cli.run_fit(cfg, device="cpu", report=cpu)
    check(launches["adam8bit_superleaf_update"] == 3, f"small 8-bit fit: K9 {launches}")
    check(all(n > 0 for name, n in launches.items() if name != "ivf_probe_topk"),
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

    fcfg = dataclasses.replace(
        cfg, max_steps=3, eval_every=0, ckpt_dir=None,
        index=dataclasses.replace(cfg.index, rebuild_every=2),
        logging=dataclasses.replace(cfg.logging, log_dir=os.path.join(OUT_DIR, "small_ivf")))
    gpu, cpu = {}, {}
    _, launches = run_counted(lambda: cli.run_fit(fcfg, device="cuda", report=gpu))
    cli.run_fit(fcfg, device="cpu", report=cpu)
    check(all(n > 0 for name, n in launches.items() if name != "adam8bit_superleaf_update"),
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


def phase_slice() -> dict:
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
# phases 10 and 11: the training slice, and with the capacity knobs on
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4


def train_slice_config():
    """``configs/led_base_multi_x_science.yaml`` cut to a few steps: its
    ``IVF256,SQ8`` index (nprobe 8; 131 clusters over the fixture's 1055
    rows) refreshed every 2 steps, no pretrained weights (seeded random
    init), the hash tokenizer over the committed 2000-example fixture, no
    eval and no checkpoints. Widths, lengths, batch, top-k, memory encoder,
    index and precision are the file's."""
    import yaml

    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    with open(os.path.join(REPO, "configs", "led_base_multi_x_science.yaml")) as f:
        d = yaml.safe_load(f)
    d["model"] = {k: v for k, v in d["model"].items() if not k.endswith("_weights")}
    d["data"].update(source=FIXTURE, tokenizer=None)
    d["index"].update(rebuild_every=2)
    d.update(max_steps=TRAIN_STEPS, eval_every=0, ckpt_dir=None,
             logging={"log_dir": os.path.join(OUT_DIR, "train_slice"),
                      "run_name": "led_base_train"})
    return config_from_dict(d)


def _train_run(cfg, tag: str, optimizer_kernel: bool) -> tuple[dict, dict]:
    """``cli.run_fit`` of ``cfg`` on the card with the launch counts read
    around it and the peak device memory → (launches, summary)."""
    import gc

    import torch

    from retrieval_augmented_mds_tpu_torch import cli

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
    check(all(n > 0 for name, n in launches.items()
              if optimizer_kernel or name != "adam8bit_superleaf_update"),
          f"{tag}: kernel not launched: {launches}")
    check(launches["adam8bit_superleaf_update"] == (TRAIN_STEPS if optimizer_kernel else 0),
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
    summary = {"peak_gib": peak / 2**30, "step_s": sum(steady) / len(steady),
               **{k: sum(ph[k] for ph in report["phase_s"][-2:]) / 2
                  for k in ("forward", "backward", "optimizer")}}
    return launches, summary


def phase_train_slice() -> tuple[dict, dict]:
    return _train_run(train_slice_config(), "train", optimizer_kernel=False)


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
    launches, cap = _train_run(cfg, "capacity", optimizer_kernel=True)
    base_launches, base = standing
    for name in ("flash_sliding_attention", "flash_dense_attention"):
        check(launches[name] > base_launches[name],
              f"capacity: {name} not recomputed ({launches[name]} vs {base_launches[name]})")
    print("[capacity] against the standing train slice of this call (steady = mean of "
          "the last two steps): " + "; ".join(
              f"{k} {base[k]:.3f} -> {cap[k]:.3f}" + (" GiB" if k == "peak_gib" else " s")
              for k in ("peak_gib", "step_s", "forward", "backward", "optimizer")))
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
        measured["ivf_probe_topk"] = phase_k8()
        measured["adam8bit_superleaf_update"] = phase_k9()
        phase_small_reference()
        phase_small_fit()
        phase_small_fit_8bit()
        phase_small_ivf()
        served = phase_slice()
        standing = phase_train_slice()
        capacity = phase_capacity_slice(standing)
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
    ]
    kernels = [{"name": name, "route": "cuda",
                "source": f"retrieval_augmented_mds_tpu_torch/csrc/{src}",
                "replaces": f"retrieval_augmented_mds_tpu/{tpu}",
                "launches": served[name] + standing[0][name] + capacity[name],
                **measured[name]}
               for name, src, tpu in sources]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
