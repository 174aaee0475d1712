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
     threshold;
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
     the bf16 kernels skip the key tiles the bias masks whole;
     The f32 cases of the retriever's path: K1 at its full-KB validation
     (B = N = 1997, D = 768, and D = 769 with the l2 route's augmented
     column), K2 at its train step (B=4) and encode batches (B=64), K3 at
     its train step, K2/K3 beside SDPA in f32 under the same mask;
  5b. kernel K10 (phase 1 of the two-phase MIPS top-k) against its plain
     version at K1's serving shape, its top-k against K1's and, on a bf16
     corpus, its scores at K1's hits bit-equal to K1's values;
  6. kernel K8 (the per-query IVF probe top-k) against its plain version on
     the same probe ids, on IVF indexes (C = 1024, SQ8 and bf16) built by
     the port over 1,048,576 rows of the ``bench-index`` Gaussian mixture
     (D = 768), at B = 4 and 16, nprobe = 32, k = 10, and with 16 queries
     that all probe the same 32 clusters; with its read amplification and
     the device time of its passes, the K1 flat scan of the same payload
     beside its bound, the build time and recall@10;
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
     summarizer's ``predict`` with ``model.encoder_state_path`` set to it.

The line before the last is the per-kernel JSON summary (launches summed
over the five slices, K10's from its own phase, as no path calls it; ms,
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

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(
    REPO, "retrieval_augmented_mds_tpu", "data", "fixtures",
    "multi_x_science_2000.json.gz",
)
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # fit logs, saved indexes
WARMUP, REPS = 2, 10
PLAIN_LONG_REPS = 3  # the plain versions at 16384 keys or rows: ~0.1 s a call
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
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_chunkmax, mips_topk

    return {f.__name__: f for f in (mips_topk, flash_sliding_attention,
                                    flash_sliding_backward, flash_dense_attention,
                                    flash_dense_backward, ivf_probe_topk,
                                    adam8bit_superleaf_update, flash_dense_blocked,
                                    flash_dense_blocked_backward, mips_chunkmax)}


# kernels that only the long-source slice runs, and K10, which no path runs
LONG_ONLY = ("flash_dense_blocked", "flash_dense_blocked_backward")
NO_PATH = ("mips_chunkmax",)


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
    print(f"[K1] {name}: B={b} N={n} D={d} k={k} {dtype}: PASS ({tol}; rerun "
          f"bit-equal); max_abs_err {err:.3e}"
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
    _k1_case("rising_bf16", 64, 131072, 768, 128, torch.bfloat16, rising=True, timed=True)
    _k1_case("rising_sq8", 4, 200003, 768, 10, "int8", rising=True)
    # the retriever's full-KB validation: its 1997 queries over the 1997
    # encoded positives, f32; the l2 route's φ-augmented D = 769
    _k1_case("retriever_val", 1997, 1997, 768, 10, torch.float32, timed=True)
    _k1_case("retriever_val_l2", 1997, 1997, 769, 10, torch.float32, bias=True, timed=True)
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
    bound = roofline(n_bytes, flops, dtype == torch.float32)
    print(f"[K2] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]} lengths {shape[6]} valid "
          f"globals {shape[7]}: PASS (out within {tol_out} x each row set's own max|ref|: "
          f"{'; '.join(said)}; m atol {tol_m}+rtol 1e-6: {m_err:.3e}; l rtol {tol_l}: "
          f"{l_rel:.3e}; a second run bit-equal)"
          + (f"; plain version on the first {pb} batches only" if pb < shape[0] else "")
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
    _k2_case("longformer_base", lf, torch.bfloat16, library=True)
    _k2_case("longformer_base", lf, torch.float32)
    # the retriever's f32 encoder layers: its train step (B=4) and the
    # validation's encode batches (B=64)
    _k2_case("retriever_train", RET_QUERY, torch.float32, library=True)
    _k2_case("retriever_encode", RET_ENCODE, torch.float32, library=True)
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
    bound = roofline(n_bytes, flops, dtype == torch.float32)
    print(f"[K3] {name} {dtype}: B,nh,T,dh,w,G={shape[:6]} lengths {shape[6]} valid "
          f"globals {shape[7]}, dO {'zero on padded and global rows' if model_do else 'random'}"
          f": PASS (dq, dk, dv, dkg, dvg on every row, fully masked ones included, within "
          f"{tol} x max|ref|: max abs err {err:.3e}; a second run bit-equal)"
          + (f"; plain version on the first {pb} batches only" if pb < shape[0] else "")
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
    _k3_case("longformer_query", query, torch.bfloat16, library=True)
    # the retriever's train step: the same shape in f32
    _k3_case("longformer_query", query, torch.float32, library=True)
    _k3_case("longformer_memory", memory, torch.bfloat16, library=True)
    _k3_case("led_base_16k", LED_16K, torch.bfloat16, plain_b=2, library=True)
    # the fixture's padding, its globals and the model's zero cotangents, at
    # the standing and the long-source slices' lengths
    _k3_case("led_base_fixture", LED_FIXTURE, torch.bfloat16, model_do=True, library=True)
    _k3_case("led_base_16k_fixture", LED_16K_FIXTURE, torch.bfloat16, plain_b=2,
             model_do=True, library=True)
    return served


def _dense_inputs(b, t, s, lengths, dtype, seed):
    """(generator, q, k, v, key_bias) of the decoder's attention, nh = 12,
    dh = 64; batch i's source is lengths[i] long (0: all padding)."""
    import torch

    nh, dh = 12, 64
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
    g, q, k, v, kb = _dense_inputs(b, t, s, lengths, dtype, seed=21)
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
    f32 = dtype == torch.float32
    # bytes: K and V of the keys the rows need (`_dense_reads`), the rest in full
    open_keys, blind_keys = _dense_reads(kb)
    per_key = nh * dh * k.element_size()
    bound4 = roofline(nbytes(q, kb, out, m, l) + per_key * (2 * open_keys + blind_keys),
                      4 * dh * pairs, f32)
    bound5 = roofline(nbytes(q, *bwd[3:], *got) + per_key * 2 * (open_keys + blind_keys),
                      10 * dh * pairs, f32)
    times = [None] * 6
    if timed:
        times = [cuda_ms(lambda: flash_dense_attention(q, k, v, kb, causal=causal)),
                 cuda_ms(lambda: dense_rows_plain(q, k, v, kb, causal)),
                 cuda_ms(lambda: flash_dense_backward(*bwd, causal=causal)),
                 cuda_ms(lambda: dense_backward_plain(*bwd, causal)),
                 *_sdpa_ms(q, k, v, kb, do, causal)]
    shape = f"B={b} nh={nh} T={t} S={s} dh={dh} causal={causal} lengths={lengths}"
    print(f"[K4] {what}: {shape}: PASS (out within {tol} x max|ref|: {err4:.3e}; "
          f"m atol 1e-3, l rtol 1e-3; a second run bit-equal)"
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
    # 2048-token source of the train step, B=4 (longer sources: phase_k67)
    _dense_case("decoder_self", 4, 512, 512, True, [512] * 4, torch.bfloat16)
    cross = _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0],
                        torch.bfloat16)
    _dense_case("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0],
                torch.float32, timed=False)
    # the fixture's own padding: sources of its order of length, none empty
    _dense_case("decoder_cross_fixture", 4, 512, 2048, False, FIXTURE_LENGTHS,
                torch.bfloat16)
    return cross


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
    f32 = dtype == torch.float32
    # bytes: K and V of the keys the rows need (`_dense_reads`), the rest in full
    open_keys, blind_keys = _dense_reads(kb)
    per_key = nh * dh * k.element_size()
    bound6 = roofline(nbytes(q, kb, out, lse) + per_key * (2 * open_keys + blind_keys),
                      4 * dh * pairs, f32)
    bound7 = roofline(nbytes(q, kb, out, lse, do, *got)
                      + per_key * 2 * (open_keys + blind_keys), 10 * dh * pairs, f32)
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
             f"bound {bound6['bound_ms']:.3f} ms ({bound6['bound_by']})" if timed else ""))
    print(f"[K7] {what}: {shape}: PASS (dq, dk, dv each within {tol} x its max|ref|: "
          f"{err7:.3e}{pad})"
          + (f"; kernel {times[2]:.3f} ms, plain {times[3]:.3f} ms, sdpa backward "
             f"{times[5]:.3f} ms, bound {bound7['bound_ms']:.3f} ms ({bound7['bound_by']})"
             if timed else ""))
    return (result(err6, times[0], times[1], bound6, times[4]),
            result(err7, times[2], times[3], bound7, times[5]))


def phase_k67():
    import torch

    # the decoder's cross-attention of the long-source slice: B=4 sources
    # padded to 16384 tokens, one of them empty; then f32 at S = 8192
    cross = _blocked_case("decoder_cross_16k", 4, 512, 16384, False,
                          [16384, 11000, 3000, 0], torch.bfloat16)
    _blocked_case("decoder_cross_8k", 2, 256, 8192, False, [8192, 0], torch.float32,
                  timed=False)
    _blocked_case("causal_ragged", 2, 4500, 4500, True, [4500, 4500], torch.bfloat16,
                  timed=False)
    _blocked_case("decoder_cross_16k_fixture", 4, 512, 16384, False, FIXTURE_LENGTHS,
                  torch.bfloat16)
    return cross


# ---------------------------------------------------------------------------
# phase 5b: K10, phase 1 of the two-phase MIPS top-k
# ---------------------------------------------------------------------------

def _k10_case(name, b, n, d, k, dtype, *, timed=False):
    """K10 against `mips_chunkmax_plain`: the same masked cells (-3e38),
    scores and chunk maxima within 1e-4 x max|score| (f32 sums of the same
    products in another order); the two-phase top-k against K1's (random
    data: no equal scores, so K1's distinct-value rule and the all-hits
    rule agree): equal ids, values within rtol 1e-5 + atol 1e-4. Returns
    (result, launches of the top-k call)."""
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
    if dtype == torch.bfloat16:  # one tensor-core tile: K1's values bit for bit
        check(torch.equal(torch.gather(scores, 1, k1_ids.long()), k1_vals),
              f"K10 {name}: scores at K1's hits differ from K1's values")
    same_bits = (", its scores there bit-equal to K1's values"
                 if dtype == torch.bfloat16 else "")
    ms = plain_ms = lib_ms = None
    if timed:
        ms = cuda_ms(lambda: mips_chunkmax(q, e, rb, ign))
        plain_ms = cuda_ms(lambda: mips_chunkmax_plain(q, e, rb, ign))
        # the yardstick: the same f32 scores from one bf16 GEMM (no single
        # PyTorch call also gives the chunk maxima or the masks)
        lib_ms = cuda_ms(lambda: torch.mm(q.to(dtype), e.T, out_dtype=torch.float32))
    bound = roofline(nbytes(q.to(dtype), e, rb, ign, scores, cmax), 2.0 * b * n * d,
                     dtype == torch.float32)
    print(f"[K10] {name}: B={b} N={n} D={d} k={k} {dtype}, bias, 8 ignored ids: PASS "
          f"(scores and chunk maxima within {tol:.3e}: max abs err {err:.3e}; masked "
          f"cells equal; top-{k} ids equal to K1's{same_bits})"
          + (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.mm of the scores "
             f"{lib_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']})"
             if timed else ""))
    return result(err, ms, plain_ms, bound, lib_ms), launches["mips_chunkmax"]


def phase_k10():
    import torch

    measured, launches = _k10_case("serving", 256, 131072, 768, 10, torch.bfloat16,
                                   timed=True)
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
    bound = roofline(n_probed * L * row_bytes + nbytes(q, probes) + b * K8_K * 8,
                     2.0 * b * K8_NPROBE * L * d, False)
    split = device_ms_by_kernel(lambda: ivf_probe_topk(*args, K8_K))
    pass1 = sum(v for n, v in split.items() if "ivf_partial_kernel" in n)
    merge = sum(v for n, v in split.items() if "ivf_merge" in n)
    rest = sum(split.values()) - pass1 - merge
    print(f"[K8] {what} nprobe={K8_NPROBE} k={K8_K}: PASS (positions equal but "
          f"{n_swapped} swapped near-ties within tol {tol:.3e}; values max abs err "
          f"{err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {n_probed} distinct clusters "
          f"of {b * K8_NPROBE} probes, read amplification {b * K8_NPROBE / n_probed:.2f}), "
          f"{bound['bound_ms'] / ms:.1%} of it; device time per call (profiler): pass 1 "
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
            err, ms, plain_ms, bound = _k8_case(f"{payload} B={b}", args)
            flat_ms = cuda_ms(lambda: mips_topk(q, flat, K8_K, None, None, flat_scale))
            # K1's flat scan: the payload and its scales read once
            flat_bound = roofline(nbytes(q, flat, flat_scale) + b * K8_K * 8,
                                  2.0 * b * K8_N * d, False)["bound_ms"]
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
              if name not in ("ivf_probe_topk", "adam8bit_superleaf_update", *LONG_ONLY,
                              *NO_PATH)),
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
    check(all(n > 0 for name, n in launches.items()
              if name not in ("ivf_probe_topk", *LONG_ONLY, *NO_PATH)),
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
    check(all(n > 0 for name, n in launches.items()
              if name not in ("adam8bit_superleaf_update", *LONG_ONLY, *NO_PATH)),
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


def _train_run(cfg, tag: str, off_path: tuple[str, ...]) -> tuple[dict, dict]:
    """``cli.run_fit`` of ``cfg`` on the card with the launch counts read
    around it and the peak device memory → (launches, summary). Every
    kernel launches, but those in ``off_path``, which must not."""
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


def phase_retriever_slice() -> dict:
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
    K2 and K3 launched in training, and K10 nowhere."""
    import numpy as np
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.checkpoint import load_arrays

    cfg = led_base_config("retriever", max_steps=RET_STEPS, eval_every=RET_EVAL_EVERY)
    report: dict = {}
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
        measured["mips_chunkmax"], k10_launches = phase_k10()
        measured["ivf_probe_topk"] = phase_k8()
        measured["adam8bit_superleaf_update"] = phase_k9()
        phase_small_reference()
        phase_small_fit()
        phase_small_fit_8bit()
        phase_small_ivf()
        served = phase_slice()
        standing = phase_train_slice()
        capacity = phase_capacity_slice(standing)
        long = phase_long_slice(standing)
        retriever = phase_retriever_slice()
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
    ]
    # launches on the paths (the five slices); K10's paths launch it 0 times (checked), so its
    # count is that of its own phase
    launches = {name: served[name] + standing[0][name] + capacity[name] + long[name]
                + retriever[name] for name, _, _ in sources}
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
