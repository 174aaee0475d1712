#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. environment: the card's name and power limit, torch/CUDA/nvcc
     versions; builds both CUDA kernels from ``retrieval_augmented_mds_tpu_torch/csrc``.
  2. kernel K1 (MIPS top-k) against its plain PyTorch version;
  3. kernel K2 (sliding-window local rows) against its plain version;
  4. ``predict`` on ``configs/smoke.yaml`` on the card and on the CPU (the
     plain versions), from one seed: equal retrieved and generated ids;
     then the slice: ``cli.run_predict`` of the port on the led_base preset
     (seeded random weights) over the committed 2000-example fixture,
     with both kernels' launch counts read around that run.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port's
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(
    REPO, "retrieval_augmented_mds_tpu", "data", "fixtures",
    "multi_x_science_2000.json.gz",
)
WARMUP, REPS = 2, 10


class SmokeFailure(AssertionError):
    pass


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
    for name in ("mips_topk", "flash_sliding_fwd"):
        t0 = time.perf_counter()
        path = cuda_build.build(name)
        cuda_build.load(name)
        with open(f"{path}.log") as f:
            usage = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {time.perf_counter() - t0:.1f} s")
        for ln in usage:
            print(f"[build]   {ln}")
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


def phase_slice() -> dict:
    import torch

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import rag_decode
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
    )
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
        mips_topk,
        mips_topk_plain,
    )
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(SLICE_CONFIG)
    report: dict = {}
    torch.cuda.reset_peak_memory_stats()
    mips_topk.launches = 0
    flash_sliding_attention.launches = 0
    t0 = time.perf_counter()
    out = cli.run_predict(cfg, device="cuda", report=report)
    wall = time.perf_counter() - t0
    launches = {"mips_topk": mips_topk.launches,
                "flash_sliding_attention": flash_sliding_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    store, enc, ids, batch = report["store"], report["enc"], report["ids"], report["batch"]
    b = cfg.data.batch_size
    n = store.index.n
    check(all(c > 0 for c in launches.values()), f"kernel not launched: {launches}")
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
        k1 = phase_k1()
        k2 = phase_k2()
        phase_small_reference()
        launches = phase_slice()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "mips_topk", "route": "cuda",
         "source": "retrieval_augmented_mds_tpu_torch/csrc/mips_topk.cu",
         "replaces": "retrieval_augmented_mds_tpu/ops/mips_topk.py:52",
         "launches": launches["mips_topk"], "max_abs_err": k1[0], "ms": k1[1],
         "plain_ms": k1[2]},
        {"name": "flash_sliding_attention", "route": "cuda",
         "source": "retrieval_augmented_mds_tpu_torch/csrc/flash_sliding_fwd.cu",
         "replaces": "retrieval_augmented_mds_tpu/ops/flash_sliding.py:54",
         "launches": launches["flash_sliding_attention"], "max_abs_err": k2[0],
         "ms": k2[1], "plain_ms": k2[2]},
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
