#!/usr/bin/env python3
"""Device time of the port's bf16 attention kernels, per pass, on one
NVIDIA GPU: the dense backward (K5, K7), the long-source dense forward
(K6) and the sliding-window backward (K3).

    python3 tools/torch_profile_dense_bwd.py

Builds the kernels, then for each case of ``chip_smoke.py``'s phases
(K5/K7: the decoder's causal self-attention, its cross-attention over a
2048- and a 16384-token source; K6: the 16384-token cross-attention; K3:
the LED encoder layer at T = 2048 and 16384 and the Longformer query and
memory layers; each with chip_smoke's lengths and, where chip_smoke has
one, with the fixture's own padding) prints the mean time of one call
(CUDA events, as chip_smoke times it) and each CUDA kernel's mean device
time over 10 calls from ``torch.profiler``: K3's three passes (dq; dk, dv;
dkg, dvg) and K5/K7's two apart, and the small PyTorch kernels around
them (delta = rowsum(g * out)).
"""

from __future__ import annotations

import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (  # noqa: E402
    flash_dense_attention,
    flash_dense_backward,
    flash_dense_blocked,
    flash_dense_blocked_backward,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (  # noqa: E402
    flash_sliding_attention,
    row_delta,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (  # noqa: E402
    flash_sliding_backward,
)

# (name, B, T, S, causal, source lengths, K7 or K5)
DENSE_CASES = [
    ("decoder_cross_16k", 4, 512, 16384, False, [16384, 11000, 3000, 0], True),
    ("decoder_cross_16k_fixture", 4, 512, 16384, False, c.FIXTURE_LENGTHS, True),
    ("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0], False),
    ("decoder_cross_fixture", 4, 512, 2048, False, c.FIXTURE_LENGTHS, False),
    ("decoder_self", 4, 512, 512, True, [512] * 4, False),
]
# (name, chip_smoke shape, dO zero on padded and global rows)
SLIDING_CASES = [
    ("led_base", (4, 12, 2048, 64, 512, 64, [2048, 1800, 1000, 512], [64, 10, 3, 0]),
     False),
    ("led_base_fixture", c.LED_FIXTURE, True),
    ("led_base_16k", c.LED_16K, False),
    ("led_base_16k_fixture", c.LED_16K_FIXTURE, True),
    ("longformer_query", (4, 12, 512, 64, 256, 1, [512, 500, 300, 130], [1] * 4), False),
    ("longformer_memory", (8, 12, 512, 64, 256, 1, [512, 500, 430, 300, 257, 200, 130, 100],
                           [1] * 8), False),
]


def dense_call(b, t, s, causal, lengths, blocked, forward=False):
    g, q, k, v, kb = c._dense_inputs(b, t, s, lengths, torch.bfloat16, seed=21)
    if forward:
        return lambda: flash_dense_blocked(q, k, v, kb, causal=causal)
    if blocked:
        out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
        do = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
        return lambda: flash_dense_blocked_backward(q, k, v, kb, out, lse, do, causal=causal)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    do = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    args = (q, k, v, kb, do, m, l, row_delta(do, out))
    return lambda: flash_dense_backward(*args, causal=causal)


def sliding_backward_call(shape, model_do):
    args, rows_ok, is_global = c._k2_inputs(*shape, dtype=torch.bfloat16, seed=11)
    *tensors, w = args
    out, m, l = flash_sliding_attention(*tensors, window=w, return_stats=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    if model_do:
        do = do.masked_fill(~(rows_ok & ~is_global)[:, None, :, None], 0.0)
    bwd = (*tensors, do, m, l, row_delta(do, out))
    return lambda: flash_sliding_backward(*bwd, window=w)


def report(label, fn) -> None:
    ms = c.cuda_ms(fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key.replace("void (anonymous namespace)::", "")[:40],
                    e.device_time_total / e.count, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    print(f"[prof] {label}: {ms:.3f} ms per call; "
          + "; ".join(f"{k} {us:.1f} us x{n}" for k, us, n in rows))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    c.phase_env()
    for name, b, t, s, causal, lengths, blocked in DENSE_CASES:
        shape = f"B={b} T={t} S={s} causal={causal} lengths={lengths}"
        report(f"{'K7' if blocked else 'K5'} {name} ({shape})",
               dense_call(b, t, s, causal, lengths, blocked))
        if blocked:
            report(f"K6 {name} ({shape})", dense_call(b, t, s, causal, lengths, True, True))
    for name, shape, model_do in SLIDING_CASES:
        report(f"K3 {name} (B,nh,T,dh,w,G={shape[:6]} lengths={shape[6]} valid globals="
               f"{shape[7]} dO {'zero on padded and global rows' if model_do else 'random'})",
               sliding_backward_call(shape, model_do))
    return 0


if __name__ == "__main__":
    sys.exit(main())
