#!/usr/bin/env python3
"""Device time of the port's bf16 dense-attention backward (K5, K7), per
pass, on one NVIDIA GPU.

    python3 tools/torch_profile_dense_bwd.py

Builds the kernels, then for each case of ``chip_smoke.py``'s K5/K7
phases (the decoder's causal self-attention, its cross-attention over a
2048- and a 16384-token source, each with chip_smoke's lengths and with
the fixture's own padding) prints the mean time of one backward call
(CUDA events, as chip_smoke times it) and each CUDA kernel's mean device
time over 10 calls from ``torch.profiler``: the dq pass and the dk/dv pass
apart, and the small PyTorch kernels of delta = rowsum(g * out) around K7.
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
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import row_delta  # noqa: E402

# (name, B, T, S, causal, source lengths, K7 or K5)
CASES = [
    ("decoder_cross_16k", 4, 512, 16384, False, [16384, 11000, 3000, 0], True),
    ("decoder_cross_16k_fixture", 4, 512, 16384, False, c.FIXTURE_LENGTHS, True),
    ("decoder_cross", 4, 512, 2048, False, [2048, 1800, 1000, 0], False),
    ("decoder_cross_fixture", 4, 512, 2048, False, c.FIXTURE_LENGTHS, False),
    ("decoder_self", 4, 512, 512, True, [512] * 4, False),
]


def backward_call(b, t, s, causal, lengths, blocked):
    g, q, k, v, kb = c._dense_inputs(b, t, s, lengths, torch.bfloat16, seed=21)
    if blocked:
        out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
        do = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
        return lambda: flash_dense_blocked_backward(q, k, v, kb, out, lse, do, causal=causal)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    do = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    args = (q, k, v, kb, do, m, l, row_delta(do, out))
    return lambda: flash_dense_backward(*args, causal=causal)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    c.phase_env()
    for name, b, t, s, causal, lengths, blocked in CASES:
        fn = backward_call(b, t, s, causal, lengths, blocked)
        ms = c.cuda_ms(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key[:40], e.device_time_total / e.count, e.count)
                       for e in prof.key_averages() if e.device_time_total > 0),
                      key=lambda r: -r[1])
        print(f"[prof] {'K7' if blocked else 'K5'} {name} (B={b} T={t} S={s} "
              f"causal={causal} lengths={lengths}): {ms:.3f} ms per call; "
              + "; ".join(f"{k} {us:.1f} us x{n}" for k, us, n in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
