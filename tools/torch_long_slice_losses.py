#!/usr/bin/env python3
"""Losses of the led_base standing and long-source train slices of
``chip_smoke.py`` on the same tokens, with no store refresh, on one NVIDIA
GPU.

    python3 tools/torch_long_slice_losses.py

``chip_smoke.py`` holds the long-source slice's losses to the standing
slice's at rtol 1e-4 where both retrieved the same rows, and looser where
a store refresh, made from parameters that differ by the two paths' bf16
roundings, swapped a nearly tied row. This runs both slices (4 steps,
``index.rebuild_every`` 0: one store, no swap from a refresh) and prints
each one's losses, whether each step retrieved the same rows, and the
largest relative difference over all steps, which then reads the
arithmetic of the two attention paths alone.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from retrieval_augmented_mds_tpu_torch import cli  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    c.phase_env()
    base = c.train_slice_config()
    base = dataclasses.replace(base, index=dataclasses.replace(base.index, rebuild_every=0))
    long = dataclasses.replace(base, data=dataclasses.replace(base.data,
                                                              max_length=c.LONG_SOURCE))
    losses, retrieved = {}, {}
    for tag, cfg in (("standing", base), ("long", long)):
        report: dict = {}
        cli.run_fit(cfg, device="cuda", report=report)
        losses[tag], retrieved[tag] = report["losses"], report["retrieved"]
        print(f"[losses] {tag}: max_length {cfg.data.max_length}, "
              f"{len(report['refresh_s'])} refreshes, losses {report['losses']}")
    same = [bool(torch.equal(a, b)) for a, b in zip(retrieved["standing"], retrieved["long"])]
    print(f"[losses] the same rows retrieved at each step: {same}")
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses["standing"], losses["long"]))
    print(f"[losses] no refresh: max rel diff of the long-source slice's losses from the "
          f"standing slice's {rel:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
