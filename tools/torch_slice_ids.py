#!/usr/bin/env python3
"""The led_base train and capacity slices of chip_smoke.py on one NVIDIA
GPU, with each step's loss and a hash of the corpus rows each step
retrieved, so that two trees can be compared step by step.

    cd <tree root> && python3 <this file>

It imports ``chip_smoke`` and the port from the current directory, so the
same file runs any tree: for an A/B, run it from the parent's root and the
change's in turns (parent, change, change, parent) in one call. Prints the
card's name and power limit first, then one line per slice: the losses,
and per step the first 12 hex digits of the SHA-256 of the retrieved rows
[B, k] (int32, as the search returned them).
"""

from __future__ import annotations

import hashlib
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402


def digest(rows) -> str:
    return hashlib.sha256(rows.numpy().tobytes()).hexdigest()[:12]


def main() -> None:
    import dataclasses

    chip_smoke.phase_env()
    for tag, knobs, off in (
            ("train", {}, ("adam8bit_superleaf_update",)),
            ("capacity", {"adam_8bit": True, "remat": True}, ())):
        cfg = chip_smoke.train_slice_config()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **knobs))
        _, summary = chip_smoke._train_run(
            cfg, tag, off_path=(*off, *chip_smoke.LONG_ONLY, *chip_smoke.NO_PATH))
        print(f"[ids] {tag}: losses {[f'{x:.6f}' for x in summary['losses']]}; retrieved "
              f"rows per step {[digest(r) for r in summary['retrieved']]}")


if __name__ == "__main__":
    main()
