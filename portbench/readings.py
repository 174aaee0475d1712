"""The readings that a cell's limits are set from: the cell run on several
seeds in one process (`harness.execute`; the kernels load once), with the
program's numbers and, with ``--control``, the control's in its place.
One JSON line a seed, written to ``--out`` as each ends. Not a measured
run: ``setup_s`` counts from the process's start.

    python3 -m portbench.readings --workload <cell> --seeds 11,12,13 --seconds 1 \\
        [--control fp8|tf32|half] --out <file.jsonl>
"""

from __future__ import annotations

import argparse
import gc
import json
import os

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", default=None, choices=("fp8", "tf32", "half"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res, run = harness.execute(args.workload, seed, args.seconds, False,
                                   control=args.control)
        line = {"workload": args.workload, "seed": seed, "control": args.control,
                "correct": res["correct"], "checks": res["checks"],
                "readings": run.facts.get("readings"),
                "control_readings": run.facts.get("control"),
                "served_lengths": run.facts.get("served_lengths"),
                "check_s": run.facts.get("check_s"),
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        del res, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
