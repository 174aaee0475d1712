"""The benchmark's command:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints one JSON object as the last line of its standard output
(`harness.main`)."""

import os
import sys

# the port's optional libraries may load JAX through Flax; keep them from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
