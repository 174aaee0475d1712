"""What the port's A/B tools (``torch_sliding_f32_ab.py``,
``torch_dense_f32_ab.py``, ``torch_mips_f32_ab.py``) share: the port's
package from any tree with ``chip_smoke.py`` from this file's tree, a
``torch.profiler`` window that sums the device time of its kernels by
class, and the digest that compares two runs' outputs bit for bit."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(tree: str, tool: str):
    """Put ``tree``'s port first on ``sys.path``, load chip_smoke from this
    file's tree (it imports the port only inside its functions, so they
    reach the tree's), turn TF32 off and run its ``phase_env``; returns the
    chip_smoke module. Exits when CUDA is not available."""
    sys.path.insert(0, tree)
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"

    import torch

    import retrieval_augmented_mds_tpu_torch as port

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    c = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = c
    spec.loader.exec_module(c)
    if not torch.cuda.is_available():
        sys.exit(f"{tool}: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[tree] {tree} (port {os.path.dirname(port.__file__)})")
    c.phase_env()
    return c


def digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def profile_window(label: str, step, n: int, classes: dict, top: int = 6) -> None:
    """Run ``step()`` ``n`` times under ``torch.profiler`` and print the
    wall time per step, the device time of its kernels (an operator's entry
    would repeat its kernels' time, so kernels alone) in all and by class
    (``classes``: name -> regex on the kernel's name), and the ``top``
    largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    kernels = [(e.key, e.self_device_time_total / n / 1e3, e.count // n)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    by = {k: sum(ms for name, ms, _ in kernels if re.search(rx, name))
          for k, rx in classes.items()}
    largest = sorted(kernels, key=lambda r: -r[1])[:top]
    print(f"[step] {label} under torch.profiler (mean of {n}): wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%); "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in by.items())
          + f", the rest {busy - sum(by.values()):.3f} ms; largest: "
          + "; ".join(f"{k[:48]} {ms:.3f} ms x{cnt}" for k, ms, cnt in largest))
