"""Build the hand-written CUDA kernels and load them with ctypes.

Each kernel lives in one ``csrc/<name>.cu`` file with a plain C entry
point; tile routines that several kernels share are in ``csrc/*.cuh``.
On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` at the repository root, keyed by a hash of the
sources, and loaded as a shared library. Nothing is built at import time:
the CPU path never calls this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of csrc/, by name
KERNELS = ("mips_topk", "flash_sliding_fwd", "flash_sliding_bwd", "flash_dense_fwd",
           "flash_dense_bwd", "ivf_probe_topk", "adam8bit_update")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cuda_home}/bin and PATH); the CUDA "
            "kernels cannot be built"
        )
    return found


def library_path(name: str) -> str:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(*names: str) -> list[str]:
    """Compile ``csrc/<name>.cu`` for every name whose hashed library does
    not exist yet, one ``nvcc`` per source, all started together; returns
    the library paths. The compiler's resource report (``-Xptxas -v``) is
    kept beside each library as ``<library>.log``."""
    outs = [library_path(n) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        procs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in procs:
        stdout, stderr = proc.communicate()
        with open(f"{out}.log", "w") as f:
            f.write(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                          f"{stderr[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)[0])
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t={err}")
