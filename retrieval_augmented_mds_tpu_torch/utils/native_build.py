"""Build the repository's native C++ host libraries and load them with ctypes.

The sources are ``native/cpu_mips.cpp`` (the CPU MIPS baseline) and
``native/batch_loader.cpp`` (the async batch assembler). They are read by
path and never written: the libraries go into ``build/torch_native/`` at
the repository root, not into ``native/build/``, which ``make -C native``
writes for the JAX package. The flags are ``native/Makefile``'s. A
library's file name is keyed by a hash of its source, its flags and what
``-march=native`` selects on this host, so a library built on another
machine is never loaded here. Each process compiles into a temporary file
of its own and renames it into place (``os.replace`` is atomic), so
processes that build at once never load a half-written library. Nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17")
# per source, after CXXFLAGS (native/Makefile)
EXTRA_FLAGS = {"cpu_mips": (), "batch_loader": ("-pthread",)}

_loaded: dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def _host_target() -> str:
    """The target options ``-march=native`` expands to on this host (the
    compiler's own cc1plus line)."""
    res = subprocess.run([CXX, "-march=native", "-E", "-v", "-x", "c++", os.devnull,
                          "-o", os.devnull], capture_output=True, text=True, check=True)
    lines = [ln for ln in res.stderr.splitlines() if "cc1plus" in ln and "-march=" in ln]
    if not lines:
        raise RuntimeError(f"{CXX} -march=native -v printed no target line:\n{res.stderr}")
    return lines[0][lines[0].index("-march="):]


def flags(name: str) -> tuple[str, ...]:
    return CXXFLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> str:
    """``native/<name>.cpp``'s library in `BUILD_DIR`, keyed by the source,
    the flags and the host's target."""
    digest = hashlib.sha256(" ".join((CXX, *flags(name), _host_target())).encode())
    with open(os.path.join(NATIVE_DIR, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its keyed library exists → its
    path. Raises with the compiler's output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, *flags(name), "-o", tmp, os.path.join(NATIVE_DIR, f"{name}.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build(name))
    return lib
