"""ctypes binding to the native C++ CPU MIPS baseline (``native/cpu_mips.cpp``).

Counterpart of ``retrieval_augmented_mds_tpu/utils/cpu_baseline.py``: an
exact flat search on the host (FAISS ``IndexFlat{IP,L2}``'s job; FAISS is
not installed), used as the exact reference of ``bench-index`` and as a
test oracle independent of the MIPS kernel. The library is built on first
use into ``build/torch_native/`` (`utils.native_build`), never by
``make -C native``.
"""

from __future__ import annotations

import ctypes

import numpy as np

_FUNCS = ("mips_search_f32", "l2_search_f32")


def _load() -> ctypes.CDLL:
    from .native_build import load

    lib = load("cpu_mips")
    for name in _FUNCS:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
    return lib


def cpu_mips_search(corpus: np.ndarray, queries: np.ndarray, k: int, metric: str = "ip"):
    """Exact CPU top-k → (values [B, k] f32, indices [B, k] int32), by
    descending inner product ("ip") or ascending squared distance ("l2",
    ranked by q·e - ‖e‖²/2, the value returned); slots past N are
    (-3e38, -1)."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    corpus = np.ascontiguousarray(corpus, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    n, d = corpus.shape
    b, d2 = queries.shape
    if d != d2:
        raise ValueError(f"query dim {d2} != corpus dim {d}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    lib = _load()
    out_vals = np.empty((b, k), np.float32)
    out_idx = np.empty((b, k), np.int32)
    fn = lib.mips_search_f32 if metric == "ip" else lib.l2_search_f32
    fn(corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
       queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, k,
       out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out_vals, out_idx
