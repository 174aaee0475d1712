"""ctypes binding to the native async batch assembler
(``native/batch_loader.cpp``).

Counterpart of ``retrieval_augmented_mds_tpu/data/native_loader.py``. The
reference feeds training from torch DataLoaders whose worker pool
collates batches off the training thread (sotasum/data_modules.py:287-321).
Here the tokenized dataset is a dict of fixed-shape row-major numpy
arrays, and a C++ worker thread gathers shuffled rows into a ring of
preallocated batch buffers, so host-side batch assembly overlaps the
device's work. The library is built on first use into
``build/torch_native/`` (`utils.native_build`), never by ``make -C
native``; a build that fails raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Iterator

import numpy as np


def _load() -> ctypes.CDLL:
    from ..utils.native_build import load

    lib = load("batch_loader")
    lib.batch_loader_create.restype = ctypes.c_void_p
    lib.batch_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.batch_loader_n_batches.restype = ctypes.c_int64
    lib.batch_loader_n_batches.argtypes = [ctypes.c_void_p]
    lib.batch_loader_next.restype = ctypes.c_int32
    lib.batch_loader_next.argtypes = [ctypes.c_void_p]
    lib.batch_loader_release.restype = None
    lib.batch_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.batch_loader_destroy.restype = None
    lib.batch_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_batches(
    examples: dict[str, np.ndarray],
    order: np.ndarray,
    batch_size: int,
    *,
    n_slots: int = 3,
) -> Iterator[dict[str, np.ndarray]]:
    """An iterator of batches ``{k: examples[k][order[i:i+batch_size]]}``
    (keys in sorted order) assembled by the native worker. ``order`` must
    already be trimmed to a multiple of ``batch_size`` (drop_last lives in
    the caller).

    What depends on the environment (building and loading the library,
    pinning the field pointers, creating the loader, whose worker starts at
    once) happens HERE, so a toolchain that cannot build it raises at call
    time, before the caller has consumed any batch.

    Yielded arrays are fresh copies of the ring-slot contents: the slot is
    released back to the worker as soon as the copy is taken, so a consumer
    may keep batches arbitrarily long, or hand them to an asynchronous
    device copy, and never see a refilled slot. The loader is destroyed
    (its worker joined) once: when the iterator ends or is closed, or, for
    an iterator dropped before it ends, when it is collected."""
    lib = _load()
    keys = sorted(examples.keys())
    arrs = [np.ascontiguousarray(examples[k]) for k in keys]
    n_rows = arrs[0].shape[0]
    if any(a.shape[0] != n_rows for a in arrs):
        raise ValueError("every field must have the same number of rows")
    order = np.ascontiguousarray(order, dtype=np.int64)
    if len(order) % batch_size:
        raise ValueError(f"{len(order)} rows are not a multiple of batch_size={batch_size}")
    if len(order) and (order.min() < 0 or order.max() >= n_rows):
        raise ValueError(f"order holds rows outside [0, {n_rows})")

    field_ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
    )
    row_nbytes = (ctypes.c_int64 * len(arrs))(
        *[a.strides[0] if a.ndim > 1 else a.itemsize for a in arrs]
    )
    # the ring's slot buffers, owned by numpy, laid out [slot][field]
    slots = [[np.empty((batch_size,) + a.shape[1:], dtype=a.dtype) for a in arrs]
             for _ in range(n_slots)]
    slot_ptrs = (ctypes.c_void_p * (n_slots * len(arrs)))(
        *[b.ctypes.data_as(ctypes.c_void_p).value for slot in slots for b in slot]
    )
    handle = lib.batch_loader_create(
        field_ptrs, row_nbytes, len(arrs), n_rows,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(order),
        batch_size, n_slots, slot_ptrs,
    )
    if not handle:
        raise RuntimeError("batch_loader_create failed (bad arguments)")

    destroyed = []

    def destroy():
        # reached from the generator's finally and from the finalizer
        if not destroyed:
            destroyed.append(True)
            lib.batch_loader_destroy(handle)  # joins the worker thread

    def run():
        # arrs, order and slots are closed over: every buffer the worker
        # touches stays alive while the generator does
        try:
            for _ in range(lib.batch_loader_n_batches(handle)):
                slot = lib.batch_loader_next(handle)
                if slot < 0:
                    break
                batch = {k: slots[slot][f].copy() for f, k in enumerate(keys)}
                lib.batch_loader_release(handle, slot)
                yield batch
        finally:
            destroy()

    gen = run()
    # a generator dropped before it started never runs its finally: the
    # finalizer destroys the loader (joins the worker) first, and only then
    # drops the buffers it pins
    weakref.finalize(gen, lambda _pin=(arrs, order, slots, field_ptrs, row_nbytes,
                                       slot_ptrs): destroy())
    return gen
