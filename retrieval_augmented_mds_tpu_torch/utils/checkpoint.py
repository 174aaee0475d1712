"""Train-state checkpoints in the JAX package's file layout.

Counterpart of ``retrieval_augmented_mds_tpu/utils/checkpoint.py``: one
``step_<N>.npz`` of flattened key paths (``.params/led/encoder/0/attn/q/
kernel``, the optimizer state under optax's own paths, ``.step``), bf16
leaves stored as their uint16 bits and listed under ``__bf16_keys__``,
the 8-bit optimizer's int8/uint8 codes stored and loaded as such;
``latest.json`` points at the newest save and ``best.json`` marks the
checkpoint to keep. A checkpoint written by either package loads in the
other when both build the same optimizer. Over a mesh the optimizer's
state is gathered into the single-device layout, rank 0 writes the file,
and every rank loads it and keeps its own part, so a checkpoint moves
between one device and any mesh. `export_encoders` /
`import_encoders` write and read the retriever's ``encoders.npz`` (the
query and mips encoder groups) in the same layout.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_BF16_MARKER = "__bf16_keys__"


def _to_numpy(x) -> tuple[np.ndarray, bool]:
    """(array, stored as bf16 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), True
        return x.numpy(), False
    return np.asarray(x), False


def _from_numpy(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def state_arrays(state, tx) -> dict:
    """The train state's leaves under the reference's key paths."""
    flat = {f".params/{n.replace('.', '/')}": p
            for n, p in state.params.named_parameters()}
    flat.update(tx.state_arrays(state.params, state.opt_state))
    flat[".step"] = np.int32(state.step)
    return flat


def save_arrays(path: str, flat: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out, bf16_keys = {}, []
    for key, leaf in flat.items():
        out[key], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            bf16_keys.append(key)
    np.savez(path, **out, **{_BF16_MARKER: np.array(bf16_keys)})


def load_arrays(path: str) -> dict[str, torch.Tensor]:
    """Every leaf of an npz checkpoint as a CPU tensor (bf16 bits decoded)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    bf16 = set(data[_BF16_MARKER].tolist()) if _BF16_MARKER in data.files else set()
    return {k: _from_numpy(data[k], k in bf16) for k in data.files if k != _BF16_MARKER}


@torch.no_grad()
def load_params(params: torch.nn.Module, flat: dict) -> None:
    """Copy the ``.params/...`` leaves into ``params`` (in place); raises
    on a missing leaf or a shape mismatch."""
    for n, p in params.named_parameters():
        key = f".params/{n.replace('.', '/')}"
        if key not in flat:
            raise KeyError(f"checkpoint has no {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != {tuple(p.shape)}")
        p.copy_(arr.to(p.dtype))


def save_train_state(ckpt_dir: str, state, tx, step: int, keep: int = 1,
                     mesh=None) -> str:
    """Write ``ckpt_dir/step_<N>.npz``, point ``latest.json`` at it and
    prune all but the newest ``keep`` saves (never the one ``best.json``
    marks). Over a ``mesh`` every rank calls this (the state is gathered),
    rank 0 writes, and every rank returns once the files are there."""
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    flat = state_arrays(state, tx)
    if mesh is not None and mesh.rank != 0:
        torch.distributed.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    save_arrays(path, flat)
    with open(os.path.join(ckpt_dir, "latest.json"), "w") as f:
        json.dump({"step": step, "path": path}, f)
    protected = set()
    best_meta = os.path.join(ckpt_dir, "best.json")
    if os.path.exists(best_meta):
        with open(best_meta) as f:
            protected.add(os.path.basename(json.load(f)["path"]))
    existing = sorted(
        (p for p in os.listdir(ckpt_dir) if p.startswith("step_") and p not in protected),
        key=lambda p: int(p.split("_")[1].split(".")[0]),
    )
    for old in existing[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    if mesh is not None:
        torch.distributed.barrier()
    return path


def mark_best(ckpt_dir: str, step: int, path: str, metric: float | None = None) -> None:
    with open(os.path.join(ckpt_dir, "best.json"), "w") as f:
        json.dump({"step": step, "path": path, "metric": metric}, f)


def _meta(ckpt_dir: str, prefer: str) -> dict:
    name = "latest.json"
    if prefer == "best" and os.path.exists(os.path.join(ckpt_dir, "best.json")):
        name = "best.json"
    with open(os.path.join(ckpt_dir, name)) as f:
        return json.load(f)


def checkpoint_path(ckpt_dir: str, prefer: str = "latest") -> str:
    """The newest save's path (``prefer='best'``: the marked one, when
    there is one)."""
    return _meta(ckpt_dir, prefer)["path"]


def load_train_state(ckpt_dir: str, state, tx, prefer: str = "latest"):
    """Load a save (as `checkpoint_path` picks it) into ``state`` in place
    → (state, step); over a mesh (``tx`` built over it) each rank keeps its
    part of the optimizer state."""
    meta = _meta(ckpt_dir, prefer)
    flat = load_arrays(meta["path"])
    load_params(state.params, flat)
    state.opt_state = tx.load_state_arrays(state.params, flat)
    state.step = int(flat[".step"])
    return state, meta["step"]


ENCODER_GROUPS = ("query_encoder", "mips_encoder")


def export_encoders(path: str, params: torch.nn.Module, groups=ENCODER_GROUPS) -> None:
    """Write the retriever's encoder groups to ``path`` (``encoders.npz``) in
    the JAX package's layout: one array per leaf under its ``/``-joined key
    path (``query_encoder/layers/0/attn/q/kernel``)."""
    save_arrays(path, {f"{g}/{n.replace('.', '/')}": p
                       for g in groups for n, p in getattr(params, g).named_parameters()})


@torch.no_grad()
def import_encoders(path: str, params: torch.nn.Module, groups=ENCODER_GROUPS):
    """Copy the groups of an ``encoders.npz`` (either package's) into
    ``params`` in place, converted to each parameter's dtype → ``params``.
    Every leaf of the groups must be in the file with its shape; other
    keys of the file are ignored, as in the JAX package."""
    flat = load_arrays(path)
    for g in groups:
        for n, p in getattr(params, g).named_parameters():
            key = f"{g}/{n.replace('.', '/')}"
            if key not in flat:
                raise KeyError(f"{path} has no {key}")
            if tuple(flat[key].shape) != tuple(p.shape):
                raise ValueError(f"{key}: file shape {tuple(flat[key].shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(flat[key].to(p.dtype))
    return params
