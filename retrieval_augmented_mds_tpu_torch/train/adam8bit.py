"""Blockwise 8-bit AdamW in one superleaf layout.

Counterpart of ``retrieval_augmented_mds_tpu/train/adam8bit.py``: Adam's
moments are kept in 8 bits per element, 128 elements to a block, every
trainable leaf's moments back to back in single ``[NB, 128]`` arrays:

* ``mu``: symmetric linear int8, ``q = round(mu / s)``, ``s = absmax / 127``
  per block (``mu_scale`` [NB, 1] f32);
* ``nu``: affine in log2, uint8, ``q = round(255 (log2 nu - lo) / (hi - lo))``
  with ``lo, hi`` per block (``nu_lo``, ``nu_hi`` [NB, 1] f32), the range
  clamped to 40 log2 units;
* ``nvalid`` [NB, 1] int32: the real elements of each block (128, a leaf's
  tail, or 0 for padding), so that padding steers no scale.

Each leaf owns a block-aligned range of rows, in the JAX package's
``tree_flatten`` order of the parameter tree (`jax_leaf_order`), so the
arrays equal the JAX package's row for row and checkpoints load in either
package. One update is one pass over the superarrays
(`ops.adam8bit_update.adam8bit_superleaf_update`: kernel K9 on the card,
its plain version on the CPU), with the semantics of ``optax.adamw``:
bias corrections as f32 powers at ``count + 1``, the schedule at the
pre-increment count, decoupled weight decay added before ``-lr``.
``grad_clip`` folds clip-by-global-norm into the update as the scale
``min(1, c / max(norm, 1e-30))`` over the blocked gradients (the JAX
package's formula, which is not the bf16-mu optimizer's clip).

State per parameter: 2 bytes of codes plus 16 bytes of columns per block
(~2.1 B), against 6 B for bf16 mu + f32 nu.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np
import torch
from torch import nn

from .optimizer import B1, B2, EPS, AdamW

BLOCK = 128  # elements per quantisation block
_LOG_RANGE = 40.0  # the widest log2(nu) spread kept in a block (~12 decades)
# log2 floor: a normal f32 (log2(0) = -inf would poison the block scales);
# sqrt(_TINY) = 1e-15 is far below Adam's eps
_TINY = 1e-30
_LOG_TINY = math.log2(_TINY)


def quantize_mu(mu: torch.Tensor, mask: torch.Tensor):
    """Symmetric linear int8 per block → (q int8, scale f32 [NB, 1])."""
    absmax = torch.where(mask, mu, 0.0).abs().amax(dim=1, keepdim=True)
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(mu / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_mu(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_nu(nu: torch.Tensor, mask: torch.Tensor):
    """Affine-in-log2 uint8 per block → (q uint8, lo, hi f32 [NB, 1])."""
    log = torch.log2(torch.clamp(nu, min=_TINY))
    log = torch.where(mask, log, _LOG_TINY)
    hi = torch.where(mask, log, -math.inf).amax(dim=1, keepdim=True)
    hi = torch.clamp(hi, min=_LOG_TINY)  # all-padding blocks exist
    lo = torch.where(mask, log, math.inf).amin(dim=1, keepdim=True)
    lo = torch.minimum(torch.maximum(lo, hi - _LOG_RANGE), hi)
    rng = torch.clamp(hi - lo, min=1e-6)
    q = torch.round(torch.clamp((log - lo) / rng, 0.0, 1.0) * 255.0)
    return q.to(torch.uint8), lo, hi


def dequantize_nu(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # exact zero comes back as _TINY, below eps^2
    rng = torch.clamp(hi - lo, min=1e-6)
    return torch.exp2(lo + q.float() / 255.0 * rng)


# ---------------------------------------------------------------------------
# the superleaf layout
# ---------------------------------------------------------------------------

def jax_leaf_order(names: Iterable[str]) -> list[str]:
    """Parameter paths (``led.encoder.10.ffn.w1.kernel``) in the order of
    ``jax.tree_util.tree_flatten`` over the JAX package's tree: dict keys
    sorted as strings, list items by index (so ``encoder.10`` comes after
    ``encoder.9``)."""
    def key(name: str):
        return tuple(int(c) if c.isdigit() else c for c in name.split("."))

    return sorted(names, key=key)


def _layout(sizes: Sequence[int], n_shards: int = 1):
    """Per-leaf sizes and block counts, and NB (a multiple of ``n_shards``)."""
    sizes = [int(n) for n in sizes]
    nbs = [-(-n // BLOCK) for n in sizes]
    nb_total = sum(nbs)
    nb_padded = -(-max(nb_total, 1) // n_shards) * n_shards
    return sizes, nbs, nb_total, nb_padded


def _nvalid_for(sizes, nbs, nb_padded) -> np.ndarray:
    """int32 [NB, 1]: 128 for full blocks, n % 128 for a leaf's tail, 0 for
    padding rows."""
    nv = np.zeros((nb_padded, 1), np.int32)
    off = 0
    for n, nb in zip(sizes, nbs):
        nv[off:off + nb] = BLOCK
        if n % BLOCK:
            nv[off + nb - 1] = n % BLOCK
        off += nb
    return nv


def _concat_blocks(leaves: Sequence[torch.Tensor], nb_padded: int) -> torch.Tensor:
    """Every leaf flattened, zero-padded to its block boundary and stacked
    into one [NB, 128] f32 array (one write of the superarray)."""
    out = torch.zeros((nb_padded, BLOCK), dtype=torch.float32, device=leaves[0].device)
    flat = out.view(-1)
    views, off = [], 0
    for x in leaves:
        views.append(flat[off:off + x.numel()].view(x.shape))
        off += -(-x.numel() // BLOCK) * BLOCK
    torch._foreach_copy_(views, list(leaves))
    return out


def _split_updates(upd: torch.Tensor, shapes: Sequence[torch.Size], nbs) -> list[torch.Tensor]:
    """The superleaf update cut back into leaf-shaped views (no copy)."""
    outs, off = [], 0
    for shape, nb in zip(shapes, nbs):
        n = math.prod(shape)
        outs.append(upd[off:off + nb].view(-1)[:n].view(shape))
        off += nb
    return outs


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Adam8bitState:
    """The 8-bit state in the JAX package's layout (`Adam8bitState` there),
    with the accumulation fields of `optimizer.OptState`."""

    count: int  # inner updates applied
    mu_q: torch.Tensor  # int8 [NB, 128]
    mu_scale: torch.Tensor  # f32 [NB, 1]
    nu_q: torch.Tensor  # uint8 [NB, 128]
    nu_lo: torch.Tensor  # f32 [NB, 1], log2 domain
    nu_hi: torch.Tensor  # f32 [NB, 1], log2 domain
    nvalid: torch.Tensor  # int32 [NB, 1]
    mini_step: int = 0
    acc: torch.Tensor | None = None


_ARRAYS = ("mu_q", "mu_scale", "nu_q", "nu_lo", "nu_hi", "nvalid")


def init_state(sizes: Sequence[int], device=None) -> Adam8bitState:
    """Zero moments for leaves of ``sizes`` (in superleaf order)."""
    sizes, nbs, _, nb = _layout(sizes)
    kw = dict(device=device)
    return Adam8bitState(
        count=0,
        mu_q=torch.zeros((nb, BLOCK), dtype=torch.int8, **kw),
        mu_scale=torch.zeros((nb, 1), dtype=torch.float32, **kw),
        nu_q=torch.zeros((nb, BLOCK), dtype=torch.uint8, **kw),
        nu_lo=torch.full((nb, 1), _LOG_TINY, dtype=torch.float32, **kw),
        nu_hi=torch.full((nb, 1), _LOG_TINY, dtype=torch.float32, **kw),
        nvalid=torch.from_numpy(_nvalid_for(sizes, nbs, nb)).to(device),
    )


class AdamW8bit(AdamW):
    """`AdamW` with the 8-bit superleaf state: the same schedule, frozen
    groups (no state, no update) and accumulation, the clip folded into
    the update. ``update`` adds to the parameters in place; the gradient
    superarray is overwritten by the update (each element is read before
    its update is written), so one step holds one [NB, 128] f32 array."""

    def __init__(self, lr, warmup_steps, total_steps, *, weight_decay=0.0,
                 grad_clip=None, frozen_groups: Iterable[str] = (),
                 accumulate_steps: int = 1):
        super().__init__(lr, warmup_steps, total_steps, weight_decay=weight_decay,
                         grad_clip=grad_clip, frozen_groups=frozen_groups,
                         accumulate_steps=accumulate_steps, mu_dtype=None)

    def _layout(self, params: nn.Module):
        names = [n for n, _ in params.named_parameters()]
        return names, jax_leaf_order(n for n in names if self.trainable(n))

    def init(self, params: nn.Module) -> Adam8bitState:
        names, train = self._layout(params)
        p = dict(params.named_parameters())
        dev = next(iter(p.values())).device
        state = init_state([p[n].numel() for n in train], dev)
        if self.accumulate_steps > 1:
            state.acc = torch.zeros(sum(p[n].numel() for n in names), device=dev)
        return state

    def _inner(self, params, train, grads, state):
        from ..ops.adam8bit_update import adam8bit_superleaf_update

        p = dict(params.named_parameters())
        leaves = [p[n] for n in train]
        _, nbs, _, nb = _layout([x.numel() for x in leaves])
        if nb != state.mu_q.shape[0]:
            raise ValueError(f"superleaf row count {nb} != state {state.mu_q.shape[0]} "
                             "(the parameters changed since init)")
        g2 = _concat_blocks(grads, nb)
        dev = g2.device
        if self.grad_clip:
            # padding is zero, so this is the tree's global norm
            norm = torch.linalg.vector_norm(g2)
            clip = torch.clamp(self.grad_clip / torch.clamp(norm, min=1e-30), max=1.0)
        else:
            clip = torch.ones((), device=dev)
        c = np.float32(state.count + 1)
        bc1 = np.float32(1) - np.float32(B1) ** c
        bc2 = np.float32(1) - np.float32(B2) ** c
        host = torch.tensor([bc1, bc2, self.schedule(state.count)], dtype=torch.float32)
        scal = torch.cat([host.to(dev), clip.reshape(1).float()]).reshape(1, 4)
        p2 = _concat_blocks(leaves, nb) if self.weight_decay else None
        upd, mq, ms, nq, nlo, nhi = adam8bit_superleaf_update(
            g2, state.mu_q, state.mu_scale, state.nu_q, state.nu_lo, state.nu_hi,
            state.nvalid, p2, scal, b1=B1, b2=B2, eps=EPS, wd=self.weight_decay, out=g2)
        torch._foreach_add_(leaves, _split_updates(upd, [x.shape for x in leaves], nbs))
        state.mu_q, state.mu_scale, state.nu_q = mq, ms, nq
        state.nu_lo, state.nu_hi = nlo, nhi
        state.count += 1

    # -- optax's state layout ------------------------------------------------

    def _adam_prefix(self) -> str:
        # the clip is part of the update: the chain holds one transformation
        return self._wrapper_prefix() + "0/"

    def _inner_arrays(self, params, train, state) -> dict:
        prefix = self._adam_prefix()
        out = {f"{prefix}.count": np.int32(state.count)}
        out.update({f"{prefix}.{k}": getattr(state, k) for k in _ARRAYS})
        return out

    def _load_inner(self, params, train, flat, state) -> None:
        prefix = self._adam_prefix()
        state.count = int(flat[f"{prefix}.count"])
        for k in _ARRAYS:
            ref = getattr(state, k)
            arr = flat[f"{prefix}.{k}"]
            x = torch.as_tensor(arr if isinstance(arr, torch.Tensor) else np.asarray(arr))
            if tuple(x.shape) != tuple(ref.shape) or x.dtype != ref.dtype:
                raise ValueError(f"{prefix}.{k}: {x.dtype} {tuple(x.shape)} in the "
                                 f"checkpoint, {ref.dtype} {tuple(ref.shape)} expected")
            setattr(state, k, x.to(ref.device))
