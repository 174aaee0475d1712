"""AdamW with linear warmup and decay, global-norm clipping, frozen
parameter groups and gradient accumulation.

Counterpart of ``retrieval_augmented_mds_tpu/train/optimizer.py``, whose
``build_optimizer`` chains optax's ``clip_by_global_norm`` and ``adamw``
(with a bf16 first moment by default), wraps them in ``multi_transform``
for frozen groups and in ``MultiSteps`` for accumulation. This module does
the same arithmetic, element for element, in the same order:

* the clip's global norm covers only the trainable leaves (the frozen
  groups are hidden from it), and a norm at or above ``grad_clip`` scales
  the gradients by ``grad_clip / norm``;
* ``mu = (1 - b1) g + b1 mu`` in f32, with ``b1`` rounded to ``mu``'s
  dtype (bf16 by default) as in the reference's jitted update, and ``mu``
  stored in that dtype afterwards;
  ``nu`` is f32; both are bias-corrected; the update
  ``mu_hat / (sqrt(nu_hat) + eps) + weight_decay p`` is scaled by
  ``-schedule(count)``, so the first update uses ``schedule(0) = 0``;
* frozen groups get no optimizer state, no decay and no update;
* with ``accumulate_steps`` k > 1 the gradients are averaged (a running
  mean) and the inner update runs on every k-th call only.

It does not use ``torch.nn.utils.clip_grad_norm_`` (which adds 1e-6 to
the norm) or ``torch.optim.AdamW`` (which has no bf16 first moment).
The parameters are updated IN PLACE. The state keeps ``mu`` and ``nu``
flat over the trainable parameters, so one step is a few passes over
flat buffers, and converts to and from optax's state layout
(`state_arrays`, `load_state_arrays`) for checkpoints that either package
can read. ``build_optimizer(state_8bit=True)`` returns `AdamW8bit`
(``train/adam8bit.py``), which keeps this class's schedule, frozen groups
and accumulation and replaces the moments and the inner update.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """HF get_linear_schedule_with_warmup, in f32 like the reference's."""
    warmup_steps = max(1, warmup_steps)

    def sched(step: int) -> np.float32:
        s = np.float32(step)
        if s < warmup_steps:
            frac = s / np.float32(warmup_steps)
        else:
            frac = np.maximum(np.float32(0.0), (np.float32(total_steps) - s)
                              / np.float32(max(1, total_steps - warmup_steps)))
        return np.float32(np.float32(lr) * frac)

    return sched


def param_group(name: str) -> str:
    """The top-level group of a parameter path (``led``, ``query_encoder``,
    ``mips_encoder``, ``memory_encoder``, ``copy_head``)."""
    return name.split(".", 1)[0]


@dataclasses.dataclass
class OptState:
    count: int  # inner updates applied (optax's adam and schedule counts)
    mu: torch.Tensor  # [n_trainable] in mu_dtype
    nu: torch.Tensor  # [n_trainable] f32
    mini_step: int = 0  # MultiSteps position in the accumulation window
    acc: torch.Tensor | None = None  # [n_all] f32 running-mean gradients


class AdamW:
    """The optimizer of `build_optimizer`; `update` applies one step."""

    def __init__(self, lr, warmup_steps, total_steps, *, weight_decay=0.0,
                 grad_clip=None, frozen_groups: Iterable[str] = (),
                 accumulate_steps: int = 1, mu_dtype: str | None = "bfloat16"):
        self.schedule = linear_warmup_schedule(lr, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.frozen = frozenset(frozen_groups)
        self.accumulate_steps = accumulate_steps
        self.mu_dtype = getattr(torch, mu_dtype) if mu_dtype else torch.float32

    def trainable(self, name: str) -> bool:
        return param_group(name) not in self.frozen

    def _layout(self, params: nn.Module):
        names = [n for n, _ in params.named_parameters()]
        return names, [n for n in names if self.trainable(n)]

    def init(self, params: nn.Module) -> OptState:
        names, train = self._layout(params)
        p = dict(params.named_parameters())
        dev = next(iter(p.values())).device
        n_train = sum(p[n].numel() for n in train)
        return OptState(
            count=0,
            mu=torch.zeros(n_train, dtype=self.mu_dtype, device=dev),
            nu=torch.zeros(n_train, dtype=torch.float32, device=dev),
            acc=(torch.zeros(sum(p[n].numel() for n in names), device=dev)
                 if self.accumulate_steps > 1 else None),
        )

    @torch.no_grad()
    def update(self, params: nn.Module, grads: dict[str, torch.Tensor],
               state: OptState) -> OptState:
        """One step: ``grads`` maps every parameter path to its gradient
        (f32, the parameter's shape). Updates ``params`` and ``state`` in
        place and returns ``state``."""
        names, train = self._layout(params)
        if self.accumulate_steps <= 1:
            self._inner(params, train, [grads[n] for n in train], state)
            return state
        flat = torch.cat([grads[n].reshape(-1).float() for n in names])
        state.acc += (flat - state.acc) / (state.mini_step + 1)
        emit = state.mini_step == self.accumulate_steps - 1
        state.mini_step = (state.mini_step + 1) % self.accumulate_steps
        if emit:
            offs = _offsets(params, names)
            self._inner(params, train, [state.acc[slice(*offs[n])] for n in train], state)
            state.acc.zero_()
        return state

    def _inner(self, params, train, grads, state):
        """One inner update from ``grads``, the trainable leaves' gradients
        (in ``train`` order)."""
        g = torch.cat([x.reshape(-1).float() for x in grads])
        if self.grad_clip:
            norm = torch.sqrt((g * g).sum())
            g = torch.where(norm < self.grad_clip, g, g / norm * self.grad_clip)
        # as the reference's jitted update computes it: b1 rounded to mu's
        # dtype (JAX's weak typing), b1 * mu in f32 (XLA keeps the excess
        # precision and does not round the product)
        b1 = float(torch.tensor(B1, dtype=self.mu_dtype))
        mu = g * (1 - B1) + state.mu.float() * b1
        nu = (g * g) * (1 - B2) + state.nu * B2
        count = state.count + 1
        bc1 = np.float32(1) - np.float32(B1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(B2) ** np.float32(count)
        u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + EPS)
        p = dict(params.named_parameters())
        if self.weight_decay:
            u = u + self.weight_decay * torch.cat([p[n].reshape(-1) for n in train])
        u = u * float(-self.schedule(state.count))
        views, off = [], 0
        for n in train:
            views.append(u[off:off + p[n].numel()].view_as(p[n]))
            off += p[n].numel()
        torch._foreach_add_([p[n] for n in train], views)
        state.mu, state.nu, state.count = mu.to(self.mu_dtype), nu, count

    # -- optax's state layout, for checkpoints ------------------------------

    def _wrapper_prefix(self) -> str:
        """Key prefix of the optimizer chain's state in optax's state tree
        (under ``MultiSteps`` and ``multi_transform`` where they apply)."""
        prefix = ".opt_state/"
        if self.accumulate_steps > 1:
            prefix += ".inner_opt_state/"
        if self.frozen:
            prefix += ".inner_states/train/.inner_state/"
        return prefix

    def _adam_prefix(self) -> str:
        """Key prefix of the adamw chain (after the clip, when there is one)."""
        return self._wrapper_prefix() + ("1/" if self.grad_clip else "0/")

    def _inner_arrays(self, params, train, state) -> dict:
        chain = self._adam_prefix()
        count = np.int32(state.count)
        out = {f"{chain}0/.count": count, f"{chain}2/.count": count}
        offs = _offsets(params, train)
        shapes = dict((n, tuple(x.shape)) for n, x in params.named_parameters())
        for n in train:
            a, b = offs[n]
            path = n.replace(".", "/")
            out[f"{chain}0/.mu/{path}"] = state.mu[a:b].reshape(shapes[n])
            out[f"{chain}0/.nu/{path}"] = state.nu[a:b].reshape(shapes[n])
        return out

    def _load_inner(self, params, train, flat, state) -> None:
        chain = self._adam_prefix()
        state.count = int(flat[f"{chain}0/.count"])
        state.mu = _cat(flat, chain + "0/.mu/{}", train, state.nu.device).to(self.mu_dtype)
        state.nu = _cat(flat, chain + "0/.nu/{}", train, state.nu.device)

    def state_arrays(self, params: nn.Module, state) -> dict[str, np.ndarray]:
        """``state`` as optax's flattened key paths (``/``-joined) → arrays."""
        names, train = self._layout(params)
        out = self._inner_arrays(params, train, state)
        if state.acc is not None:
            out[".opt_state/.mini_step"] = np.int32(state.mini_step)
            out[".opt_state/.gradient_step"] = np.int32(state.count)
            shapes = dict((n, tuple(x.shape)) for n, x in params.named_parameters())
            offs_all = _offsets(params, names)
            for n in names:
                a, b = offs_all[n]
                out[f".opt_state/.acc_grads/{n.replace('.', '/')}"] = \
                    state.acc[a:b].reshape(shapes[n])
        return out

    def load_state_arrays(self, params: nn.Module, flat: dict):
        """The inverse of `state_arrays` (arrays may be numpy or torch)."""
        names, train = self._layout(params)
        state = self.init(params)
        self._load_inner(params, train, flat, state)
        if state.acc is not None:
            state.mini_step = int(flat[".opt_state/.mini_step"])
            state.acc = _cat(flat, ".opt_state/.acc_grads/{}", names, state.acc.device)
        return state


def _cat(flat: dict, key: str, names, device) -> torch.Tensor:
    """The leaves ``key.format(path)`` of ``names``, flattened and joined
    as one f32 tensor on ``device``."""
    def t(x):
        return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x))

    return torch.cat([t(flat[key.format(n.replace(".", "/"))]).reshape(-1).float()
                      for n in names]).to(device)


def _offsets(params: nn.Module, names: list[str]) -> dict[str, tuple[int, int]]:
    p = dict(params.named_parameters())
    out, off = {}, 0
    for n in names:
        out[n] = (off, off + p[n].numel())
        off += p[n].numel()
    return out


def build_optimizer(
    lr: float,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    weight_decay: float = 0.0,
    grad_clip: float | None = None,
    frozen_groups: Iterable[str] = (),
    accumulate_steps: int = 1,
    mu_dtype: str | None = "bfloat16",
    state_8bit: bool = False,
) -> AdamW:
    """The reference's `build_optimizer` knobs. ``state_8bit`` returns the
    blockwise 8-bit AdamW of `train.adam8bit` (``mu_dtype`` is then
    unused), whose update is kernel K9 on the card."""
    kw = dict(weight_decay=weight_decay, grad_clip=grad_clip,
              frozen_groups=frozen_groups, accumulate_steps=accumulate_steps)
    if state_8bit:
        from .adam8bit import AdamW8bit

        return AdamW8bit(lr, warmup_steps, total_steps, **kw)
    return AdamW(lr, warmup_steps, total_steps, mu_dtype=mu_dtype, **kw)
