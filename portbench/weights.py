"""Weights from the seed, on the device, in a few large draws.

The same function fills the program's module and the reference's dict, so
both start from the same values without either taking anything from the
other. Every ``kernel`` and ``table`` leaf is N(0, 0.02), in the order of
the reference's parameter list, drawn as chunks of 2**26 values, each
chunk from its own generator on the device seeded by (seed, chunk): a
chunk can be drawn again alone. Biases are 0, LayerNorm scales and the
copy head's ``beta`` 1.
"""

from __future__ import annotations

import math

import torch

from .reference.model import init_kind

CHUNK = 1 << 26
SCALE = 0.02


def _chunk_seed(seed: int, c: int) -> int:
    return (int(seed) * 1_000_003 + c) % (1 << 63)


def draw(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor} for ``specs`` [(name, shape)]."""
    normal = [(n, s) for n, s in specs if init_kind(n) == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for c, start in enumerate(range(0, total, CHUNK)):
        g = torch.Generator(device=device).manual_seed(_chunk_seed(seed, c))
        flat[start:start + CHUNK].normal_(0.0, 1.0, generator=g)
    flat.mul_(SCALE)
    out, at = {}, 0
    for name, shape in specs:
        kind = init_kind(name)
        if kind == "normal":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape)
            at += k
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return out


def fill_module(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the program's parameters, by name; the names
    and shapes have to agree exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = set(weights) - set(params), set(params) - set(weights)
        raise ValueError(f"parameter names differ: the program lacks {sorted(missing)[:5]}, "
                         f"the reference lacks {sorted(extra)[:5]}")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise ValueError(f"{n}: program {tuple(p.shape)}, reference "
                                 f"{tuple(weights[n].shape)}")
            p.copy_(weights[n])
