"""Transformer building blocks in PyTorch.

Counterpart of ``retrieval_augmented_mds_tpu/models/core.py``. Parameters
live in small `nn.Module`s whose attribute names mirror the JAX param
tree (``q.kernel``, ``attn_ln.scale``, ...); dense kernels keep the JAX
layout [d_in, d_out], so a JAX tree loads with no renames
(`retrieval_augmented_mds_tpu_torch.bridge`). The forward functions take
those modules the way the JAX functions take param dicts.

Conventions: activations [B, T, H]; params f32; matmuls run in the
caller's compute dtype with f32 accumulation; masks use the finite
NEG_INF = -1e9 (never -inf), so fully masked rows stay finite.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out))


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d))


class MHA(nn.Module):
    def __init__(self, d_model: int, d_kv: int | None = None):
        super().__init__()
        d_kv = d_kv or d_model
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_kv, d_model)
        self.v = Dense(d_kv, d_model)
        self.o = Dense(d_model, d_model)


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.w1 = Dense(d_model, d_ffn)
        self.w2 = Dense(d_ffn, d_model)


def build_module(make, generator: torch.Generator, device=None) -> nn.Module:
    """``make()`` constructed on ``device`` (default: the generator's) and
    initialised by `init_params_` from ``generator``."""
    device = torch.device(device if device is not None else generator.device)
    with torch.device(device):
        module = make()
    return init_params_(module, generator)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator,
                 scale: float = 0.02) -> nn.Module:
    """The reference init, in place: dense kernels and embedding tables
    ~ N(0, 1) · scale; every bias (``bias``, ``beta_bias``,
    ``final_logits_bias``) 0; LayerNorm ``scale`` and copy-head ``beta`` 1.
    Draws use ``generator``, which must live on the parameters' device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "table"):
            p.normal_(0.0, 1.0, generator=generator).mul_(scale)
        elif leaf.endswith("bias"):
            p.zero_()
        elif leaf in ("scale", "beta"):
            p.fill_(1.0)
        else:
            raise ValueError(f"no init rule for parameter {name!r}")
    return module


# ---------------------------------------------------------------------------
# forward primitives
# ---------------------------------------------------------------------------

class _MatmulF32Out(torch.autograd.Function):
    """x [..., d_in] @ w [d_in, d_out] of one low-precision dtype with an
    f32 result (one cuBLAS GEMM, f32 accumulation, no rounding to the
    inputs' dtype). The gradients come back in the inputs' dtype, each
    rounded once, as JAX's transposed dot products give them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g2 = gy.reshape(-1, gy.shape[-1]).to(x.dtype)
        dx = (g2 @ w.T).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).T @ g2
        return dx, dw


def dense(p: Dense, x: torch.Tensor, dtype: torch.dtype | None = None):
    """x @ kernel + bias in ``dtype`` (default x's), rounded once: the
    product is accumulated in f32, the f32 bias added, then one cast, as
    JAX's ``dot(..., preferred_element_type=f32) + bias`` does. Below f32
    the card takes a GEMM with an f32 result; the CPU multiplies the
    rounded operands in f32, where their products are exact."""
    dtype = dtype or x.dtype
    xd, wd = x.to(dtype), p.kernel.to(dtype)
    if dtype == torch.float32:
        y = torch.matmul(xd, wd)
    elif x.device.type == "cuda":
        y = _MatmulF32Out.apply(xd, wd)
    else:
        y = torch.matmul(xd.float(), wd.float())
    return (y + p.bias.float()).to(dtype)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def embed(p: Embedding, ids: torch.Tensor, dtype=torch.float32):
    return p.table[ids.long()].to(dtype)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, h = x.shape
    return x.reshape(b, t, n_heads, h // n_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, nh, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, nh * dh)


def _fold_groups(q: torch.Tensor, g: int) -> torch.Tensor:
    """[b·g, nh, t, dh] → [b, nh, g·t, dh]: beams fold into the query time
    axis, so attention reads un-expanded [b, ...] encoder/memory K/V."""
    bg, nh, t, dh = q.shape
    b = bg // g
    return q.reshape(b, g, nh, t, dh).permute(0, 2, 1, 3, 4).reshape(
        b, nh, g * t, dh
    )


def _unfold_groups(o: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of `_fold_groups`: [b, nh, g·t, dh] → [b·g, nh, t, dh]."""
    b, nh, gt, dh = o.shape
    t = gt // g
    return o.reshape(b, nh, g, t, dh).permute(0, 2, 1, 3, 4).reshape(
        b * g, nh, t, dh
    )


def _logits(q: torch.Tensor, k: torch.Tensor, dh: int) -> torch.Tensor:
    """q·kᵀ / sqrt(dh) in f32 (the operands' products are exact in f32)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)


def decode_key_mask(q, k, v, mask, bias) -> torch.Tensor | None:
    """The key mask [B or 1, S] of a cached call (cache or precomputed K/V)
    that `ops.flash_decode` takes on the card, or None. It takes CUDA tensors
    of one dtype, bf16 or f32, head dim 32, 64 or 128, no additive bias, and
    a bool mask that holds one value per key, [B or 1, 1, 1, S]: the cross
    mask, and the causal mask of a one-token step. Every other call, and
    every CPU call, keeps the plain path."""
    if (q.device.type != "cuda" or bias is not None or mask is None
            or mask.dtype != torch.bool or mask.dim() != 4):
        return None
    from ..ops.flash_decode import HEAD_DIMS

    if q.dtype not in (torch.bfloat16, torch.float32) or not k.dtype == v.dtype == q.dtype:
        return None
    b, s = k.shape[0], k.shape[2]
    if q.shape[-1] not in HEAD_DIMS or tuple(mask.shape[1:]) != (1, 1, s):
        return None
    if mask.shape[0] not in (1, b):
        return None
    return mask.reshape(mask.shape[0], s)


def attention(
    p: MHA,
    x_q: torch.Tensor,  # [B, Tq, H]
    x_kv: torch.Tensor,  # [B, Tk, Hkv]
    n_heads: int,
    *,
    mask: torch.Tensor | None = None,  # broadcastable to [B, 1|nh, Tq, Tk]
    bias: torch.Tensor | None = None,  # additive logits bias
    cache: dict | None = None,  # {"k","v" [B, nh, Tmax, dh], "pos": 0-d int64}
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,  # precomputed heads
):
    """Multi-head attention. With ``cache``, x_kv is the new chunk written
    into the cache at ``cache["pos"]`` (`cache_write`: the returned cache is
    the same dict, its ``k``/``v`` replaced and ``pos`` advanced). With
    ``kv``, the key/value heads are reused. When the q batch is a multiple
    of the kv batch (beams against un-expanded encoder K/V) the beams fold
    into the query axis. A cached call whose mask holds one value per key
    runs `ops.flash_decode` on the card (`decode_key_mask`), which reads K/V
    in place: no f32 copy, layout copy or logits tensor."""
    dh = p.q.kernel.shape[1] // n_heads
    q = _split_heads(dense(p.q, x_q), n_heads)
    if kv is not None:
        k, v = kv
    else:
        k = _split_heads(dense(p.k, x_kv), n_heads)
        v = _split_heads(dense(p.v, x_kv), n_heads)

    if cache is not None:
        k, v = cache_write(cache, k, v)
    if q.shape[0] % k.shape[0]:
        raise ValueError(f"q batch {q.shape[0]} not a multiple of {k.shape[0]}")

    key_mask = None
    if cache is not None or kv is not None:
        key_mask = decode_key_mask(q, k, v, mask, bias)
    if key_mask is not None:
        from ..ops.flash_decode import flash_decode_attention

        return dense(p.o, _merge_heads(flash_decode_attention(q, k, v, key_mask))), cache

    g = 1
    if k.shape[0] != q.shape[0]:
        g = q.shape[0] // k.shape[0]
        q = _fold_groups(q, g)

    logits = _logits(q, k.to(q.dtype), dh)
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x_q.dtype)
    out = torch.matmul(w, v.to(x_q.dtype))
    if g > 1:
        out = _unfold_groups(out, g)
    return dense(p.o, _merge_heads(out)), cache


def attention_train(
    p: MHA,
    x_q: torch.Tensor,  # [B, Tq, H]
    x_kv: torch.Tensor,  # [B, Tk, H]
    n_heads: int,
    *,
    key_padding_mask: torch.Tensor | None = None,  # [B, Tk] {0,1}
    causal: bool = False,
) -> torch.Tensor:
    """Training-time dense attention (no cache, no precomputed K/V, no beam
    fold) through `ops.flash_dense.dense_rows`: kernels K4/K5 on the card,
    which save only the row statistics for the backward, never a
    [B, nh, Tq, Tk] tensor."""
    from ..ops.flash_dense import dense_rows

    q = _split_heads(dense(p.q, x_q), n_heads)
    k = _split_heads(dense(p.k, x_kv), n_heads)
    v = _split_heads(dense(p.v, x_kv), n_heads)
    b, s = x_kv.shape[0], x_kv.shape[1]
    if key_padding_mask is None:
        kb = torch.zeros((b, s), dtype=torch.float32, device=x_q.device)
    else:
        kb = torch.where(key_padding_mask > 0,
                         torch.zeros((), dtype=torch.float32, device=x_q.device),
                         torch.full((), NEG_INF, dtype=torch.float32, device=x_q.device))
    out = dense_rows(q, k, v, kb, causal)
    return dense(p.o, _merge_heads(out))


# the products a selective policy can keep: the weight matmuls (aten mm and
# addmm, no batch dimension), and with them the batched ones (bmm, baddbmm)
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
                    torch.ops.aten.addmm.default)
_ALL_PRODUCTS = _WEIGHT_PRODUCTS + (torch.ops.aten.bmm.default, torch.ops.aten.bmm.dtype,
                                    torch.ops.aten.baddbmm.default)
# `jax.checkpoint_policies` names → what the port runs: "full" (recompute
# everything), None (recompute nothing: the plain layer, which saves what
# autograd saves), or the products a selective checkpoint keeps
REMAT_POLICIES = {
    "nothing_saveable": "full",
    "everything_saveable": None,
    "dots_saveable": _ALL_PRODUCTS,
    "checkpoint_dots": _ALL_PRODUCTS,
    "dots_with_no_batch_dims_saveable": _WEIGHT_PRODUCTS,
    "checkpoint_dots_with_no_batch_dims": _WEIGHT_PRODUCTS,
}
# names in `jax.checkpoint_policies` that make a policy from arguments; a
# config can only name one, and the JAX package's maybe_remat then passes
# the factory itself as the policy, which fails when the layer is traced
REMAT_FACTORIES = (
    "save_only_these_names", "save_anything_except_these_names",
    "save_any_names_but_these", "save_and_offload_only_these_names",
    "offload_dot_with_no_batch_dims", "save_from_both_policies",
)


def _save_products(keep, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of the ops in ``keep``,
    recompute the rest (the attention kernels, elementwise work)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(remat):
    """Validate ``train.remat`` → None (no checkpoint), "full", or the
    context function of a selective checkpoint. Raises on a name the port
    does not have, and on the names of policy factories."""
    if not remat:
        return None
    if remat is True or remat == "full":
        return "full"
    if remat in REMAT_FACTORIES:
        raise ValueError(
            f"train.remat={remat!r} names a factory of jax.checkpoint_policies, which "
            "makes a policy from arguments, not a policy: the JAX package accepts the "
            "name and then fails when the layer is traced; name a policy instead")
    if remat in REMAT_POLICIES:
        keep = REMAT_POLICIES[remat]
        if not isinstance(keep, tuple):
            return keep
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(create_selective_checkpoint_contexts,
                                 functools.partial(_save_products, keep))
    raise ValueError(
        f"train.remat={remat!r} is not supported by the port; choices: false, "
        f"true, 'full', {', '.join(repr(p) for p in REMAT_POLICIES)}")


def maybe_remat(fn, remat):
    """Per-layer gradient checkpointing (JAX ``maybe_remat``): ``fn`` as
    is when ``remat`` is off or "everything_saveable"; else a function that
    runs ``fn`` under ``torch.utils.checkpoint`` (non-reentrant), keeping
    only its inputs (True, "full", "nothing_saveable") or also the outputs
    of its products (`REMAT_POLICIES`) and recomputing the rest in the
    backward, the kernels' forwards included."""
    context = remat_context(remat)
    if context is None:
        return fn
    from torch.utils.checkpoint import checkpoint

    # the layers draw no random numbers: no RNG state to keep
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if context != "full":
        kw["context_fn"] = context

    def checkpointed(*args):
        return checkpoint(fn, *args, **kw)

    return checkpointed


def ffn(p: FFN, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return dense(p.w2, F.gelu(dense(p.w1, x), approximate="tanh"))


def make_cache(b: int, n_heads: int, dh: int, t_max: int, dtype,
               device=None) -> dict:
    """An empty self-attention cache; its position is a 0-d int64 tensor on
    the cache's device, so that a cached step reads it without a host sync
    and an exported step stays valid at every position."""
    return {
        "k": torch.zeros((b, n_heads, t_max, dh), dtype=dtype, device=device),
        "v": torch.zeros((b, n_heads, t_max, dh), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int64, device=device),
    }


def cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Write the new heads k/v [B, nh, t_new, dh] at ``cache["pos"]``:
    ``cache["k"]``/``["v"]`` become copies with those rows replaced
    (``index_copy`` at a tensor position, one code path for eager and
    exported steps) and ``pos`` advances by t_new → the full (k, v)."""
    pos = cache["pos"]
    rows = pos + torch.arange(k.shape[2], device=pos.device)
    cache["k"] = cache["k"].index_copy(2, rows, k.to(cache["k"].dtype))
    cache["v"] = cache["v"].index_copy(2, rows, v.to(cache["v"].dtype))
    cache["pos"] = pos + k.shape[2]
    return cache["k"], cache["v"]


def precompute_cross_kv(p: MHA, enc_hidden: torch.Tensor, n_heads: int):
    """One-time cross-attention K/V heads of the encoder states."""
    return (
        _split_heads(dense(p.k, enc_hidden), n_heads),
        _split_heads(dense(p.v, enc_hidden), n_heads),
    )


def causal_mask(t_q: int, t_k: int, offset, device=None) -> torch.Tensor:
    """[1, 1, Tq, Tk] causal mask where query i sits at position offset+i
    (``offset`` an int or a 0-d tensor on ``device``)."""
    qi = torch.arange(t_q, device=device)[:, None] + offset
    ki = torch.arange(t_k, device=device)[None, :]
    return (ki <= qi)[None, None]
