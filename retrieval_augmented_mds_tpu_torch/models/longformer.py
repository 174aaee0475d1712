"""Longformer-style long-context encoder.

Counterpart of ``retrieval_augmented_mds_tpu/models/longformer.py``:
RoBERTa-style post-LN blocks with sliding/global attention, optional
SPECTER2 (Pfeiffer) bottleneck adapters, and CLS pooling; with
``seq_mesh``, the sequence split over the mesh's ``shard`` axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sliding_attention import SlidingAttention, attention_fn, gather_seq, seq_block
from .config import EncoderConfig
from .core import (
    FFN,
    Dense,
    Embedding,
    LayerNorm,
    build_module,
    dense,
    embed,
    ffn,
    layernorm,
    maybe_remat,
)


class Adapter(nn.Module):
    def __init__(self, d_model: int, d_adapter: int):
        super().__init__()
        self.down = Dense(d_model, d_adapter)
        self.up = Dense(d_adapter, d_model)


class LongformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attn = SlidingAttention(cfg.d_model)
        self.attn_ln = LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = LayerNorm(cfg.d_model)
        if cfg.adapter_dim:
            self.adapter = Adapter(cfg.d_model, cfg.adapter_dim)


class Longformer(nn.Module):
    """``type_emb``: hold the one token-type row that an imported HF
    checkpoint brings (`models.hf_import`); a fresh init has none."""

    def __init__(self, cfg: EncoderConfig, type_emb: bool = False):
        super().__init__()
        self.tok_emb = Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = Embedding(cfg.max_len + cfg.pos_offset, cfg.d_model)
        if type_emb:
            self.type_emb = Embedding(1, cfg.d_model)
        self.emb_ln = LayerNorm(cfg.d_model)
        self.layers = nn.ModuleList(LongformerLayer(cfg) for _ in range(cfg.n_layers))


def init_longformer(cfg: EncoderConfig, generator: torch.Generator,
                    device=None) -> Longformer:
    return build_module(lambda: Longformer(cfg), generator, device)


def longformer_encode(
    params: Longformer,
    cfg: EncoderConfig,
    ids: torch.Tensor,  # [B, T] (T multiple of the window; pad with pad_id)
    padding_mask: torch.Tensor,  # [B, T] {0,1}
    global_mask: torch.Tensor | None = None,  # [B, T]; default: CLS only
    *,
    dtype=torch.float32,
    remat: bool | str = False,
    seq_mesh=None,
) -> torch.Tensor:
    """Hidden states [B, T, H]; CLS pooling = out[:, 0]. ``remat``
    checkpoints each layer (`core.maybe_remat`). With ``seq_mesh``, each
    rank encodes its block of T / shards tokens and the blocks are
    gathered at the end (as `led.led_encode`)."""
    b, t = ids.shape
    if global_mask is None:
        # global attention on <s>
        global_mask = torch.zeros_like(padding_mask)
        global_mask[:, 0] = 1
    global_mask = global_mask * padding_mask

    pos = torch.arange(t, device=ids.device)[None, :] + cfg.pos_offset
    blk = seq_block(t, seq_mesh)
    x = embed(params.tok_emb, ids[:, blk], dtype) + embed(params.pos_emb, pos[:, blk], dtype)
    if hasattr(params, "type_emb"):
        # the single token-type row: a constant on every position
        x = x + params.type_emb.table[0].to(dtype)
    x = layernorm(params.emb_ln, x)

    attn = attention_fn(seq_mesh)

    def layer_fn(x, lp):
        a = attn(lp.attn, x, cfg.n_heads, cfg.window, global_mask, padding_mask,
                 cfg.max_globals)
        x = layernorm(lp.attn_ln, x + a)
        f = ffn(lp.ffn, x)
        if hasattr(lp, "adapter"):
            # adapter residual sits BEFORE the block LayerNorm
            f = f + dense(lp.adapter.up, F.relu(dense(lp.adapter.down, f)))
        return layernorm(lp.ffn_ln, x + f)

    layer_fn = maybe_remat(layer_fn, remat)
    for lp in params.layers:
        x = layer_fn(x, lp)
    return gather_seq(x, seq_mesh)


def cls_pool(hidden: torch.Tensor, proj: nn.Module | None = None) -> torch.Tensor:
    """CLS pooling; ``proj`` holds a ``proj`` Dense (the tree of the JAX
    package's ``init_projection``)."""
    out = hidden[:, 0]
    if proj is not None:
        out = dense(proj.proj, out)
    return out
