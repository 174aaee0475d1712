"""BART-style dense encoder-decoder (the parametric-only baseline).

Counterpart of ``retrieval_augmented_mds_tpu/models/bart.py`` (the
reference's ``facebook/bart-large`` fine-tune, sotasum/bart_lightning.py:
48-244): the LED's block structure with a dense encoder (sources of at
most ~1k tokens) and BART's learned positions, offset by ``POS_OFFSET`` = 2
rows, so pretrained weights import exactly.

Teacher-forced passes (the encoder, and the decoder in training) run their
attention through `core.attention_train`, so on the card the encoder's
padded self-attention and the decoder's causal self- and cross-attention
are kernels K4/K5. The cached decoder uses the plain `core.attention`,
over the LED's caches (`led.init_decode_caches`, which also precomputes
the cross-attention heads).
"""

from __future__ import annotations

import torch
from torch import nn

from .config import Seq2SeqConfig
from .core import (
    FFN,
    MHA,
    Embedding,
    LayerNorm,
    attention,
    attention_train,
    build_module,
    causal_mask,
    embed,
    ffn,
    layernorm,
)

POS_OFFSET = 2  # BartLearnedPositionalEmbedding offset


class BartEncoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.attn = MHA(cfg.d_model)
        self.attn_ln = LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = LayerNorm(cfg.d_model)


class BartDecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.self_attn = MHA(cfg.d_model)
        self.self_ln = LayerNorm(cfg.d_model)
        self.cross_attn = MHA(cfg.d_model)
        self.cross_ln = LayerNorm(cfg.d_model)
        self.ffn = FFN(cfg.d_model, cfg.d_ffn)
        self.ffn_ln = LayerNorm(cfg.d_model)


class Bart(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.shared_emb = Embedding(cfg.vocab_size, cfg.d_model)
        self.enc_pos = Embedding(cfg.max_src_len + POS_OFFSET, cfg.d_model)
        self.dec_pos = Embedding(cfg.max_tgt_len + POS_OFFSET, cfg.d_model)
        self.enc_emb_ln = LayerNorm(cfg.d_model)
        self.dec_emb_ln = LayerNorm(cfg.d_model)
        self.encoder = nn.ModuleList(BartEncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(BartDecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.final_logits_bias = nn.Parameter(torch.empty(cfg.vocab_size))


def init_bart(cfg: Seq2SeqConfig, generator: torch.Generator, device=None) -> Bart:
    return build_module(lambda: Bart(cfg), generator, device)


def bart_encode(params: Bart, cfg: Seq2SeqConfig, ids, padding_mask) -> torch.Tensor:
    """Encoder states [B, S, H]: dense self-attention over the open keys."""
    s = ids.shape[1]
    pos = torch.arange(s, device=ids.device)[None, :] + POS_OFFSET
    x = layernorm(params.enc_emb_ln, embed(params.shared_emb, ids) + embed(params.enc_pos, pos))
    for lp in params.encoder:
        a = attention_train(lp.attn, x, x, cfg.n_heads, key_padding_mask=padding_mask)
        x = layernorm(lp.attn_ln, x + a)
        x = layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))
    return x


def bart_decode(params: Bart, cfg: Seq2SeqConfig, dec_ids, enc_hidden, enc_padding_mask, *,
                caches: list[dict] | None = None, pos_offset: int = 0):
    """Returns (hidden [B, T, H], caches). Without ``caches``: teacher-forced
    (causal self-attention and padded cross-attention through
    `attention_train`). With ``caches``: dec_ids is the new chunk, each
    cache appended in place; a cache holding ``ck``/``cv`` reuses those
    cross-attention heads."""
    t = dec_ids.shape[1]
    pos = torch.arange(t, device=dec_ids.device)[None, :] + pos_offset + POS_OFFSET
    x = layernorm(params.dec_emb_ln,
                  embed(params.shared_emb, dec_ids) + embed(params.dec_pos, pos))

    if caches is None:
        for lp in params.decoder:
            a = attention_train(lp.self_attn, x, x, cfg.n_heads, causal=True)
            x = layernorm(lp.self_ln, x + a)
            c = attention_train(lp.cross_attn, x, enc_hidden, cfg.n_heads,
                                key_padding_mask=enc_padding_mask)
            x = layernorm(lp.cross_ln, x + c)
            x = layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))
        return x, None

    cross_mask = (enc_padding_mask > 0)[:, None, None, :]
    for lp, cache in zip(params.decoder, caches):
        smask = causal_mask(t, cache["k"].shape[2], cache["pos"], x.device)
        a, _ = attention(lp.self_attn, x, x, cfg.n_heads, mask=smask, cache=cache)
        x = layernorm(lp.self_ln, x + a)
        ckv = (cache["ck"], cache["cv"]) if "ck" in cache else None
        c, _ = attention(lp.cross_attn, x, enc_hidden, cfg.n_heads, mask=cross_mask, kv=ckv)
        x = layernorm(lp.cross_ln, x + c)
        x = layernorm(lp.ffn_ln, x + ffn(lp.ffn, x))
    return x, caches


def bart_lm_logits(params: Bart, hidden: torch.Tensor) -> torch.Tensor:
    """Tied head: [B, T, H] → [B, T, V] f32, plus ``final_logits_bias``."""
    logits = torch.matmul(hidden, params.shared_emb.table.T)
    return logits + params.final_logits_bias[None, None, :]

