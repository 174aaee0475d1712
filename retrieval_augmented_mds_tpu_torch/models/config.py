"""Architecture configs for the model family.

Counterpart of ``retrieval_augmented_mds_tpu/models/config.py``: the same
dataclasses, fields, defaults and presets, owned by the port so it imports
nothing of the JAX package (a CPU test compares every preset field by
field). One encoder config and one seq2seq config parameterize the
LED-{base,large} generator and the Longformer / SPECTER2-class encoders.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Longformer-style long-context encoder."""

    vocab_size: int = 50265
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ffn: int = 3072
    max_len: int = 4096
    window: int = 256  # one-sided sliding window (block size)
    max_globals: int = 64  # static cap on global-attention tokens
    dropout: float = 0.1
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    pos_offset: int = 2  # RoBERTa/Longformer learned-position offset
    # SPECTER2-style bottleneck adapter width (Pfeiffer config: one
    # down→ReLU→up adapter after each FFN block, its own residual before
    # the block LayerNorm). 0 = no adapters. The reference attaches the
    # SPECTER2 adapter via the `adapters` library (sotasum/mips.py:108-113,
    # retriever_generator.py:88-93); here it is a first-class param group.
    adapter_dim: int = 0

    @staticmethod
    def longformer_base(**kw) -> "EncoderConfig":
        return EncoderConfig(**kw)

    @staticmethod
    def specter_base(**kw) -> "EncoderConfig":
        """SPECTER2-class query/index encoder: BERT-base shape + bottleneck
        adapter (reduction factor 16 → 48-d at H=768)."""
        d = dict(max_len=512, window=64, adapter_dim=48, pos_offset=0)
        d.update(kw)
        return EncoderConfig(**d)

    @staticmethod
    def longformer_large(**kw) -> "EncoderConfig":
        return EncoderConfig(
            d_model=1024, n_heads=16, n_layers=24, d_ffn=4096, **kw
        )

    @staticmethod
    def tiny(**kw) -> "EncoderConfig":
        d = dict(
            vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ffn=128,
            max_len=512, window=64, max_globals=8,
        )
        d.update(kw)
        return EncoderConfig(**d)


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """LED-style encoder-decoder (generator backbone).

    Reference: allenai/led-{base,large}-16384 wrapped at
    sotasum/retriever_generator.py:250-253.
    """

    vocab_size: int = 50266  # LED vocab + <DOC_SEP> special token
    d_model: int = 768
    n_heads: int = 12
    enc_layers: int = 6
    dec_layers: int = 6
    d_ffn: int = 3072
    max_src_len: int = 16384
    max_tgt_len: int = 1024
    window: int = 512
    max_globals: int = 64
    dropout: float = 0.1
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    doc_sep_id: int = 50265  # <DOC_SEP> added at retriever_generator.py:236-256

    @staticmethod
    def led_base(**kw) -> "Seq2SeqConfig":
        return Seq2SeqConfig(**kw)

    @staticmethod
    def led_large(**kw) -> "Seq2SeqConfig":
        return Seq2SeqConfig(
            d_model=1024, n_heads=16, enc_layers=12, dec_layers=12,
            d_ffn=4096, **kw
        )

    @staticmethod
    def tiny(**kw) -> "Seq2SeqConfig":
        d = dict(
            vocab_size=512, d_model=64, n_heads=2, enc_layers=2, dec_layers=2,
            d_ffn=128, max_src_len=512, max_tgt_len=64, window=64,
            max_globals=8, doc_sep_id=511,
        )
        d.update(kw)
        return Seq2SeqConfig(**d)
