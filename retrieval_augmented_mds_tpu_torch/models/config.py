"""Architecture configs: the JAX package's dataclasses, re-exported.

``retrieval_augmented_mds_tpu/models/config.py`` is plain dataclasses with
no JAX import, so both packages share one definition of every preset.
"""

from retrieval_augmented_mds_tpu.models.config import (  # noqa: F401
    EncoderConfig,
    Seq2SeqConfig,
)
