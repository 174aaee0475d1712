from .config import EncoderConfig, Seq2SeqConfig  # noqa: F401
