from .corpus import (  # noqa: F401
    aggregate_by_aid,
    build_mips_corpus,
    load_fixture,
    load_multi_x_science,
    strip_cites,
    synthetic_multi_x_science,
)
from .pipeline import RAGDataModule  # noqa: F401
from .tokenizer import HashTokenizer, load_tokenizer  # noqa: F401
