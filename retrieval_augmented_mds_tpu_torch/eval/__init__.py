from .rouge import RougeAccumulator, rouge_scores  # noqa: F401
