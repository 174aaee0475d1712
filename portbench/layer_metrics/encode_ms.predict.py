"""``rag_encode``'s wall time a batch (synchronised), mean over the
traced batches, ms."""


def read(run):
    enc = run.facts.get("encode_s")
    return 1000 * sum(enc) / len(enc) if enc else None
