"""Retriever validation against the whole encoded knowledge base.

Counterpart of ``retrieval_augmented_mds_tpu/retriever/validate.py``:
encode the entire corpus with the index-side encoder, index it (an f32
flat index, searched by the MIPS kernel K1 on the card; with ``metric
"l2"`` the corpus is φ-augmented by one column first, so D grows by one),
encode the queries, take the top-k of each, and score the hit matrix
against each query's gold aid with `retriever_metrics_fixed`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.augment import augment_corpus, augment_queries
from ..index.flat import build_flat_index, search
from ..models.core import dense
from ..models.longformer import longformer_encode
from .metrics import hits_from_aids, retriever_metrics_fixed


@torch.no_grad()
def encode_texts(params, cfg, ids, mask, batch_size: int = 64, dtype=torch.float32,
                 proj=None) -> torch.Tensor:
    """CLS embeddings [N, H] (or the pooled projection ``proj`` of them) in
    f32, on the encoder's device. Every batch holds ``batch_size`` rows:
    the last is padded with copies of row 0 and cut back, as in the JAX
    package, so every call runs one shape."""
    dev = next(params.parameters()).device
    ids, mask = torch.as_tensor(ids).to(dev), torch.as_tensor(mask).to(dev)
    n = ids.shape[0]
    pad = (-n) % batch_size
    if pad:
        ids = torch.cat([ids, ids[:1].expand(pad, -1)])
        mask = torch.cat([mask, mask[:1].expand(pad, -1)])
    outs = []
    for i in range(0, ids.shape[0], batch_size):
        cls = longformer_encode(params, cfg, ids[i:i + batch_size], mask[i:i + batch_size],
                                dtype=dtype)[:, 0].float()
        outs.append(dense(proj, cls) if proj is not None else cls)
    return torch.cat(outs)[:n]


def validate_retriever(params, query_cfg, mips_cfg, corpus_tokens: dict, corpus_row_aids,
                       queries: dict, gold_aid, gold_counts, *, k: int = 10,
                       metric: str = "ip", batch_size: int = 64,
                       return_details: bool = False):
    """Metrics of the retriever ``params`` (a `Retriever`) over the corpus
    ``corpus_tokens`` (``token_ids`` / ``token_mask`` [N, L]) whose rows list
    the aids ``corpus_row_aids`` [N, A] (-1 padding), for the queries
    ``queries`` (``query_input_ids`` / ``query_attention_mask`` [Q, L]) with
    gold aids ``gold_aid`` [Q] and gold set sizes ``gold_counts`` [Q].
    Returns {recall, reciprocal_rank, average_precision} as floats; with
    ``return_details`` also the ranking as numpy arrays: ``indices`` and
    ``scores`` [Q, k] and the hit matrix ``hits``."""
    kb = encode_texts(params.mips_encoder, mips_cfg, corpus_tokens["token_ids"],
                      corpus_tokens["token_mask"], batch_size,
                      proj=getattr(params, "mips_proj", None))
    q = encode_texts(params.query_encoder, query_cfg, queries["query_input_ids"],
                     queries["query_attention_mask"], batch_size,
                     proj=getattr(params, "query_proj", None))
    if metric == "l2":
        # φ-augmentation: L2 search over [x, sqrt(φ - |x|²)] ranks as MIPS over x
        kb, _ = augment_corpus(kb)
        q = augment_queries(q)
    index = build_flat_index(kb, metric=metric, dtype=torch.float32)
    scores, idx = search(index, q, k=k)
    idx, scores = idx.cpu().numpy(), scores.cpu().numpy()
    aids = torch.from_numpy(np.asarray(corpus_row_aids)[np.maximum(idx, 0)])  # [Q, k, A]
    hits = hits_from_aids(aids, torch.from_numpy(np.asarray(gold_aid)))
    m = retriever_metrics_fixed(hits, torch.from_numpy(np.asarray(gold_counts)))
    out = {key: float(v) for key, v in m.items()}
    if return_details:
        return out, {"indices": idx, "scores": scores, "hits": hits.numpy()}
    return out
