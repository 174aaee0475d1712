"""The one traffic generator: Multi-XScience-shaped token arrays from a seed.

A workload file's ``traffic`` object holds the parameters; this module
reads them and nothing else. Multi-XScience (Lu et al., EMNLP 2020,
"Multi-XScience", Table 1): a source of about 778 words (the paper's
abstract and about 4.42 cited abstracts), a related-work target of about
116 words, 30,369 train and 5,093 test papers. Every document's length is
drawn on its own (log-normal with the stated mean), words are drawn from a
Zipf law over ``vocab_types`` types and tokenised by the port's hash
tokenizer at the model's vocabulary (one id per type), and the ids are laid
out as the port's data pipeline lays them out (``bos``, the words cut at
the width less two, ``eos``, padding), with the ``<DOC_SEP>`` id between
the documents of a source, where a subword tokenizer that knows the token
puts it.

The memory corpus is the set of distinct cited abstracts of the train
papers; each paper's own cited rows are its self-exclusion ids
(``mips_ignore``), as `prepare_rag_examples` derives them.
"""

from __future__ import annotations

import numpy as np

BOS, PAD, EOS = 0, 1, 2
MAX_IGNORE = 8  # `prepare_rag_examples`' width of mips_ignore


def type_ids(vocab_types: int, vocab_size: int) -> np.ndarray:
    """The hash tokenizer's id of each word type ``w<r>`` (FNV-1a, as the
    port's `HashTokenizer._tok`, copied here so the yardstick does not
    move with the program)."""
    out = np.empty(vocab_types, np.int32)
    for r in range(vocab_types):
        h = 2166136261
        for c in f"w{r}".encode():
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        out[r] = 4 + (h % (vocab_size - 5))
    return out


def lengths(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """``n`` document lengths in words: log-normal with mean ``spec["mean"]``
    and log-scale ``spec["sigma"]``, at least 1."""
    sigma = float(spec["sigma"])
    mu = np.log(float(spec["mean"])) - sigma * sigma / 2
    return np.maximum(1, np.rint(rng.lognormal(mu, sigma, n))).astype(np.int64)


def counts(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """Cited documents per paper: 1 + Poisson(mean - 1)."""
    return 1 + rng.poisson(float(spec["mean"]) - 1.0, n)


class Words:
    """Zipf-distributed word ids: P(rank r) proportional to r^-s over the
    types, each type mapped to its token id."""

    def __init__(self, rng, spec: dict, vocab_size: int):
        n = int(spec["vocab_types"])
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(spec["zipf_s"])
        self.cdf = np.cumsum(p / p.sum())
        self.ids = type_ids(n, vocab_size)
        self.rng = rng

    def draw(self, total: int) -> np.ndarray:
        r = np.searchsorted(self.cdf, self.rng.random(total), side="right")
        return self.ids[np.minimum(r, len(self.ids) - 1)]


def _docs(words: Words, lens: np.ndarray) -> list[np.ndarray]:
    if len(lens) == 0:
        return []
    flat = words.draw(int(lens.sum()))
    return np.split(flat, np.cumsum(lens)[:-1])


def _rows(docs: list[np.ndarray], width: int) -> tuple[np.ndarray, np.ndarray]:
    """``bos`` + words[: width - 2] + ``eos``, padded: (ids, mask) [N, width]."""
    ids = np.full((len(docs), width), PAD, np.int32)
    mask = np.zeros((len(docs), width), np.int32)
    for i, d in enumerate(docs):
        t = np.concatenate([[BOS], d[: width - 2], [EOS]])
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask


def _sources(abstracts, refs, cited_docs, width: int, doc_sep: int):
    ids = np.full((len(abstracts), width), PAD, np.int32)
    mask = np.zeros((len(abstracts), width), np.int32)
    sep = np.array([doc_sep], np.int32)
    for i, a in enumerate(abstracts):
        parts = [a]
        for r in refs[i]:
            parts += [sep, cited_docs[r]]
        body = np.concatenate(parts)[: width - 2]
        t = np.concatenate([[BOS], body, [EOS]])
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask


def _papers(rng, words, spec, n_papers, corpus_rows, offset):
    """``n_papers`` papers citing rows of a pool of ``corpus_rows`` cited
    abstracts (every row cited at least once when the slots allow) →
    (abstract docs, the cited row ids of each paper, target docs)."""
    n_cited = counts(rng, n_papers, spec["cited_per_paper"])
    slots = int(n_cited.sum())
    pick = np.concatenate([rng.permutation(corpus_rows)[:slots],
                           rng.integers(0, corpus_rows, max(0, slots - corpus_rows))])
    refs, at = [], 0
    for c in n_cited:
        refs.append(np.unique(pick[at: at + c]) + offset)
        at += c
    abstracts = _docs(words, lengths(rng, n_papers, spec["abstract_words"]))
    targets = _docs(words, lengths(rng, n_papers, spec["target_words"]))
    return abstracts, refs, targets


def generate(spec: dict, seed: int, *, vocab_size: int, doc_sep: int, widths: dict,
             parts: tuple = ("corpus", "train", "test")) -> dict:
    """The traffic of one run → {"corpus": {token_ids, token_mask} [N, L],
    "train" and "test": examples keyed as `prepare_rag_examples` keys
    them, "pairs": the retriever's pairs}, the ``parts`` asked for.
    ``widths``: source, query, target and memory widths in tokens."""
    rng = np.random.default_rng(seed)
    words = Words(rng, spec, vocab_size)
    n_train, n_test = (int(spec["papers"][k]) for k in ("train", "test"))
    mean_cited = float(spec["cited_per_paper"]["mean"])
    n_rows = {k: max(1, int(round(n * mean_cited * float(spec["cited_unique_share"]))))
              for k, n in (("train", n_train), ("test", n_test))}
    cited_len = lengths(rng, n_rows["train"] + n_rows["test"], spec["cited_words"])
    papers = {"train": _papers(rng, words, spec, n_train, n_rows["train"], 0),
              "test": _papers(rng, words, spec, n_test, n_rows["test"], n_rows["train"])}
    one = np.array([r[rng.integers(0, len(r))] for r in papers["train"][1]], np.int64)
    # the cited abstracts' words, drawn for the documents the parts read
    used = np.zeros(len(cited_len), bool)
    if "corpus" in parts:
        used[: n_rows["train"]] = True
    for split in ("train", "test"):
        if split in parts:
            for r in papers[split][1]:
                used[r] = True
    if "pairs" in parts:
        used[one] = True
    cited = dict(zip(np.flatnonzero(used), _docs(words, cited_len[used])))
    out = {"corpus_rows": n_rows["train"]}
    if "corpus" in parts:
        out["corpus"] = dict(zip(("token_ids", "token_mask"), _rows(
            [cited[j] for j in range(n_rows["train"])], widths["memory"])))
    for split in ("train", "test"):
        if split not in parts:
            continue
        abstracts, refs, targets = papers[split]
        n = len(abstracts)
        src, src_mask = _sources(abstracts, refs, cited, widths["source"], doc_sep)
        q, q_mask = _rows(abstracts, widths["query"])
        lab, _ = _rows(targets, widths["target"])
        tm, tm_mask = _rows(targets, widths["memory"])
        ignore = np.full((n, MAX_IGNORE), -1, np.int32)
        if split == "train":  # self-exclusion: the paper's own cited rows
            for i, r in enumerate(refs):
                ignore[i, : min(len(r), MAX_IGNORE)] = r[:MAX_IGNORE]
        out[split] = {
            "input_ids": src, "attention_mask": src_mask,
            "query_input_ids": q, "query_attention_mask": q_mask,
            "labels": lab, "mips_ignore": ignore,
            "aid_counts": np.ones(n, np.int32),
            "target_memory_ids": tm, "target_memory_mask": tm_mask,
        }
    if "pairs" in parts:
        # each train paper's abstract and one of its cited abstracts, drawn
        # as `prepare_pretrain_pairs` draws it
        q, q_mask = _rows(papers["train"][0], widths["query"])
        m, m_mask = _rows([cited[j] for j in one], widths["memory"])
        out["pairs"] = {"query_input_ids": q, "query_attention_mask": q_mask,
                        "mips_input_ids": m, "mips_attention_mask": m_mask}
    return out
