"""Corpus construction for Multi-XScience / arXiv.

Counterpart of ``retrieval_augmented_mds_tpu/data/corpus.py``, owned by
the port (pure pandas, no JAX). It ports the host-side corpus semantics of
sotasum/data_loaders.py:24-191:

  * `load_multi_x_science` — HF dataset + a running global `index` column
    (data_loaders.py:24-36),
  * `build_mips_corpus` — the MIPS corpus builder: for `ref_abstract`,
    explode every cited abstract, drop empties, dedup by text, and
    aggregate the `index`/`aid` lists per unique abstract
    (data_loaders.py:39-95); for `related_work`, strip `@cite_N` → "cite"
    (data_loaders.py:84-93),
  * `aggregate_by_aid` — groupby-aid merge used by the aggregated dataset
    (data_loaders.py:378-425, data_modules.py:192-215),
  * arXiv corpus loaders with `@math` substitution + dedup
    (data_loaders.py:98-157).

The committed fixtures are data, read by path from the JAX package's
``data/fixtures/`` directory (`FIXTURE_DIR`); nothing there is imported.
For offline development and tests, `synthetic_multi_x_science` generates
schema-compatible records.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pandas as pd

CITE_RE = re.compile(r"\@cite_\d+")
FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "retrieval_augmented_mds_tpu", "data", "fixtures",
)


def strip_cites(text: str) -> str:
    """`@cite_12` → "cite" (data_loaders.py:84-93, :275)."""
    return CITE_RE.sub("cite", text)


def load_multi_x_science(path: str = "multi_x_science_sum", cache_dir=None):
    """HF dataset dict with a global running `index` column."""
    import datasets

    data = datasets.load_dataset(path, cache_dir=cache_dir)
    counter = iter(range(sum(len(v) for v in data.values())))
    return data.map(lambda x: {"index": next(counter)})


def load_fixture(path: str | None = None) -> pd.DataFrame:
    """Committed real-schema Multi-XScience fixture (200 examples,
    tools/make_fixture.py) — the offline stand-in for the HF dataset:
    same columns (aid/mid/abstract/related_work/ref_abstract{cite_N, mid,
    abstract}), shared reference pool, empty ref abstracts, @cite_N/@math
    markers. Any .json/.json.gz of such records also loads through here."""
    import gzip
    import json

    if path is None:
        path = os.path.join(FIXTURE_DIR, "multi_x_science_200.json.gz")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        records = json.load(f)
    df = pd.DataFrame(records)
    df["index"] = np.arange(len(df))
    return df


def synthetic_multi_x_science(
    n: int = 64, n_refs: int = 3, seed: int = 0
) -> pd.DataFrame:
    """Schema-compatible synthetic records (offline dev/test corpus)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(200)]

    def sent(k=12):
        return " ".join(rng.choice(words, k))

    rows = []
    for i in range(n):
        refs = rng.integers(1, n_refs + 1)
        ref_aids = [f"a{rng.integers(0, n)}" for _ in range(refs)]
        rows.append(
            {
                "aid": f"a{i}",
                "mid": f"m{i}",
                "abstract": sent(20),
                "related_work": f"@cite_{i % 7} " + sent(18),
                "ref_abstract": {
                    "cite_N": [f"@cite_{j}" for j in range(refs)],
                    "abstract": [
                        sent(15) if rng.random() > 0.1 else "" for _ in range(refs)
                    ],
                    "aid": ref_aids,
                },
                "index": i,
            }
        )
    return pd.DataFrame(rows)


def build_mips_corpus(df: pd.DataFrame, column: str = "ref_abstract") -> pd.DataFrame:
    """MIPS corpus with `mips_column` text + aggregated id lists.

    Returns columns: mips_column (unique text), index (list), aid (list).
    """
    if column == "ref_abstract":
        ex = df.copy()
        ex["ref_abstract_abstract"] = ex["ref_abstract"].apply(
            lambda r: list(r["abstract"])
        )
        ex["ref_aid"] = ex["ref_abstract"].apply(
            lambda r: list(r.get("aid", [""] * len(r["abstract"])))
        )
        ex = ex.explode(["ref_abstract_abstract", "ref_aid"])
        ex = ex[ex["ref_abstract_abstract"] != ""].reset_index(drop=True)
        out = (
            ex.groupby("ref_abstract_abstract")
            .agg(index=("index", list), aid=("aid", list),
                 ref_aid=("ref_aid", list))
            .reset_index()
            .rename(columns={"ref_abstract_abstract": "mips_column"})
        )
        return out
    if column == "related_work":
        out = df.copy()
        out["mips_column"] = out["related_work"].map(strip_cites)
        out["index"] = out["index"].apply(lambda i: [i])
        out["aid"] = out["aid"].apply(lambda a: [a])
        return out[["mips_column", "index", "aid"]]
    raise ValueError(f"unknown corpus column {column!r}")


def aggregate_by_aid(df: pd.DataFrame) -> pd.DataFrame:
    """Groupby-aid merge (reference data_modules.py:192-215 /
    data_loaders.py:378-425): one row per target paper, ref abstracts
    concatenated, related-work sections joined."""
    def merge_refs(series):
        keys = series.iloc[0].keys()
        return {
            k: [j for r in series for j in r[k] if bool(j)] for k in keys
        }

    out = df.groupby("aid", as_index=False).agg(
        mid=("mid", "first"),
        abstract=("abstract", "first"),
        ref_abstract=("ref_abstract", merge_refs),
        related_work=("related_work", " ".join),
    )
    out["index"] = np.arange(len(out))
    return out


def load_mips_arxiv(df: pd.DataFrame) -> pd.DataFrame:
    """arXiv sentence-list corpus (reference `load_mips_arxiv`,
    data_loaders.py:98-125): join each `abstract_text` sentence list,
    strip the `<S>`/`</S>` tags, collapse whitespace; `article_id`
    becomes the aid. No @math substitution and no dedup — those belong
    to `load_mips_arxiv2` (:129-157), a different corpus format.

    Returns the repo corpus schema: mips_column, index (EMPTY lists —
    arXiv rows belong to no training example, so self-exclusion never
    masks them), aid (article_id as a 1-element list)."""

    def join_clean(sents) -> str:
        text = " ".join(sents).replace("<S>", "").replace("</S>", "")
        return re.sub(r"\s{2,}", " ", text).strip()

    aid_col = "article_id" if "article_id" in df else "aid"
    aids = (
        df[aid_col].map(lambda a: [str(a)])
        if aid_col in df
        else [[] for _ in range(len(df))]
    )
    return pd.DataFrame(
        {
            "mips_column": df["abstract_text"].map(join_clean),
            "index": [[] for _ in range(len(df))],
            "aid": aids,
        }
    )


# inline/display math → "@math" (reference clean_arxiv,
# data_loaders.py:132-140)
ARXIV_MATH_RE = re.compile(r"\$+(.*?)\$+|\\\[(.*?)\\\]")


def clean_arxiv_text(text: str) -> str:
    """arXiv abstract cleaning (data_loaders.py:132-140): newlines →
    spaces, `$...$` / `\\[...\\]` math → "@math", collapse whitespace."""
    text = text.replace("\n", " ").strip()
    text = ARXIV_MATH_RE.sub("@math", text)
    text = re.sub(r"\s{2,}", " ", text)
    return text


def load_mips_arxiv2(source: str | pd.DataFrame) -> pd.DataFrame:
    """arXiv parquet corpus (reference `load_mips_arxiv2`,
    data_loaders.py:129-157): read parquet, clean each abstract
    (@math substitution), take `__index_level_0__` as the article id,
    dedup by cleaned text.

    Returns the repo corpus schema: mips_column (unique text),
    index (example-index lists — EMPTY for arXiv rows, which belong to no
    training example, so self-exclusion never masks them), aid (id list).
    """
    df = pd.read_parquet(source) if isinstance(source, str) else source.copy()
    if "aid" not in df:
        if "__index_level_0__" in df:
            df["aid"] = df["__index_level_0__"]
        else:
            df["aid"] = df.index
    df["mips_column"] = df["abstract"].map(clean_arxiv_text)
    df = df.drop_duplicates("mips_column").reset_index(drop=True)
    return pd.DataFrame(
        {
            "mips_column": df["mips_column"],
            "index": [[] for _ in range(len(df))],
            # str-coerced so arXiv ids (ints from the pandas index) sort
            # alongside Multi-XScience's string aids in the aid vocab
            "aid": df["aid"].map(lambda a: [str(a)]),
        }
    )


def load_mips_arxiv_x_science(
    arxiv_source: str | pd.DataFrame,
    multix_df: pd.DataFrame,
    column: str = "ref_abstract",
) -> pd.DataFrame:
    """Concatenated arXiv + Multi-XScience MIPS corpus (reference
    `load_mips_arxiv_x_science`, data_loaders.py:160-191; arXiv rows
    first, matching the reference concat order). Multi-XScience rows keep
    their example-index lists (self-exclusion still applies to them);
    arXiv rows carry empty lists.

    The reference composes `load_mips_arxiv` (sentence-list dataset with
    `<S>` tags, :98-125) — used here when the source carries an
    `abstract_text` column. Plain-`abstract` sources (e.g. the arxiv2
    parquet) go through `load_mips_arxiv2`'s cleaning instead: a
    DELIBERATE deviation for sources the reference loader cannot read,
    not reference parity."""
    if isinstance(arxiv_source, pd.DataFrame) and \
            "abstract_text" in arxiv_source:
        ax = load_mips_arxiv(arxiv_source)
    else:
        ax = load_mips_arxiv2(arxiv_source)
    mx = build_mips_corpus(multix_df, column)[["mips_column", "index", "aid"]]
    return pd.concat([ax, mx], ignore_index=True)


def add_aid_counts(df: pd.DataFrame) -> pd.DataFrame:
    """Merge per-aid example counts (reference data_modules.py:207-215,
    data_loaders.py:213-218) — the denominator of retriever recall."""
    counts = df["aid"].value_counts()
    out = df.copy()
    out["aid_counts"] = out["aid"].map(counts)
    return out
