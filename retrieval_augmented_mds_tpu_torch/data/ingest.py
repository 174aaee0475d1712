"""One-off dataset ingestion.

Counterpart of ``retrieval_augmented_mds_tpu/data/ingest.py``, a port of
sotasum/data_utils.py: arXiv "long-summarization" JSONL → one parquet or
feather table (`build_scientific_papers`, data_utils.py:41-53 with
`_read_json` at :10-38) and an OpenAlex works snapshot → parquet
(`build_openalex_abstracts`, :56-73). Host only: pandas and pyarrow.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Iterator

import pandas as pd


def read_jsonl(path: str, limit: int | None = None) -> Iterator[dict]:
    """The records of a JSONL file, plain or ``.gz``, blank lines skipped;
    at most the first ``limit`` lines."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            line = line.strip()
            if line:
                yield json.loads(line)


def build_scientific_papers(src_dir: str, out_path: str, *, limit: int | None = None) -> int:
    """Every ``*.jsonl*`` and ``*.txt`` file of ``src_dir`` (sorted) → one
    table of (article_id, abstract, article, section_names), written as
    parquet when ``out_path`` ends in ``.parquet``, else as feather → the
    row count. ``abstract_text``/``article_text`` sentence lists are joined
    with spaces; ``limit`` caps the lines read per file."""
    rows = []
    for path in sorted(glob.glob(os.path.join(src_dir, "*.jsonl*"))
                       + glob.glob(os.path.join(src_dir, "*.txt"))):
        for rec in read_jsonl(path, limit=limit):
            rows.append({
                "article_id": rec.get("article_id", ""),
                "abstract": (" ".join(rec.get("abstract_text", [])) if "abstract_text" in rec
                             else rec.get("abstract", "")),
                "article": (" ".join(rec.get("article_text", [])) if "article_text" in rec
                            else rec.get("article", "")),
                "section_names": rec.get("section_names", []),
            })
    df = pd.DataFrame(rows)
    if out_path.endswith(".parquet"):
        df.to_parquet(out_path)
    else:
        import pyarrow as pa
        import pyarrow.feather as feather

        feather.write_feather(pa.Table.from_pandas(df), out_path)
    return len(df)


def build_openalex_abstracts(snapshot_dir: str, out_path: str, *,
                             limit: int | None = None) -> int:
    """Every ``*.gz`` under ``snapshot_dir`` (recursively, sorted) → a parquet
    table of (id, title, abstract) → the row count. Abstracts stored as
    inverted indexes (word → positions) are rebuilt; records without one
    are skipped."""
    rows = []
    for path in sorted(glob.glob(os.path.join(snapshot_dir, "**", "*.gz"), recursive=True)):
        for rec in read_jsonl(path, limit=limit):
            inv = rec.get("abstract_inverted_index")
            if not inv:
                continue
            words = [""] * (max(p for positions in inv.values() for p in positions) + 1)
            for w, positions in inv.items():
                for p in positions:
                    words[p] = w
            rows.append({"id": rec.get("id", ""), "title": rec.get("title", ""),
                         "abstract": " ".join(words)})
    df = pd.DataFrame(rows)
    df.to_parquet(out_path)
    return len(df)
