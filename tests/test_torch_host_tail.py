"""The port's host tail on the CPU: the native CPU MIPS baseline
(`utils.cpu_baseline`), the native batch loader (`data.native_loader`,
`RAGDataModule.batches(native=...)`), their shared build
(`utils.native_build`), and `data.ingest`.

The JAX package's `cpu_mips_search` and `native_batches` are not called
here: they run ``make -C native``, which writes ``native/build/``. The
search is held to an exact numpy top-k and to `mips_topk_plain`; the loader
to the Python gather; the ingestion to the JAX package's `data/ingest.py`
(which builds nothing) on the same small JSONL files.
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from retrieval_augmented_mds_tpu.data import ingest as jingest
from retrieval_augmented_mds_tpu_torch.data import ingest as tingest
from retrieval_augmented_mds_tpu_torch.data.native_loader import native_batches
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import mips_topk_plain
from retrieval_augmented_mds_tpu_torch.utils import native_build
from retrieval_augmented_mds_tpu_torch.utils.cpu_baseline import cpu_mips_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the CPU MIPS baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("n,d,b,k", [(2000, 64, 8, 10), (1500, 32, 4, 5), (6, 16, 3, 9)])
def test_cpu_mips_search_is_exact(metric, n, d, b, k):
    """Ids equal an exact numpy top-k (ascending distance for l2) and
    `mips_topk_plain` (with the l2 route's -‖e‖²/2 row bias), in order;
    values equal plain's within f32 roundoff; k > N pads with (-3e38, -1)
    as plain does. Gaussian scores have no ties."""
    rng = np.random.default_rng(n + d)
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    vals, ids = cpu_mips_search(e, q, k, metric=metric)
    assert vals.shape == ids.shape == (b, k) and ids.dtype == np.int32
    if metric == "ip":
        order = np.argsort(-(q.astype(np.float64) @ e.T.astype(np.float64)), axis=-1)
        bias = None
    else:
        d2 = ((q[:, None].astype(np.float64) - e[None]) ** 2).sum(-1)
        order = np.argsort(d2, axis=-1)
        bias = torch.from_numpy(-0.5 * (e * e).sum(-1))
    kk = min(k, n)
    np.testing.assert_array_equal(ids[:, :kk], order[:, :kk])
    pv, pi = mips_topk_plain(torch.from_numpy(q), torch.from_numpy(e), k, row_bias=bias)
    np.testing.assert_array_equal(ids, pi.numpy())
    np.testing.assert_allclose(vals[:, :kk], pv.numpy()[:, :kk], rtol=1e-5, atol=1e-4)
    if k > n:
        assert (ids[:, n:] == -1).all() and (vals[:, n:] == np.float32(-3e38)).all()


def test_cpu_mips_search_refuses_bad_input():
    e = np.zeros((10, 8), np.float32)
    with pytest.raises(ValueError, match="metric"):
        cpu_mips_search(e, e[:2], 3, metric="cos")
    with pytest.raises(ValueError, match="dim"):
        cpu_mips_search(e, np.zeros((2, 4), np.float32), 3)


# ---------------------------------------------------------------------------
# the native batch loader
# ---------------------------------------------------------------------------

def _examples(n=53, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, 1000, (n, 16)).astype(np.int32),
        "attention_mask": np.ones((n, 16), np.int32),
        "labels": rng.integers(0, 1000, (n, 8)).astype(np.int32),
        "aid_counts": rng.integers(1, 5, (n,)).astype(np.int32),
        "floats": rng.standard_normal((n, 4, 3)).astype(np.float32),
        "bytes": rng.integers(-100, 100, (n, 5)).astype(np.int8),
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_batches_equal_the_python_gather(seed):
    """Every batch of a shuffled order equals the gather, field by field,
    with the keys sorted; retained batches never alias the ring's 3 slots
    (batch 0 would be overwritten by batch 3 if they did)."""
    ex = _examples(seed=seed)
    rng = np.random.default_rng(seed + 10)
    bs = (4, 2, 13, 1)[seed]
    order = rng.permutation(53)[: 53 - 53 % bs]
    held = list(native_batches(ex, order, bs))
    assert len(held) == len(order) // bs
    for i, b in enumerate(held):
        assert list(b) == sorted(ex)
        sel = order[i * bs:(i + 1) * bs]
        for k, v in ex.items():
            assert np.array_equal(b[k], v[sel]) and b[k].dtype == v.dtype, (i, k)


def test_native_batches_of_an_empty_order():
    assert list(native_batches(_examples(), np.zeros(0, np.int64), 4)) == []


class _CountingLib:
    """The loader library, counting its ``batch_loader_destroy`` calls."""

    def __init__(self, lib):
        self.lib, self.destroyed = lib, 0

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def batch_loader_destroy(self, handle):
        self.destroyed += 1
        self.lib.batch_loader_destroy(handle)


@pytest.fixture
def counting_lib(monkeypatch):
    from retrieval_augmented_mds_tpu_torch.data import native_loader

    lib = _CountingLib(native_loader._load())
    monkeypatch.setattr(native_loader, "_load", lambda: lib)
    return lib


@pytest.mark.parametrize("how", ["dropped_mid_epoch", "dropped_unstarted", "closed",
                                 "exhausted"])
def test_loader_is_destroyed_once(counting_lib, how):
    """An iterator dropped mid-epoch (its worker blocked on a full ring),
    dropped before its first batch (the finalizer's case), closed, or run to
    its end destroys its loader (joins its worker) exactly once; batches
    taken before stay valid."""
    import gc

    ex = _examples()
    it = native_batches(ex, np.arange(52), 4)
    taken = []
    if how == "exhausted":
        taken = list(it)
    elif how != "dropped_unstarted":
        taken = [next(it)]
    if how == "closed":
        it.close()
    del it
    gc.collect()
    assert counting_lib.destroyed == 1
    for i, b in enumerate(taken):
        for k, v in ex.items():
            assert np.array_equal(b[k], v[i * 4:(i + 1) * 4]), (i, k)
    assert len(taken) == {"exhausted": 13, "dropped_unstarted": 0}.get(how, 1)


@pytest.mark.parametrize("bad", ["ragged", "row_out_of_range", "negative_row", "rows_differ"])
def test_setup_errors_raise_at_call_time(bad):
    """What the worker would trip on raises when the iterator is created,
    before any batch."""
    ex = _examples()
    order = np.arange(52)
    if bad == "ragged":
        order = np.arange(5)
    elif bad == "row_out_of_range":
        order[3] = 53
    elif bad == "negative_row":
        order[0] = -1
    else:
        ex["labels"] = ex["labels"][:50]
    with pytest.raises(ValueError):
        native_batches(ex, order, 4)


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("split,drop_last", [("train", True), (None, True),
                                             ("val", False), (None, False)])
def test_pipeline_batches_native_equal_python(seed, split, drop_last):
    """`RAGDataModule.batches` through the native loader (the default) and
    the Python gather (``native=False``): the same batches, the ragged tail
    included (an epoch with one goes through the gather)."""
    from retrieval_augmented_mds_tpu_torch.data import (
        HashTokenizer,
        RAGDataModule,
        synthetic_multi_x_science,
    )

    dm = RAGDataModule(
        df=synthetic_multi_x_science(26), tokenizer=HashTokenizer(vocab_size=512),
        query_tokenizer=HashTokenizer(vocab_size=512), max_length=32, query_max_length=16,
        decoder_max_length=16, memory_len=16).prepare()
    kw = dict(shuffle=True, seed=seed, split=split, drop_last=drop_last)
    py = list(dm.batches(4, native=False, **kw))
    nat = list(dm.batches(4, **kw))
    assert len(py) == len(nat) > 0
    for bp, bn in zip(py, nat):
        assert sorted(bp) == sorted(bn)
        for k in bp:
            assert np.array_equal(bp[k], bn[k]), k


_BUILD = """
import sys
import numpy as np
from retrieval_augmented_mds_tpu_torch.utils import native_build
native_build.BUILD_DIR = sys.argv[1]
from retrieval_augmented_mds_tpu_torch.data.native_loader import native_batches
from retrieval_augmented_mds_tpu_torch.utils.cpu_baseline import cpu_mips_search
x = np.arange(48, dtype=np.float32).reshape(12, 4)
_, ids = cpu_mips_search(x, x[:2], 3)
assert ids[0].tolist() == [11, 10, 9], ids
got = [b["x"] for b in native_batches({"x": x}, np.arange(12)[::-1].copy(), 4)]
assert np.array_equal(np.concatenate(got), x[::-1])
print("ok", native_build.library_path("cpu_mips"), native_build.library_path("batch_loader"))
"""


def test_concurrent_builds_into_an_empty_dir(tmp_path):
    """Three processes build both libraries into one empty build directory
    at once; each compiles into its own temporary file and renames it into
    place, so every one of them loads a whole library and runs it, and the
    directory ends with exactly the two keyed libraries."""
    build_dir = str(tmp_path / "torch_native")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build_dir], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {tuple(out.split()[1:]) for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build_dir)) == sorted(os.path.basename(p) for p in paths.pop())


def test_library_key_follows_source_flags_and_host(monkeypatch):
    """The library's name changes with its flags and with what
    ``-march=native`` selects, so no library built elsewhere is loaded."""
    base = native_build.library_path("cpu_mips")
    assert base.startswith(native_build.BUILD_DIR + os.sep)
    assert native_build.library_path("batch_loader") != base
    monkeypatch.setattr(native_build, "CXXFLAGS", native_build.CXXFLAGS + ("-g",))
    assert native_build.library_path("cpu_mips") != base
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "_host_target", lambda: "-march=some-other-cpu")
    assert native_build.library_path("cpu_mips") != base


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "CXXFLAGS", native_build.CXXFLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="failed"):
        native_build.build("cpu_mips")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


# ---------------------------------------------------------------------------
# ingestion
# ---------------------------------------------------------------------------

def _write_jsonl(path, records, blank_lines=False):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
            if blank_lines:
                f.write("\n")


@pytest.mark.parametrize("out_name", ["papers.parquet", "papers.feather"])
@pytest.mark.parametrize("limit", [None, 2])
def test_scientific_papers_equal_jax(tmp_path, out_name, limit):
    """Plain, ``.gz`` and ``.txt`` JSONL with sentence lists, plain strings
    and missing fields, blank lines among them → the same table as the JAX
    package writes."""
    src = tmp_path / "src"
    os.makedirs(src)
    _write_jsonl(src / "b.jsonl", [
        {"article_id": f"x{i}", "abstract_text": [f"abs {i}", "two"],
         "article_text": [f"body {i}"], "section_names": ["intro", "end"]}
        for i in range(3)], blank_lines=True)
    _write_jsonl(src / "a.jsonl.gz", [
        {"article_id": "g0", "abstract": "plain abstract", "article": "plain body"},
        {"article_id": "g1", "section_names": []},
        {"abstract_text": ["only", "abstract"]}])
    _write_jsonl(src / "c.txt", [{"article_id": "t0", "article_text": ["a", "b"]}])
    outs = {}
    for name, mod in (("jax", jingest), ("port", tingest)):
        path = str(tmp_path / f"{name}_{out_name}")
        n = mod.build_scientific_papers(str(src), path, limit=limit)
        df = pd.read_parquet(path) if path.endswith(".parquet") else pd.read_feather(path)
        assert len(df) == n
        outs[name] = df
    pd.testing.assert_frame_equal(outs["port"], outs["jax"])
    # ``limit`` counts lines, blank ones too: b.jsonl gives one record of 3
    assert len(outs["port"]) == (7 if limit is None else 4)


def test_openalex_abstracts_equal_jax(tmp_path):
    """Gzipped snapshot parts in nested folders, inverted-index abstracts
    (repeated words, out-of-order positions), records without one skipped."""
    snap = tmp_path / "snap"
    os.makedirs(snap / "updated_date=2024" / "sub")
    _write_jsonl(snap / "updated_date=2024" / "part_000.gz", [
        {"id": "W1", "title": "t1", "abstract_inverted_index": {"hello": [0], "world": [1]}},
        {"id": "W2", "title": "no abstract", "abstract_inverted_index": None},
        {"id": "W3", "title": "t3",
         "abstract_inverted_index": {"the": [0, 3], "cat": [1], "saw": [2], "dog": [4]}}])
    _write_jsonl(snap / "updated_date=2024" / "sub" / "part_001.gz", [
        {"id": "W4", "abstract_inverted_index": {"b": [1], "a": [0]}}])
    outs = {}
    for name, mod in (("jax", jingest), ("port", tingest)):
        path = str(tmp_path / f"{name}.parquet")
        assert mod.build_openalex_abstracts(str(snap), path) == 3
        outs[name] = pd.read_parquet(path)
    pd.testing.assert_frame_equal(outs["port"], outs["jax"])
    assert list(outs["port"]["abstract"]) == ["hello world", "the cat saw the dog", "a b"]


def test_read_jsonl_equals_jax(tmp_path):
    path = tmp_path / "r.jsonl.gz"
    _write_jsonl(path, [{"i": i} for i in range(5)], blank_lines=True)
    for limit in (None, 0, 3, 20):
        assert (list(tingest.read_jsonl(str(path), limit))
                == list(jingest.read_jsonl(str(path), limit)))
