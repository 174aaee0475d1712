"""Parity of the port's IVF index with the JAX package, on the CPU:
k-means, packing, the build, the probe kernel's plain version, the
per-query search against the JAX kernel in interpret mode, every
`ivf_search` route, the files, the factory, `rag_encode` over an IVF store
and the `build-index` → `--index` round trip.

Inputs are numpy arrays made from a seed, at N of a few thousand and D of
64. A JAX-built index reaches the port through `bridge.ivf_index_from_arrays`,
so both packages search one index whatever k-means drew. Tolerances: f32
scores to rtol 1e-5 (summation order), k-means centroids to atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.index import factory as jfactory
from retrieval_augmented_mds_tpu.index import ivf as jivf
from retrieval_augmented_mds_tpu.index.ivf_serving import (
    ivf_search_serving as jax_ivf_search_serving,
)
from retrieval_augmented_mds_tpu_torch import bridge, cli
from retrieval_augmented_mds_tpu_torch.index import augment as taugment
from retrieval_augmented_mds_tpu_torch.index import factory as tfactory
from retrieval_augmented_mds_tpu_torch.index import ivf as tivf
from retrieval_augmented_mds_tpu_torch.index import load_index
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import quantize_corpus_sq8
from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
    INT_MAX,
    ivf_probe_scores_plain,
    ivf_probe_topk,
    ivf_probe_topk_plain,
    ivf_search_serving,
)
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# SQ8 scales amax / 127: XLA multiplies by the f32 reciprocal, one ulp off
SCALE_TOL = dict(rtol=2.5e-7, atol=0)
_ARRAY_FIELDS = ("centroids", "centroid_bias", "clustered", "clustered_ids",
                 "clustered_bias", "spill", "spill_ids", "spill_bias",
                 "clustered_scale", "spill_scale")
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered_data(n=2048, d=64, n_true=16, seed=0, dup=True):
    """Gaussian clusters; with ``dup``, rows 7, 300 and n - 5 repeat row 3
    (equal scores: the distinct rule and the tie rule)."""
    rng = np.random.default_rng(seed)
    centers = 5.0 * rng.standard_normal((n_true, d))
    x = (centers[rng.integers(0, n_true, n)] + rng.standard_normal((n, d))).astype(np.float32)
    if dup:
        x[[7, 300, n - 5]] = x[3]
    return x


def _queries(x, b, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    q = x[rng.integers(0, len(x), b)] + noise * rng.standard_normal((b, x.shape[1]))
    q[0] = 2.0 * x[3]  # its best hits are the duplicated rows
    return q.astype(np.float32)


def port_ivf(j) -> tivf.IVFIndex:
    """The port's IVFIndex holding a JAX-built index's arrays."""
    flat = None
    if j.flat is not None:
        flat = bridge.flat_index_from_arrays(
            {"embeddings": j.flat.embeddings, "row_bias": j.flat.row_bias,
             "row_scale": j.flat.row_scale},
            n=j.flat.n, metric=j.flat.metric, normalized=j.flat.normalized)
    return bridge.ivf_index_from_arrays(
        {f: getattr(j, f) for f in _ARRAY_FIELDS}, n=j.n, metric=j.metric,
        normalized=j.normalized, n_spill=j.n_spill, flat=flat)


def _assert_index_equal(t, j):
    for f in _ARRAY_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(jnp.asarray(b).astype(jnp.float32)) if b.dtype == jnp.bfloat16 \
            else np.asarray(b)
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        if f.endswith("scale"):
            np.testing.assert_allclose(a, b, err_msg=f, **SCALE_TOL)
        elif a.dtype.kind == "f" and f in ("centroids", "centroid_bias", "clustered_bias",
                                           "spill_bias"):
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.n, t.metric, t.normalized, t.n_spill) == (j.n, j.metric, j.normalized,
                                                        j.n_spill)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_clusters,seed", [(16, 0), (8, 1)])
def test_kmeans_matches_jax_from_the_same_draw(n_clusters, seed):
    """The JAX package's initial draw (`jax.random.choice`) given as
    ``init``: the same Lloyd iterations, centroids to 1e-5."""
    x = _clustered_data(seed=seed, dup=False)
    key = jax.random.PRNGKey(seed)
    init = jax.random.choice(key, jnp.asarray(x), shape=(n_clusters,), replace=False)
    jc, ja = jivf.kmeans(jnp.asarray(x), key, n_clusters, iters=10)
    tc, ta = tivf.kmeans(_t(x), n_clusters, iters=10, init=_t(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_kmeans_own_draw_is_seeded_and_device_free():
    """Without ``init`` the draw comes from a CPU generator: one seed, one
    result; and the distortion falls well below the initial draw's."""
    x = _t(_clustered_data(seed=2, dup=False))
    c1, a1 = tivf.kmeans(x, 16, generator=torch.Generator().manual_seed(3))
    c2, _ = tivf.kmeans(x, 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c1, c2)
    c0 = x[torch.randperm(len(x), generator=torch.Generator().manual_seed(3))[:16]]

    def distortion(c):
        return torch.cdist(x, c).pow(2).min(dim=1).values.mean()

    assert distortion(c1) < 0.5 * distortion(c0)
    assert int(a1.min()) >= 0 and int(a1.max()) < 16
    with pytest.raises(ValueError, match="16 clusters"):
        tivf.kmeans(x[:10], 16)


@pytest.mark.parametrize("dtype,metric", [("int8", "ip"), ("bfloat16", "l2"),
                                          ("float32", "ip")])
def test_pack_matches_jax(dtype, metric):
    """The same assignment packed by both: equal ids and payloads (int8 bit
    for bit), biases and scales to f32 rounding, overflow into the spill
    included."""
    x = _clustered_data(n=1000, d=40, n_true=4, seed=3)
    assign = np.random.default_rng(4).integers(0, 8, 1000).astype(np.int32)
    assign[:200] = 5  # cluster 5 overflows
    kw = dict(n_clusters=8, cap=136, spill_cap=256, d_pad=128, metric=metric,
              sq8=dtype == "int8")
    jout = jivf._pack_device(jnp.asarray(x), jnp.asarray(assign),
                             payload=jnp.int8 if dtype == "int8" else _JDT[dtype], **kw)
    tout = tivf._pack(_t(x), _t(assign).long(),
                      payload=getattr(torch, dtype), **kw)
    names = ("clustered", "ids", "bias", "spill", "spill_ids", "spill_bias", "scale",
             "spill_scale")
    for name, a, b in zip(names, tout[:-1], jout[:-1]):
        if a is None:
            assert b is None, name
            continue
        a, b = a.float().numpy(), np.asarray(b).astype(np.float32)
        if name.endswith("scale"):
            np.testing.assert_allclose(a, b, err_msg=name, **SCALE_TOL)
        elif name.endswith("bias"):  # -|x|^2 / 2: f32 summation order
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tout[-1] == int(jout[-1]) > 0


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_build_matches_jax_from_the_same_centroids(dtype):
    """`build_ivf_index` from the JAX draw (``init``): the whole index equals
    the JAX package's, the flat sibling's search included."""
    x = _clustered_data(n=1500, seed=5)
    init = jax.random.choice(jax.random.PRNGKey(0), jnp.asarray(x), shape=(24,),
                             replace=False)
    j = jivf.build_ivf_index(x, 24, dtype=_JDT[dtype], seed=0)
    t = tivf.build_ivf_index(x, 24, dtype=dtype, init=_t(init))
    _assert_index_equal(t, j)
    assert t.flat is not None and j.flat is not None
    q = _queries(x, 4, 6)
    _, ji = jivf.ivf_search(j, jnp.asarray(q), k=5, nprobe=24)  # flat sibling
    _, ti = tivf.ivf_search(t, _t(q), k=5, nprobe=24)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_chunked_assignment_equals_unchunked():
    x = _t(_clustered_data(n=3000, seed=6, dup=False))
    cent = x[:40] + 0.1
    whole = torch.argmax(x @ cent.T - 0.5 * (cent * cent).sum(-1), dim=-1)
    for chunk in (1, 7, 512, 4096):
        assert torch.equal(tivf.assign_clusters(x, cent, chunk), whole)


def test_build_keeps_every_row_and_takes_a_train_sample():
    """Overflow rows land in the spill, none is dropped; a ``train_size``
    sample is drawn from ``seed``, so a rebuild is identical."""
    x = _clustered_data(n=1024, d=32, n_true=2, seed=7, dup=False)
    a = tivf.build_ivf_index(x, 8, dtype="float32", alpha=1.0, train_size=300, seed=9)
    b = tivf.build_ivf_index(x, 8, dtype="float32", alpha=1.0, train_size=300, seed=9)
    got = set(a.clustered_ids.flatten().tolist()) | set(a.spill_ids.tolist())
    got.discard(-1)
    assert got == set(range(1024)) and a.n_spill > 0
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.clustered, b.clustered)


# ---------------------------------------------------------------------------
# the probe kernel's plain version and the per-query search
# ---------------------------------------------------------------------------

def _probe_oracle(scores, k):
    """numpy: distinct values, descending; each with its lowest position;
    -3e38 never taken; empty slots (-3e38, INT_MAX)."""
    b = scores.shape[0]
    vals = np.full((b, k), -3.0e38, np.float32)
    pos = np.full((b, k), INT_MAX, np.int64)
    for i in range(b):
        row = scores[i]
        uniq = np.unique(row[row > -3.0e38])[::-1][:k]
        for r, v in enumerate(uniq):
            vals[i, r] = v
            pos[i, r] = np.flatnonzero(row == v).min()
    return vals, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_probe_topk_plain_follows_the_kernel_rule(dtype):
    """Duplicate rows in one cluster and across probes (the lowest position
    wins), padding rows, and k larger than the probed rows (empty slots)."""
    rng = np.random.default_rng(8)
    c, L, d = 6, 16, 32
    e = rng.standard_normal((c, L, d)).astype(np.float32)
    e[2, 5] = e[2, 1]
    e[4, 0] = e[2, 1]
    bias = rng.standard_normal((c, L)).astype(np.float32)
    bias[4, 0] = bias[2, 5] = bias[2, 1]
    bias[:, 12:] = -3.0e38  # padding slots
    payload, scale = _t(e), None
    if dtype == "int8":
        q8, s8 = quantize_corpus_sq8(_t(e.reshape(-1, d)))
        payload, scale = q8.reshape(c, L, d), s8.reshape(c, L)
    else:
        payload = payload.to(getattr(torch, dtype))
    q = _t(rng.standard_normal((3, d)).astype(np.float32))
    probes = torch.tensor([[2, 4, 0], [4, 2, 5], [1, 3, 0]], dtype=torch.int32)
    for k in (1, 10, 40):
        vals, pos = ivf_probe_topk_plain(q, payload, _t(bias), scale, probes, k)
        scores = ivf_probe_scores_plain(q, payload, _t(bias), scale, probes).numpy()
        ref_v, ref_p = _probe_oracle(scores, k)
        np.testing.assert_array_equal(pos.numpy(), ref_p)
        np.testing.assert_array_equal(vals.numpy(), ref_v)
        assert torch.equal(ivf_probe_topk(q, payload, _t(bias), scale, probes, k)[1], pos)
    assert (pos[:, 36:] == INT_MAX).all()  # 3 probes x 12 real rows


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("with_ignore", [False, True])
def test_serving_search_matches_jax_interpret(dtype, with_ignore):
    """`ivf_search_serving` against the JAX package's, its Pallas kernel in
    interpret mode: ids exactly, scores to 1e-5 relative. The l2 metric
    makes query 0's best hits the four equal rows 3, 7, 300, 2043, all in
    one cluster (no row spills at alpha 4): the kernel reports them once,
    as row 3 (the lowest position), so ignoring row 3 drops all four."""
    x = _clustered_data(seed=10)
    q = _queries(x, 4, 11)
    q[0] = x[3]
    j = jivf.build_ivf_index(x, 16, metric="l2", dtype=_JDT[dtype], seed=1, alpha=4.0,
                             keep_flat=False)
    assert j.n_spill == 0
    t = port_ivf(j)
    ignore = None
    if with_ignore:
        ignore = np.full((4, 3), -1, np.int32)
        ignore[:, 0] = [3, 11, 500, 2000]
        ignore[0, 1] = 7  # one duplicate of the best row is excluded
    jv, ji = jax_ivf_search_serving(j, jnp.asarray(q), k=6, nprobe=3,
                                    ignore=None if ignore is None else jnp.asarray(ignore),
                                    interpret=True)
    tv, ti = ivf_search_serving(t, _t(q), k=6, nprobe=3,
                                ignore=None if ignore is None else _t(ignore))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=0)
    row0 = set(ti.numpy()[0].tolist())
    assert row0.isdisjoint({7, 300, 2043}) and (3 in row0) != with_ignore


def _routes_case(keep_flat, n_clusters, seed):
    x = _clustered_data(n=1024, d=64, n_true=8, seed=seed)
    j = jivf.build_ivf_index(x, n_clusters, dtype=jnp.float32, seed=2, alpha=1.0,
                             keep_flat=keep_flat)
    assert j.n_spill > 0
    return x, j, port_ivf(j)


@pytest.mark.parametrize("route,b,nprobe,keep_flat,serving", [
    ("union_probe", 4, 4, False, False),
    ("scan_all", 8, 4, False, None),
    ("flat", 8, 4, True, None),
])
@pytest.mark.parametrize("with_ignore", [False, True])
def test_ivf_search_routes_match_jax(route, b, nprobe, keep_flat, serving, with_ignore):
    """Each non-kernel route of `ivf_search` against the JAX package's, on
    an index whose spill is in use: ids equal, scores to 1e-5."""
    x, j, t = _routes_case(keep_flat, 32, 12)
    q = _queries(x, b, 13)
    assert tivf.ivf_route(t, b, 5, nprobe, 2 if with_ignore else 0, serving) == route
    ign = None
    if with_ignore:
        ign = np.stack([np.arange(b), np.full(b, 3)], 1).astype(np.int32)
    jv, ji = jivf.ivf_search(j, jnp.asarray(q), k=5, nprobe=nprobe, serving=serving,
                             ignore=None if ign is None else jnp.asarray(ign))
    tv, ti = tivf.ivf_search(t, _t(q), k=5, nprobe=nprobe, serving=serving,
                             ignore=None if ign is None else _t(ign))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_ivf_search_per_query_route_matches_jax():
    """``serving=True`` in both packages: the per-query route, with the
    spill merged, equal ids and scores."""
    x, j, t = _routes_case(False, 32, 14)
    q = _queries(x, 2, 15)
    assert tivf.ivf_route(t, 2, 5, 4) == "per_query"
    jv, ji = jivf.ivf_search(j, jnp.asarray(q), k=5, nprobe=4, serving=True)
    tv, ti = tivf.ivf_search(t, _t(q), k=5, nprobe=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# ---------------------------------------------------------------------------
# files, factory, augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ivf_files_load_in_either_package(tmp_path, dtype, writer):
    x = _clustered_data(n=1024, d=48, seed=16)
    q = _queries(x, 3, 17)
    path = str(tmp_path / "ivf")
    if writer == "jax":
        jivf.save_ivf_index(jivf.build_ivf_index(x, 16, dtype=_JDT[dtype], seed=3), path)
    else:
        tivf.save_ivf_index(tivf.build_ivf_index(x, 16, dtype=dtype, seed=3), path)
    j = jivf.load_ivf_index(path)
    t = load_index(path)
    assert isinstance(t, tivf.IVFIndex) and t.flat is not None
    _assert_index_equal(t, j)
    for nprobe in (2, 16):  # union probe; flat sibling
        jv, ji = jivf.ivf_search(j, jnp.asarray(q), k=5, nprobe=nprobe, serving=False)
        tv, ti = tivf.ivf_search(t, _t(q), k=5, nprobe=nprobe, serving=False)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("spec,n", [("IVF256,SQ8", 1055), ("IVF16_HNSW32,Flat", 200),
                                    ("IVF8,SQ8", 100)])
def test_factory_clamps_and_reports_like_jax(capsys, spec, n):
    x = _clustered_data(n=n, d=32, seed=18, dup=False)
    t = tfactory.build_index_from_factory(x, spec, dtype="float32", train_size=n // 2)
    t_err = capsys.readouterr().err
    j = jfactory.build_index_from_factory(x, spec, dtype=jnp.float32, train_size=n // 2)
    j_err = capsys.readouterr().err
    assert t_err == j_err
    assert t.n_clusters == j.n_clusters == min(int(spec[3:].split(",")[0].split("_")[0]),
                                               n // 8)
    assert t.clustered.dtype == (torch.int8 if spec.endswith("SQ8") else torch.float32)
    assert ("effective n_clusters=131" in t_err) == (n == 1055)


def test_augmentation_matches_jax():
    from retrieval_augmented_mds_tpu.index import augment as jaugment

    rng = np.random.default_rng(19)
    x = rng.standard_normal((50, 24)).astype(np.float32)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    ta, tphi = taugment.augment_corpus(_t(x))
    ja, jphi = jaugment.augment_corpus(jnp.asarray(x))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(float(tphi), float(jphi), rtol=1e-6)
    np.testing.assert_allclose(float(taugment.corpus_phi(_t(x))),
                               float(jaugment.corpus_phi(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(taugment.augment_queries(_t(q)).numpy(),
                                  np.asarray(jaugment.augment_queries(jnp.asarray(q))))
    # L2 search over the augmented corpus = inner-product search over x
    d2 = torch.cdist(taugment.augment_queries(_t(q)), ta)
    assert torch.equal(d2.argmin(dim=1), (_t(q) @ _t(x).T).argmax(dim=1))


# ---------------------------------------------------------------------------
# the model and the command line over an IVF store
# ---------------------------------------------------------------------------

def test_rag_encode_over_ivf_store_matches_jax(monkeypatch):
    """The tiny RAG config retrieves through the per-query route in both
    packages (the JAX one forced by RAMDS_IVF_SERVING=1, traced afresh):
    equal ids, scores, memory and encoder states."""
    from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
    from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
    from tests.test_torch_rag import LM, TOL as RAG_TOL, _batch, _np, _setup

    cfg, jcfg, jp, model = _setup(seed=5)
    rng = np.random.default_rng(20)
    n = 256
    emb = rng.standard_normal((n, cfg.query_enc.d_model)).astype(np.float32)
    ids = rng.integers(4, cfg.mips_enc.vocab_size, (n, LM)).astype(np.int32)
    ids[:, 0] = cfg.mips_enc.bos_id
    mask = np.ones((n, LM), np.int32)
    j = jivf.build_ivf_index(emb, 16, dtype="int8", seed=4, keep_flat=False)
    jstore = jrag.MemoryStore(index=j, token_ids=jnp.asarray(ids),
                              token_mask=jnp.asarray(mask), nprobe=4)
    tstore = trag.MemoryStore(index=port_ivf(j), token_ids=_t(ids), token_mask=_t(mask),
                              nprobe=4)
    batch = _batch(cfg, 21)
    batch["mips_ignore"][:, :2] = rng.integers(0, n, (batch["mips_ignore"].shape[0], 2))
    assert tivf.ivf_route(tstore.index, 2, cfg.mips_topk, 4, 8) == "per_query"
    monkeypatch.setenv("RAMDS_IVF_SERVING", "1")
    jax.clear_caches()
    jenc = jrag.rag_encode(jp, jcfg, jstore, {k: jnp.asarray(v) for k, v in batch.items()})
    tenc = trag.rag_encode(model, cfg, tstore, {k: _t(v) for k, v in batch.items()})
    jax.clear_caches()
    np.testing.assert_array_equal(tenc.retrieved_idx.numpy(), np.asarray(jenc.retrieved_idx))
    for name in ("faiss_scores", "memory", "mips_scores", "enc_hidden"):
        np.testing.assert_allclose(_np(getattr(tenc, name)), np.asarray(getattr(jenc, name)),
                                   err_msg=name, **RAG_TOL)


def _ivf_cli_config():
    return tconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 64, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 32,
                 "memory_len": 64, "batch_size": 4},
        "index": {"factory": "IVF16,SQ8", "nprobe": 2},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
    })


def test_build_index_round_trips_across_packages(tmp_path):
    """`build-index` of either package → the other's `--index` store: the
    same index, the same search, and the port's `predict --index`."""
    from retrieval_augmented_mds_tpu import cli as jcli
    from retrieval_augmented_mds_tpu.utils import config as jconfig

    tcfg = _ivf_cli_config()
    jcfg = jconfig.config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": dataclasses.asdict(tcfg.data), "index": dataclasses.asdict(tcfg.index),
        "generation": {"max_new_tokens": 4, "num_beams": 2},
    })
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.run_build_index(jcfg, jdir)
    assert cli.main(["build-index", "--config", _write_yaml(tmp_path, tcfg), "--out", tdir,
                     "--device", "cpu"]) == 0
    for path in (jdir, tdir):
        js, ts = jcli.load_store(path, jcfg), cli.load_store(path, tcfg, torch.device("cpu"))
        assert isinstance(ts.index, tivf.IVFIndex) and ts.nprobe == js.nprobe == 2
        _assert_index_equal(ts.index, js.index)
        np.testing.assert_array_equal(ts.token_ids.numpy(), np.asarray(js.token_ids))
        q = np.random.default_rng(22).standard_normal((4, 64)).astype(np.float32)
        _, ji = jivf.ivf_search(js.index, jnp.asarray(q), k=2, nprobe=2, serving=False)
        _, ti = tivf.ivf_search(ts.index, _t(q), k=2, nprobe=2, serving=False)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        report = {}
        out = cli.run_predict(tcfg, path, device="cpu", report=report)
        assert len(out["predictions"]) == 4 and report["store"].index.n == js.index.n


def _write_yaml(tmp_path, cfg) -> str:
    import yaml

    d = {"model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
         "data": dataclasses.asdict(cfg.data), "index": dataclasses.asdict(cfg.index),
         "generation": {"max_new_tokens": 4, "num_beams": 2}}
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def test_fit_with_ivf_store_refreshes_and_keeps_nprobe(tmp_path):
    """`fit` over an IVF SQ8 store on the CPU: the per-query route in the
    train step, and a refresh that rebuilds the same kind of index."""
    cfg = _ivf_cli_config()
    cfg = dataclasses.replace(
        cfg, max_steps=3, eval_every=0,
        index=dataclasses.replace(cfg.index, rebuild_every=2),
        logging=dataclasses.replace(cfg.logging, log_dir=str(tmp_path)))
    report = {}
    out = cli.run_fit(cfg, device="cpu", report=report)
    assert out["steps"] == 3 and len(report["refresh_s"]) == 1
    assert all(np.isfinite(report["losses"]))
    assert [tuple(r.shape) for r in report["retrieved"]] == [(cfg.data.batch_size, 2)] * 3
    store = report["store"]
    assert isinstance(store.index, tivf.IVFIndex) and store.nprobe == 2
    assert store.index.clustered.dtype == torch.int8
    assert tivf.ivf_route(store.index, 4, 2, 2, 8) == "per_query"


def test_bench_index_runs_on_the_cpu():
    cfg = dataclasses.replace(
        _ivf_cli_config(), data=dataclasses.replace(_ivf_cli_config().data,
                                                    mips_db_max_size=4096))
    out = cli.run_bench_index(cfg, device="cpu")
    assert out["n"] == 4096 and out["flat_recall"] == 1.0
    assert 0.5 <= out["ivf_recall_nprobe8"] <= out["ivf_recall_nprobe32"] <= 1.0
