"""The sharded flat and IVF searches over a (data, shard) mesh, against the
JAX package's sharded searches, on the CPU.

The port runs one process per mesh position (`torch_mesh_launch`: fresh
interpreters, gloo over a ``file://`` store under ``tmp_path``); the JAX
package runs its ``shard_map`` searches on the forced CPU devices of
``tests/conftest.py``. One launch of 2 ranks runs the (1, 2) and (2, 1)
meshes, one of 4 ranks the (2, 2) mesh; each rank returns its results and
the test compares them with the JAX package's rows for that rank. The
inputs are numpy arrays drawn from a seed; the IVF indexes are JAX-built
and handed to the ranks as arrays (`bridge.ivf_index_from_arrays` with the
rank's mesh), since the two packages' k-means draw differently.

Tolerances: ids equal; values within 1e-6 (rtol and atol) in f32, and
within 1e-5 for bf16 and SQ8 payloads, where the two packages sum the
same exact f32 products in another order.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu_torch import bridge
from retrieval_augmented_mds_tpu_torch.index import load_index
from retrieval_augmented_mds_tpu_torch.index.flat import build_flat_index, merge_topk, search
from retrieval_augmented_mds_tpu_torch.index.ivf import (
    ivf_route,
    ivf_search,
    ivf_search_sharded,
)
from retrieval_augmented_mds_tpu_torch.parallel import MeshSpec, make_mesh
from torch_mesh_launch import launch, store_url

N, D, B, K = 600, 32, 8, 4
ROW_ALIGN = 64
LAUNCH_TIMEOUT = 240  # s: a launch takes ~10 s here; a hang is killed, never waited out
TOL = {"float32": 1e-6, "bfloat16": 1e-5, "int8": 1e-5}
IVF_FIELDS = ("centroids", "centroid_bias", "clustered", "clustered_ids", "clustered_bias",
              "spill", "spill_ids", "spill_bias", "clustered_scale", "spill_scale")


def _data(seed=0, n=N, b=B):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, D)).astype(np.float32)
    q = rng.standard_normal((b, D)).astype(np.float32)
    return e, q


def _ties(seed=1):
    """Rows 0-71 copied to rows 128-199: with N padded to 256 over 2 shards
    (64-row alignment), every copy lies on shard 1 and its original on shard
    0, so their scores tie across shards."""
    e, q = _data(seed, n=200)
    e[128:200] = e[0:72]
    q = np.concatenate([q, 3.0 * e[[3, 10, 40, 71]]])  # queries whose best rows tie
    return e, q


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": "int8"}[name]


def _rows(mesh, q, data_sharded):
    return q[mesh.data_rows(len(q))] if data_sharded else q


def _run_case(mesh, case):
    ign = case.get("ignore")
    ds = case.get("data_sharded", False)
    q = torch.from_numpy(_rows(mesh, case["q"], ds))
    ign = None if ign is None else torch.from_numpy(_rows(mesh, ign, ds))
    if case["kind"] == "flat":
        idx = build_flat_index(case["e"], dtype=_torch_dtype(case["dtype"]), mesh=mesh,
                               row_align=ROW_ALIGN)
        vals, ids = search(idx, q, k=case["k"], ignore=ign, mesh=mesh)
    elif case["kind"] == "flat_bridge":
        idx = bridge.flat_index_from_arrays(case["arrays"], mesh=mesh, **case["static"])
        vals, ids = search(idx, q, k=case["k"], ignore=ign, mesh=mesh)
    elif case["kind"] == "flat_load":
        idx = load_index(case["path"], mesh=mesh)
        vals, ids = search(idx, q, k=case["k"], ignore=ign, mesh=mesh)
    elif case["kind"] == "ivf_load":
        idx = load_index(case["path"], mesh=mesh)
        vals, ids = ivf_search_sharded(idx, q, mesh, k=case["k"], nprobe=case["nprobe"],
                                       ignore=ign, data_sharded=ds)
    else:
        arrays = {f: case["arrays"].get(f) for f in IVF_FIELDS}
        sharded = case["kind"] == "ivf_sharded"
        idx = bridge.ivf_index_from_arrays(arrays, mesh=mesh if sharded else None,
                                           **case["static"])
        if sharded:
            vals, ids = ivf_search_sharded(idx, q, mesh, k=case["k"], nprobe=case["nprobe"],
                                           ignore=ign, data_sharded=ds)
        else:
            vals, ids = ivf_search(idx, q, k=case["k"], nprobe=case["nprobe"], ignore=ign,
                                   serving=False, mesh=mesh, data_sharded=ds)
    return vals.numpy(), ids.numpy()


def rank_cases(init, specs, cases):
    """One rank: every case of every mesh in ``specs`` → {name: (values,
    ids)}, and the JAX modules this process holds."""
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init)
    out = {}
    for spec in specs:
        mesh = make_mesh(MeshSpec(*spec), "cpu")
        for name, case in cases.items():
            if tuple(case["mesh"]) == tuple(spec):
                out[name] = _run_case(mesh, case)
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "retrieval_augmented_mds_tpu.")) or m == "retrieval_augmented_mds_tpu")
    return out


def _launch(tmp_path, world, specs, cases):
    return launch(f"{__name__}:rank_cases", world, workdir=str(tmp_path / f"w{world}"),
                  args=(store_url(str(tmp_path / f"w{world}")), specs, cases),
                  timeout=LAUNCH_TIMEOUT)


def _rank_rows(rank, spec, b, data_sharded):
    """The rows of a batch of ``b`` that rank ``rank`` of mesh ``spec``
    holds."""
    data, shard = spec
    if not (data_sharded and data > 1 and b % data == 0):
        return slice(0, b)
    d, n = rank // shard, b // data
    return slice(d * n, (d + 1) * n)


def _check(results, spec, name, ref, tol, what=""):
    rv, ri = (np.asarray(x) for x in ref)
    for r, res in enumerate(results):
        vals, ids = res[name]
        rows = _rank_rows(r, spec, len(ri), True)
        np.testing.assert_array_equal(ids, ri[rows], err_msg=f"{name} rank {r} {what}")
        np.testing.assert_allclose(vals, rv[rows], rtol=tol, atol=tol,
                                   err_msg=f"{name} rank {r} {what}")


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(spec):
    import jax

    from retrieval_augmented_mds_tpu.parallel import MeshSpec as JMeshSpec

    if len(jax.devices()) < spec[0] * spec[1]:
        pytest.skip("needs the forced CPU devices of tests/conftest.py")
    return JMeshSpec(*spec).build()


def _jax_flat(spec, e, q, dtype, ignore, k=K):
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index import flat as jflat

    jm = _jax_mesh(spec)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": "int8"}[dtype]
    idx = jflat.build_flat_index(e, dtype=jdt, mesh=jm, row_align=ROW_ALIGN)
    ign = None if ignore is None else jnp.asarray(ignore)
    with jm:
        return jflat.search(idx, jnp.asarray(q), k=k, ignore=ign, mesh=jm,
                            data_sharded=spec[0] > 1)


@functools.lru_cache(maxsize=None)
def _jax_ivf(seed, c, dtype="float32"):
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index import ivf as jivf

    e, _ = _data(seed)
    idx = jivf.build_ivf_index(e, c, dtype=jnp.float32 if dtype == "float32" else dtype,
                               seed=seed)
    arrays = {f: None if getattr(idx, f) is None else np.asarray(getattr(idx, f))
              for f in IVF_FIELDS}
    static = {"n": idx.n, "metric": idx.metric, "normalized": idx.normalized,
              "n_spill": idx.n_spill}
    return idx, arrays, static


def _jax_ivf_sharded(spec, idx, q, k, nprobe, ignore=None):
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index import ivf as jivf

    jm = _jax_mesh(spec)
    sh = jivf.shard_ivf_index(idx, jm)
    with jm:
        return jivf.ivf_search_sharded(sh, jnp.asarray(q), jm, k=k, nprobe=nprobe,
                                       ignore=None if ignore is None else jnp.asarray(ignore))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

SPECS_2 = [(1, 2), (2, 1)]
SPECS_4 = [(2, 2)]
DTYPES = ("float32", "bfloat16", "int8")


def _flat_cases(specs):
    e, q = _data(0)
    ref_ign = np.argsort(-(q @ e.T), axis=1)[:, :3].astype(np.int32)
    ign = np.concatenate([ref_ign, np.full((B, 2), -1, np.int32)], axis=1)
    cases, refs = {}, {}
    for spec in specs:
        for dtype in DTYPES:
            for with_ign in (False, True):
                name = f"flat_{spec[0]}x{spec[1]}_{dtype}_{'ign' if with_ign else 'all'}"
                cases[name] = {"kind": "flat", "mesh": spec, "e": e, "q": q, "k": K,
                               "dtype": dtype, "ignore": ign if with_ign else None,
                               "data_sharded": True}
                refs[name] = (spec, _jax_flat(spec, e, q, dtype, cases[name]["ignore"]),
                              TOL[dtype])
    return cases, refs


def _handover_cases(tmp_path):
    """On (1, 2): the JAX package's sharded flat index handed over as its
    arrays (`bridge.flat_index_from_arrays` keeps the rank's rows), and a
    flat and an IVF index the JAX package saved, loaded by each rank
    (`index.load_index(mesh=)`: its rows, its clusters), each against the
    JAX package's own sharded search of the same index."""
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index import flat as jflat
    from retrieval_augmented_mds_tpu.index import ivf as jivf
    from retrieval_augmented_mds_tpu.index import load_index as jload_index

    spec = (1, 2)
    jm = _jax_mesh(spec)
    e, q = _data(0)
    ign = np.argsort(-(q @ e.T), axis=1)[:, :2].astype(np.int32)
    static = {"n": N, "metric": "ip", "normalized": False}
    sharded = jflat.build_flat_index(e, dtype=jnp.float32, mesh=jm, row_align=ROW_ALIGN)
    flat_dir = str(tmp_path / "jax_flat")
    jflat.save_flat_index(jflat.build_flat_index(e, dtype=jnp.float32, row_align=ROW_ALIGN),
                          flat_dir)
    jidx, _, _ = _jax_ivf(seed=32, c=32)
    ivf_dir = str(tmp_path / "jax_ivf")
    jivf.save_ivf_index(jidx, ivf_dir)
    with jm:
        flat_ref = jflat.search(sharded, jnp.asarray(q), k=K, ignore=jnp.asarray(ign), mesh=jm)
        load_ref = jflat.search(jload_index(flat_dir, mesh=jm), jnp.asarray(q), k=K,
                                ignore=jnp.asarray(ign), mesh=jm)
    ivf_q = _data(132)[1]
    cases = {
        "bridge_flat": {"kind": "flat_bridge", "mesh": spec, "q": q, "k": K, "ignore": ign,
                        "static": static,
                        "arrays": {"embeddings": np.asarray(sharded.embeddings),
                                   "row_bias": np.asarray(sharded.row_bias)}},
        "load_flat": {"kind": "flat_load", "mesh": spec, "q": q, "k": K, "ignore": ign,
                      "path": flat_dir},
        "load_ivf": {"kind": "ivf_load", "mesh": spec, "q": ivf_q, "k": K, "nprobe": 2,
                     "ignore": None, "path": ivf_dir},
    }
    refs = {"bridge_flat": (spec, flat_ref, TOL["float32"]),
            "load_flat": (spec, load_ref, TOL["float32"]),
            "load_ivf": (spec, _jax_ivf_sharded(spec, jidx, ivf_q, K, 2), TOL["float32"])}
    return cases, refs


def test_sharded_flat_search_equals_jax_on_1x2_and_2x1(tmp_path):
    """Flat f32, bf16 and SQ8, with and without ignore ids (each query's
    true top 3), on the (1, 2) and (2, 1) meshes, and on (1, 2) the JAX
    package's indexes handed over (`_handover_cases`): every rank's ids
    equal the JAX package's ``search(mesh=)`` rows, values within TOL. The
    ranks load no JAX."""
    cases, refs = _flat_cases(SPECS_2)
    more_cases, more_refs = _handover_cases(tmp_path)
    cases.update(more_cases)
    refs.update(more_refs)
    results = _launch(tmp_path, 2, SPECS_2, cases)
    for name, (spec, ref, tol) in refs.items():
        _check(results, spec, name, ref, tol)
    assert all(r["modules"] == [] for r in results), [r["modules"] for r in results]


def _ivf_cases(spec, b_global):
    """IVF cases on one mesh (data D): C = 16, nprobe 2, k 4, so that
    B_global * nprobe >= C takes the scan of every cluster while a rank's
    own B_global / D rows would probe. Plus an index of C = 32 whose whole
    batch still probes (the union route, unioned over every data rank), and
    self-exclusion of each query's true top 2."""
    cases, refs = {}, {}
    for c in (16, 32):
        jidx, arrays, static = _jax_ivf(seed=c, c=c)
        _, q = _data(100 + c, b=b_global)
        e = _data(c)[0]
        top2 = np.argsort(-(q @ e.T), axis=1)[:, :2].astype(np.int32)
        for with_ign in (False, True):
            ign = top2 if with_ign else None
            tag = f"ivf{c}_{spec[0]}x{spec[1]}_{'ign' if with_ign else 'all'}"
            base = {"q": q, "k": K, "nprobe": 2, "arrays": arrays, "static": static,
                    "ignore": ign, "mesh": spec, "data_sharded": True}
            if spec[1] > 1:
                cases[tag] = dict(base, kind="ivf_sharded")
                refs[tag] = (spec, _jax_ivf_sharded(spec, jidx, q, K, 2, ign))
            else:
                import jax.numpy as jnp

                from retrieval_augmented_mds_tpu.index import ivf as jivf

                cases[tag] = dict(base, kind="ivf")
                refs[tag] = (spec, jivf.ivf_search(
                    jidx, jnp.asarray(q), k=K, nprobe=2,
                    ignore=None if ign is None else jnp.asarray(ign), serving=False))
    return cases, refs


def test_sharded_ivf_search_equals_jax_on_1x2_and_2x1(tmp_path):
    """`ivf_search_sharded` on (1, 2) and the unsharded `ivf_search` on each
    data rank of (2, 1), over JAX-built indexes handed to the ranks, equal
    the JAX package's ``ivf_search_sharded`` / ``ivf_search`` rows, and
    the sharded search the port's unsharded `ivf_search` of the whole
    index: the
    probe union route (C = 32) and on (2, 1) the whole batch's scan route
    (C = 16: 8 x 2 >= 16, where a rank's own 4 rows would probe), each with
    and without self-exclusion."""
    cases, refs = {}, {}
    for spec in SPECS_2:
        c, r = _ivf_cases(spec, B)
        cases.update(c)
        refs.update(r)
    results = _launch(tmp_path, 2, SPECS_2, cases)
    for name, (spec, ref) in refs.items():
        _check(results, spec, name, ref, TOL["float32"])
    # the port's own unsharded search of the whole index, the same batch
    for name, case in cases.items():
        if case["kind"] != "ivf_sharded":
            continue
        whole = bridge.ivf_index_from_arrays(case["arrays"], **case["static"])
        ign = case["ignore"]
        ref = ivf_search(whole, torch.from_numpy(case["q"]), k=K, nprobe=2, serving=False,
                         ignore=None if ign is None else torch.from_numpy(ign))
        _check(results, case["mesh"], name, ref, TOL["float32"], "against the unsharded")


def test_sharded_searches_equal_jax_on_2x2(tmp_path):
    """The (2, 2) mesh in one launch of 4 ranks: flat f32/bf16/SQ8 with
    and without ignore ids, and `ivf_search_sharded` with the queries split
    over ``data``: at C = 16 the whole batch (8 x 2 >= 16) scans every
    cluster, as JAX's replicated batch does, though each rank holds 4
    queries (4 x 2 < 16: the probe route); at C = 32 the union of every
    data rank's probes. Every rank's rows equal the JAX package's."""
    cases, refs = _flat_cases(SPECS_4)
    refs = {k: v for k, v in refs.items()}
    ivf_cases, ivf_refs = _ivf_cases((2, 2), B)
    cases.update(ivf_cases)
    results = _launch(tmp_path, 4, SPECS_4, cases)
    for name, (spec, ref, tol) in refs.items():
        _check(results, spec, name, ref, tol)
    for name, (spec, ref) in ivf_refs.items():
        _check(results, spec, name, ref, TOL["float32"])
    assert all(r["modules"] == [] for r in results)


def test_global_batch_route_differs_from_a_ranks_own(tmp_path):
    """The premise of the scan case: at C = 16, nprobe 2, a rank's own 4
    queries take the probe route and the whole batch of 8 the scan of every
    cluster, and the two retrieve other rows for some query (JAX's own
    sharded search of the 4 rows against its rows of the 8), so deciding by
    the rank's rows would break parity. The port's sharded search of the 4
    rows alone (``data_sharded`` off, one process) equals JAX's probe."""
    jidx, arrays, static = _jax_ivf(seed=16, c=16)
    _, q = _data(116, b=B)
    idx = bridge.ivf_index_from_arrays(arrays, **static)
    assert ivf_route(idx, B // 2, K, 2) in ("per_query", "union_probe")
    assert ivf_route(idx, B, K, 2) == "scan_all"
    whole = np.asarray(_jax_ivf_sharded((1, 2), jidx, q, K, 2)[1])
    own = np.asarray(_jax_ivf_sharded((1, 2), jidx, q[:4], K, 2)[1])
    assert not np.array_equal(whole[:4], own)
    # the same union probe in the port, unsharded and without a mesh
    _, got = ivf_search(idx, torch.from_numpy(q[:4]), k=K, nprobe=2, serving=False)
    np.testing.assert_array_equal(got.numpy(), own)


def test_cross_shard_ties_merge_as_jax_merges_them(tmp_path):
    """Copies of rows 0-71 on the other shard (`_ties`): the sharded search
    holds both the row and its copy (K1 collapses equal scores within a
    shard only), the lower shard first, exactly as JAX's ``_merge_topk``;
    the unsharded search holds one of each tied pair."""
    e, q = _ties()
    spec = (1, 2)
    cases = {"ties": {"kind": "flat", "mesh": spec, "e": e, "q": q, "k": K,
                      "dtype": "float32", "ignore": None}}
    ref = _jax_flat(spec, e, q, "float32", None)
    results = _launch(tmp_path, 2, [spec], cases)
    for res in results:
        vals, ids = res["ties"]
        np.testing.assert_array_equal(ids, np.asarray(ref[1]))
        np.testing.assert_allclose(vals, np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    ids = results[0]["ties"][1]
    assert all(ids[-4 + i, 1] == ids[-4 + i, 0] + 128 for i in range(4)), ids[-4:]
    _, one = search(build_flat_index(e, dtype=torch.float32), torch.from_numpy(q), k=K)
    assert all(one[-4 + i, 1] != one[-4 + i, 0] + 128 for i in range(4))


@pytest.mark.parametrize("shards,kk,levels,seed", [(2, 4, 3, 0), (2, 8, 2, 1), (4, 4, 4, 2),
                                                   (3, 6, 5, 3), (4, 10, 1, 4)])
def test_merge_topk_equals_jax_on_ties(shards, kk, levels, seed):
    """`merge_topk` on candidates of few distinct values (many ties within
    and across shards) equals JAX's ``_merge_topk``: the same values and
    the same ids, ties to the lower shard."""
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index.flat import _merge_topk

    rng = np.random.default_rng(seed)
    vals = -np.sort(-rng.integers(0, levels, (shards, 5, kk)).astype(np.float32), -1)
    ids = rng.permutation(shards * 5 * kk).reshape(shards, 5, kk).astype(np.int32)
    tv, ti = merge_topk(torch.from_numpy(vals), torch.from_numpy(ids), kk)
    jv, ji = _merge_topk(jnp.asarray(vals), jnp.asarray(ids), kk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
