"""The decomposition of kernel K8 (``csrc/ivf_probe_topk.cu``), emulated on
the CPU.

K8 no longer reads a cluster once per query that probes it. Of the
B·nprobe probe entries (b·nprobe + p), the first that probes a cluster
heads its run: every later entry that probes the same cluster, in
ascending order (`runs`). The head's CTAs, one per row split that `_plan`
cuts from the kernel's layout, score the cluster's rows once for all of
the run's queries, 8 at a time. Per (query, probe,
split) it keeps a list of up to k distinct values with their lowest
positions p·L + slot, through K1's strict-greater threshold filter over
128-row tiles (a candidate buffer of 128 slots merged when half full, an
overflowed tile offered again at or above the new threshold; the card's
scheduler picks which candidates win the slots of an overflowing buffer).
One warp per query then merges the query's nprobe·splits lists under the
same rule.

`emulate` does exactly that in torch, on the layout of an H100 stand-in
(`h100_layout`) with a seeded random choice of an overflowing buffer's
winners. The tests hold the grouping to the probes it came from, and the
emulation to `ivf_probe_topk_plain` (positions equal, values within rtol
1e-5 + atol 1e-4: f32 sums of the same products in another order) and,
through the whole per-query search, to the JAX package's
`ivf_search_serving` with its Pallas kernel in interpret mode (ids equal,
scores within rtol 1e-5), on seeded numpy inputs: heavy sharing, ties
across clusters probed at different ranks, ties within a cluster across a
row-split border, integer scores that overflow the buffers, padding rows
and k above the probed rows. This file imports JAX only inside the test
that runs it, so the card tests can import `h100_layout` and `_probe_case`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu_torch.index import ivf_serving as ts
from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
    INT_MAX,
    _plan,
    ivf_probe_scores_plain,
    ivf_probe_topk_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import NEG_INF, quantize_corpus_sq8
from test_torch_mips_select import h100_layout as mips_layout

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-4)
TILE = 128  # cluster rows per tile, and the slots of a candidate buffer
NQ = 8  # queries of a run scored at a time
H100_SMS = 132


def h100_layout(dtype: torch.dtype, k: int = 10):
    """``layout()`` → (queries per chunk, cluster rows per tile, shared
    bytes, CTAs per SM) of K8 on an H100, as ``ivf_probe_topk_layout``
    reports it there. A bf16 or int8 payload goes through the score tile
    and K1's selector at 8 queries and 128-row tiles, so its shared memory
    is K1's there (`test_torch_mips_select.h100_layout`); an f32
    payload stages the same three slabs of 128 rows with the chunk's 8
    query slabs in f32 (32 dims, 144 bytes a row padded) beside the same
    selector. CTAs per SM by shared memory (228 KB an SM, 1 KB reserved
    per CTA) and at most 3 (the kernel is built for 3, at most 85 registers
    a thread)."""
    def layout():
        if dtype == torch.float32:
            smem = 3 * (TILE + NQ) * 144 + NQ * (8 * TILE + 8 * k + 8) + 16
        else:
            smem = mips_layout("mips_topk", dtype, k)(NQ)[2]
        return NQ, TILE, smem, min(3, 233472 // (smem + 1024))
    return layout


def runs(probes: torch.Tensor) -> list[tuple[int, list[int]]]:
    """The kernel's grouping of [B, nprobe] probes → [(head, members)]: an
    entry b·nprobe + p heads a run when no earlier entry probes its
    cluster, and its members are the entries from it on that probe the
    same cluster, ascending."""
    flat = probes.reshape(-1).tolist()
    out = []
    for e, c in enumerate(flat):
        if c not in flat[:e]:
            out.append((e, [i for i in range(e, len(flat)) if flat[i] == c]))
    return out


def _merge(vals, pos, k):
    """The warp merge's rule: k rounds of (largest value, the lowest
    position holding it, every equal value dropped); exhausted rounds give
    (-3e38, INT_MAX). Values of -3e38 or less are never taken."""
    out_v = torch.full((k,), NEG_INF)
    out_p = torch.full((k,), INT_MAX, dtype=torch.int64)
    live = vals > NEG_INF
    vals, pos = vals[live], pos[live]
    for r in range(k):
        if vals.numel() == 0:
            break
        m = vals.max()
        hit = vals == m
        out_v[r], out_p[r] = m, pos[hit].min()
        vals, pos = vals[~hit], pos[~hit]
    return out_v, out_p


def emulate(q, clustered, bias, scale, probes, k, sms=H100_SMS, seed=0, stats=None):
    """K8 on the CPU in the kernel's order → (vals [B, k] f32, positions
    [B, k] int32). ``seed`` draws the winners of an overflowing buffer's
    slots; ``stats`` counts the runs, the chunks, the overflows and the
    clusters read."""
    b, p = probes.shape
    L = clustered.shape[1]
    scores = ivf_probe_scores_plain(q, clustered, bias, scale, probes).reshape(b, p, L)
    rows_per_split, splits = _plan(b, p, L, sms, h100_layout(clustered.dtype, k))
    groups = runs(probes)
    gen = torch.Generator().manual_seed(seed)
    stats = {} if stats is None else stats
    for key in ("runs", "chunks", "overflows"):
        stats.setdefault(key, 0)
    part_v = torch.full((b * p, splits, k), NEG_INF)
    part_p = torch.full((b * p, splits, k), INT_MAX, dtype=torch.int64)
    for _, members in groups:
        stats["runs"] += 1
        for sp in range(splits):
            start, stop = sp * rows_per_split, min(L, (sp + 1) * rows_per_split)
            for e0 in range(0, len(members), NQ):
                chunk = members[e0:e0 + NQ]
                stats["chunks"] += 1
                lv = {e: torch.full((k,), NEG_INF) for e in chunk}
                lp = {e: torch.full((k,), INT_MAX, dtype=torch.int64) for e in chunk}
                buf = {e: ([], []) for e in chunk}

                def flush():
                    for e in chunk:
                        if buf[e][0]:
                            lv[e], lp[e] = _merge(torch.cat([torch.stack(buf[e][0]), lv[e]]),
                                                  torch.cat([torch.stack(buf[e][1]), lp[e]]),
                                                  k)
                            buf[e] = ([], [])

                for r0 in range(start, stop, TILE):
                    rows = torch.arange(r0, min(stop, r0 + TILE))
                    tile = {e: scores[e // p, e % p, rows] for e in chunk}
                    if not any(bool((tile[e] > lv[e][k - 1]).any()) for e in chunk):
                        continue  # the CTA's vote
                    again = False
                    while True:
                        overflow = half = False
                        for e in chunk:
                            sv, th = tile[e], lv[e][k - 1]
                            take = (sv > th) | (again & (sv == th) & (sv > NEG_INF))
                            cand = take.nonzero().flatten()
                            room = TILE - len(buf[e][0])
                            if len(cand) > room:  # the scheduler's pick of the winners
                                overflow = True
                                cand = cand[torch.randperm(len(cand), generator=gen)[:room]]
                            buf[e][0].extend(sv[cand])
                            buf[e][1].extend((e % p) * L + rows[cand])
                            half |= len(buf[e][0]) > TILE // 2
                        if not (overflow or half):
                            break
                        stats["overflows"] += int(overflow)
                        flush()
                        if not overflow:
                            break
                        again = True
                flush()
                for e in chunk:
                    part_v[e, sp], part_p[e, sp] = lv[e], lp[e]
    stats["clusters_read"] = len(groups)
    out_v = torch.empty((b, k))
    out_p = torch.empty((b, k), dtype=torch.int32)
    for i in range(b):
        v, pp = _merge(part_v[i * p:(i + 1) * p].reshape(-1), part_p[i * p:(i + 1) * p].reshape(-1),
                       k)
        out_v[i], out_p[i] = v, pp.to(torch.int32)
    return out_v, out_p


def _probe_case(dtype, seed, c=24, L=600, d=32, b=5, p=4, integer=False, shared=True):
    """Payload, bias and scale of ``c`` clusters of ``L`` slots (the last 37
    padding, bias -3e38), queries and probes. With ``shared`` every query
    probes the same p clusters at its own permutation of the ranks, except
    that query 0's last probe is a cluster no other query probes. Row 2 of
    the first shared cluster is repeated in another shared cluster (a tie
    across clusters at different ranks) and rows 383 and 384 of a cluster
    are equal (a tie across the border of 384-row splits). ``integer``: one-hot
    queries over small integer rows, so scores tie everywhere, and slots
    63-127 padding: a buffer holds 63 candidates after the first tile and
    overflows on the rising second."""
    rng = np.random.default_rng(seed)
    if integer:
        e = rng.integers(-3, 4, (c, L, d)).astype(np.float32)
        e[:, 128:256, 0] = np.arange(128) // 4  # rising ties: every row a candidate
        q = np.eye(d, dtype=np.float32)[rng.integers(0, 3, b)]
        bias = np.zeros((c, L), np.float32)
    else:
        e = rng.standard_normal((c, L, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
        bias = (0.1 * rng.standard_normal((c, L))).astype(np.float32)
    shared_set = rng.choice(c - 1, p, replace=False) + 1
    if shared:
        probes = np.stack([rng.permutation(shared_set) for _ in range(b)])
        probes[0, -1] = 0  # a cluster probed by one query only
    else:
        probes = np.stack([rng.choice(c, p, replace=False) for _ in range(b)])
    c0, c1 = shared_set[0], shared_set[1]
    e[c1, 40], bias[c1, 40] = e[c0, 2], bias[c0, 2]
    e[c0, 384], bias[c0, 384] = e[c0, 383], bias[c0, 383]
    if b > 2:
        q[1] = 4.0 * e[c0, 2]  # query 1's best row is the cross-cluster tie
        q[2] = 4.0 * e[c0, 383]  # query 2's best row is the tie across the border
    bias[:, L - 37:] = NEG_INF
    if integer:  # 63 candidates in a buffer after the first tile, then 128 more
        bias[:, 63:128] = NEG_INF
    payload, scale = torch.from_numpy(e), None
    if dtype == "int8":
        q8, s8 = quantize_corpus_sq8(payload.reshape(c * L, d))
        payload, scale = q8.reshape(c, L, d), s8.reshape(c, L)
        if integer:
            payload, scale = torch.from_numpy(e).to(torch.int8), None
    else:
        payload = payload.to(getattr(torch, dtype))
    return (torch.from_numpy(q), payload.contiguous(), torch.from_numpy(bias), scale,
            torch.from_numpy(probes.astype(np.int32)))


def test_runs_rebuild_every_query_s_probes():
    """Heavy sharing: every query probes the same clusters at its own ranks,
    one cluster by one query only. Each cluster heads one run, at its first
    entry; the runs hold each entry once, ascending, one per query; and
    they give back every query's probe list."""
    for seed in range(4):
        _, _, _, _, probes = _probe_case("float32", seed, b=7, p=6)
        b, p = probes.shape
        groups = runs(probes)
        flat = probes.reshape(-1)
        assert len(groups) == len(torch.unique(probes)) == p + 1
        assert sorted(e for _, m in groups for e in m) == list(range(b * p))
        rebuilt = torch.full((b, p), -1, dtype=torch.int32)
        for head, members in groups:
            assert members[0] == head and members == sorted(members)
            assert len({e // p for e in members}) == len(members)
            assert int(flat[head]) not in flat[:head].tolist()
            for e in members:
                rebuilt[e // p, e % p] = flat[head]
        assert torch.equal(rebuilt, probes)
        assert sum(1 for _, m in groups if len(m) == 1) == 1


def test_plan_covers_every_row_in_whole_tiles():
    """`_plan` on the H100 stand-in: splits of whole tiles, at least two
    unless the cluster has one, that cover L; as many as one wave of CTAs
    holds when the probes are fewer than the card's CTA slots, about four
    waves when they are more."""
    for b, p, L in [(4, 32, 1536), (16, 32, 1536), (1, 1, 300), (2, 3, 129), (40, 8, 97)]:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            layout = h100_layout(dtype)
            rows, splits = _plan(b, p, L, H100_SMS, layout)
            tiles = -(-L // TILE)
            assert rows % TILE == 0 and (rows >= 2 * TILE or tiles == 1)
            assert (splits - 1) * rows < L <= splits * rows
            slots = H100_SMS * layout()[3]
            if b * p <= slots:
                assert splits * b * p <= slots or splits == 1
            else:
                assert splits <= -(-4 * slots // (b * p))
    assert _plan(4, 32, 1536, H100_SMS, h100_layout(torch.int8)) == (512, 3)
    assert _plan(16, 32, 1536, H100_SMS, h100_layout(torch.int8)) == (384, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("seed,integer,shared,b,p,k", [
    (0, False, True, 5, 4, 10), (1, False, False, 3, 4, 1), (2, True, True, 20, 14, 10),
    (3, True, True, 2, 4, 128), (4, False, True, 1, 4, 40)])
def test_emulation_matches_the_plain_version(dtype, seed, integer, shared, b, p, k):
    """The kernel's order against `ivf_probe_topk_plain`: positions equal,
    values to f32 summation-order noise. B = 20 spans three chunks of 8
    queries and its integer scores overflow the buffers (a split holds the
    first two tiles); k = 128 is above the real rows of some runs."""
    args = _probe_case(dtype, seed, b=b, p=p, integer=integer, shared=shared)
    stats = {}
    vals, pos = emulate(*args, k, seed=seed, stats=stats)
    ref_v, ref_p = ivf_probe_topk_plain(*args, k)
    assert torch.equal(pos, ref_p)
    torch.testing.assert_close(vals, ref_v, **TOL)
    assert stats["clusters_read"] == len(torch.unique(args[4]))
    if b == 20:
        assert stats["overflows"] > 0
        assert stats["chunks"] > stats["runs"]  # runs of more than 8 queries


def test_ties_go_to_the_earlier_rank_and_the_lower_slot():
    """Query 1's best value sits in two clusters probed at different ranks:
    the earlier rank's position wins in every query's own ranking. Query
    2's best value sits in slots 383 and 384 of one cluster, in two splits:
    slot 383 wins."""
    q, e, bias, scale, probes = _probe_case("float32", 7, b=3, p=4)
    L = e.shape[1]
    assert _plan(3, 4, L, H100_SMS, h100_layout(e.dtype)) == (384, 2)
    vals, pos = emulate(q, e, bias, scale, probes, 5)
    scores = ivf_probe_scores_plain(q, e, bias, scale, probes)
    holders = (scores[1] == scores[1].max()).nonzero().flatten().tolist()
    assert len(holders) == 2 and holders[0] // L != holders[1] // L
    assert int(pos[1, 0]) == holders[0]  # the earlier of the two ranks
    holders = (scores[2] == scores[2].max()).nonzero().flatten().tolist()
    assert [h % L for h in holders] == [383, 384] and int(pos[2, 0]) == holders[0]
    assert torch.equal(pos, ivf_probe_topk_plain(q, e, bias, scale, probes, 5)[1])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_emulated_search_matches_jax_interpret(monkeypatch, dtype):
    """The whole per-query search with the emulated K8 against the JAX
    package's `ivf_search_serving` (Pallas in interpret mode) on one index:
    ids exactly, scores to 1e-5 relative. Every query probes 6 of 16
    clusters, so clusters are shared; row 3 is also written into a cluster
    that query 0 probes later (a tie across clusters, in both packages'
    index)."""
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.index import ivf as jivf
    from retrieval_augmented_mds_tpu.index.ivf_serving import (
        ivf_search_serving as jax_ivf_search_serving,
    )

    from tests.test_torch_ivf import _clustered_data, _queries, port_ivf

    x = _clustered_data(seed=20)
    q = _queries(x, 6, 21)
    jdt = {"float32": jnp.float32, "int8": "int8"}[dtype]
    j = jivf.build_ivf_index(x, 16, dtype=jdt, seed=3, alpha=4.0, keep_flat=False)
    assert j.n_spill == 0
    t = port_ivf(j)
    # row 3 copied into a padding slot of another cluster query 0 probes
    probes = ts.probe_clusters(t, ts.prepare_queries(t, torch.from_numpy(q)), 6)
    assert len(torch.unique(probes)) < probes.numel()
    src = (t.clustered_ids == 3).nonzero()[0].tolist()
    dst_c = next(int(c) for c in reversed(probes[0].tolist()) if c != src[0])
    dst = [dst_c, int((t.clustered_ids[dst_c] == -1).nonzero()[0])]
    arrays = {f: np.array(getattr(j, f)) if getattr(j, f) is not None else None
              for f in ("clustered", "clustered_bias", "clustered_ids", "clustered_scale")}
    for f in ("clustered", "clustered_bias", "clustered_scale"):
        if arrays[f] is not None:
            arrays[f][tuple(dst)] = arrays[f][tuple(src)]
    arrays["clustered_ids"][tuple(dst)] = 5000  # another doc id, the same vector
    j = dataclasses.replace(j, **{f: jnp.asarray(v) for f, v in arrays.items()
                                  if v is not None})
    t = port_ivf(j)
    monkeypatch.setattr(ts, "ivf_probe_topk", lambda *a: emulate(*a))
    jv, ji = jax_ivf_search_serving(j, jnp.asarray(q), k=6, nprobe=6, interpret=True)
    tv, ti = ts.ivf_search_serving(t, torch.from_numpy(q), k=6, nprobe=6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=0)
