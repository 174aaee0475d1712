"""The selection of kernel K1 (``csrc/mips_topk.cu``), emulated on the CPU.

The tensor-core K1 no longer merges every tile's scores into the running
top-k. Per (split, query) it keeps a list of up to k distinct values with
their lowest rows and a threshold (the list's k-th value, -3e38 while it
holds fewer). The rows are offered in parts of 128, in ascending order: a
score enters the query's candidate buffer (128 slots) only if it is
strictly greater than the threshold and its row is not ignored. When some
buffer of the CTA is half full after a part, or overflowed during one,
every buffer is merged into its list under the distinct-value, lowest-row
rule; after an overflow the part is offered again, every score at or above
the new threshold. Which scores win the slots of an overflowing buffer is
up to the card's scheduler. The per-split lists are merged across splits
by the same rule.

`emulate` does exactly that in torch, on the split layout `_splits` plans
from the kernel's layout on an H100 (`h100_layout`, which
``tests/test_torch_cuda.py`` holds to the kernel's own report on the card),
with the CTA's queries in lockstep and a seeded random choice of the
scores that win the slots of an overflowing buffer. The tests hold it
equal to `mips_topk_plain` and to the JAX package's `mips_topk` (its
Pallas kernel in interpret mode) on seeded numpy inputs, adversarial ones
among them, and on two real corpora: bag-of-words vectors of the committed
fixture's reference abstracts (integer scores, many exact ties and
duplicate rows) and the `bench-index` Gaussian mixture. Ids must be equal;
values within rtol 1e-5 and atol 1e-4 (f32 sums of the same products in
another order). They also check that `_splits` covers every row exactly
once, in whole tiles. This file imports JAX only inside `_jax`, so the card
tests can import `h100_layout` and `tie_after_overflow` from it.
"""

import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
    NEG_INF,
    _splits,
    mips_topk_plain,
    quantize_corpus_sq8,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-4)
PART = 128  # rows offered at a time, and the slots of a candidate buffer
H100_SMS = 132


def h100_layout(kernel: str, dtype: torch.dtype, k: int = 10):
    """``layout(nq)`` → (queries per CTA, corpus rows per tile, shared
    bytes, CTAs per SM) of ``kernel`` ("mips_topk" or "mips_chunkmax") on
    an H100, as its ``*_layout`` export reports it there, but with the CTAs
    per SM counted by shared memory alone (228 KB an SM, at most 227 KB a
    CTA, 1 KB reserved per CTA; 8 CTAs of 256 threads at most), not by
    registers."""
    def selector(nq):  # candidate buffers, lists, thresholds, counts, flags
        return nq * (8 * PART + 8 * k + 8) + 16

    def layout(nq):
        # the tensor-core tile in every dtype: 3 stages of 128-byte slabs of
        # the corpus rows and of the queries' same dims (32 f32 against f32
        # queries, 64 bf16 against bf16, 128 int8 against bf16), each row
        # padded by 16 bytes
        q, rows = nq, PART * (2 if nq >= 32 else 1)
        q_bytes = 2 * 128 if dtype == torch.int8 else 128
        smem = 3 * (rows * (128 + 16) + nq * (q_bytes + 16))
        smem += selector(nq) if kernel == "mips_topk" else nq * (rows + 4) * 4
        ctas = min(8, 233472 // (smem + 1024)) if smem <= 232448 else 0
        return q, rows, smem, ctas
    return layout


def _merge(vals, rows, k):
    """The warp merge's rule over candidates: k rounds of (largest value,
    the lowest row holding it, every equal value dropped); exhausted rounds
    give (-3e38, -1). Values of -3e38 or less are never taken."""
    out_v = torch.full((k,), NEG_INF)
    out_i = torch.full((k,), -1, dtype=torch.int64)
    live = vals > NEG_INF
    vals, rows = vals[live], rows[live]
    for r in range(k):
        if vals.numel() == 0:
            break
        m = vals.max()
        hit = vals == m
        out_v[r], out_i[r] = m, rows[hit].min()
        vals, rows = vals[~hit], rows[~hit]
    return out_v, out_i


def _scores(q, e, bias, scale):
    """The kernel's scores before the ignore test: (q . e) * scale + bias."""
    s = q.to(torch.bfloat16 if e.dtype == torch.int8 else e.dtype).float() @ e.float().T
    if scale is not None:
        s = s * scale[None, :]
    if bias is not None:
        s = s + bias[None, :]
    return s


def emulate(q, e, k, bias=None, ignore=None, scale=None, stats=None, sms=H100_SMS, seed=0):
    """K1's selection on the CPU, on the layout of an H100 with ``sms`` SMs
    → (vals [B, k], ids [B, k] int32). ``seed`` draws which candidates win
    the slots of an overflowing buffer; ``stats`` counts, summed over
    queries, the parts offered, the buffers merged and candidates offered,
    and the overflows of a CTA."""
    b, n = q.shape[0], e.shape[0]
    scores = _scores(q, e, bias, scale)
    nq, rows_per_split, splits = _splits(b, n, sms, h100_layout("mips_topk", e.dtype, k))
    gen = torch.Generator().manual_seed(seed)
    stats = {} if stats is None else stats
    for key in ("parts", "flushes", "overflows", "offered"):
        stats.setdefault(key, 0)
    ign = [torch.empty(0, dtype=torch.int64) if ignore is None else ignore[i].long()
           for i in range(b)]
    part_v = [[] for _ in range(b)]
    part_i = [[] for _ in range(b)]
    for qb0 in range(0, b, nq):
        group = range(qb0, min(b, qb0 + nq))
        for sp in range(splits):
            start, end = sp * rows_per_split, min(n, (sp + 1) * rows_per_split)
            lv = {i: torch.full((k,), NEG_INF) for i in group}
            li = {i: torch.full((k,), -1, dtype=torch.int64) for i in group}
            buf = {i: ([], []) for i in group}

            def flush():
                for i in group:
                    if buf[i][0]:
                        lv[i], li[i] = _merge(torch.cat([torch.stack(buf[i][0]), lv[i]]),
                                              torch.cat([torch.stack(buf[i][1]), li[i]]), k)
                        buf[i] = ([], [])
                        stats["flushes"] += 1

            for p0 in range(start, end, PART):
                rows = torch.arange(p0, min(end, p0 + PART))
                stats["parts"] += len(group)
                if not any(bool((scores[i, rows] > lv[i][k - 1]).any()) for i in group):
                    continue  # the CTA's vote: no score beats its threshold
                again = False
                while True:
                    overflow = half = False
                    for i in group:
                        s, th = scores[i, rows], lv[i][k - 1]
                        take = (s > th) | (again & (s == th) & (s > NEG_INF))
                        take &= ~torch.isin(rows, ign[i])
                        cand = take.nonzero().flatten()
                        stats["offered"] += len(cand)
                        room = PART - len(buf[i][0])
                        if len(cand) > room:  # the scheduler's pick of the winners
                            overflow = True
                            cand = cand[torch.randperm(len(cand), generator=gen)[:room]]
                        buf[i][0].extend(s[cand])
                        buf[i][1].extend(rows[cand])
                        half |= len(buf[i][0]) > PART // 2  # a slot at or past 64 taken
                    if not (overflow or half):
                        break
                    stats["overflows"] += int(overflow)
                    flush()
                    if not overflow:
                        break
                    again = True
            flush()
            for i in group:
                part_v[i].append(lv[i])
                part_i[i].append(li[i])
    out_v = torch.empty((b, k))
    out_i = torch.empty((b, k), dtype=torch.int32)
    for i in range(b):
        out_v[i], vi = _merge(torch.cat(part_v[i]), torch.cat(part_i[i]), k)
        out_i[i] = vi.to(torch.int32)
    return out_v, out_i


def tie_after_overflow(dtype: str, n: int):
    """8 queries whose buffers overflow with a tie at the k-th value (k =
    10), in the first split if it holds 256 rows or more → (queries [8, 16]
    f32, corpus [n, 16], bias [n], row scale or None, the true ids [8, 10]).

    Query b scores column b (one-hot queries, small integers: exact in
    every dtype). Rows 0-8 hold 9 distinct high values and rows 9-62 low
    ones; rows 63-127 have bias -3e38: the first part leaves 63 candidates
    in each buffer, below half. In the second part (rows 128-255) every
    score is a candidate: low ones, then the value 50 from row 128 + p_b on,
    with p_b spread over the four warps that offer a query's part. Its 128
    candidates overflow the 65 free slots; the merge puts 50 at the k-th
    place whenever one of its rows won a slot, and the second pass must
    offer the rows equal to that threshold, or a higher row of 50 than
    128 + p_b stays in the list. Every other row scores -100."""
    p = [0, 17, 31, 32, 63, 64, 96, 120]
    col = torch.full((n, 8), -100.0)
    col[:9] = (120.0 - torch.arange(9.0))[:, None]
    col[9:128] = -60.0
    for qb, pb in enumerate(p):
        col[128:256, qb] = torch.where(torch.arange(128) >= pb, 50.0, -60.0)
    bias = torch.zeros(n)
    bias[63:128] = NEG_INF
    e = torch.cat([col, torch.zeros((n, 8))], dim=1)
    scale = None
    if dtype == "int8":
        e, scale = e.to(torch.int8), torch.ones(n)
    else:
        e = e.to(getattr(torch, dtype))
    q = torch.eye(8, 16)
    ids = torch.cat([torch.arange(9).expand(8, 9),
                     128 + torch.tensor(p)[:, None]], dim=1).to(torch.int32)
    return q, e, bias, scale, ids


def _corpus(rng, n, d, dtype):
    e = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    if dtype == "int8":
        return quantize_corpus_sq8(e)
    return e.to(getattr(torch, dtype)), None


def _jax(q, e, k, bias, ignore, scale):
    """The JAX package's K1 (interpret mode on the CPU) on the same inputs."""
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.ops.mips_topk import mips_topk as jax_mips_topk

    je = jnp.asarray(e.numpy()) if e.dtype != torch.bfloat16 else jnp.asarray(
        e.float().numpy(), jnp.bfloat16)
    opt = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    jv, ji = jax_mips_topk(jnp.asarray(q.numpy()), je, k, row_bias=opt(bias),
                           ignore=opt(ignore), row_scale=opt(scale))
    return np.asarray(jv), np.asarray(ji)


def _check(q, e, k, bias=None, ignore=None, scale=None, jax=True, stats=None, sms=H100_SMS,
           seed=0):
    vals, ids = emulate(q, e, k, bias, ignore, scale, stats, sms, seed)
    ref_v, ref_i = mips_topk_plain(q, e, k, bias, ignore, scale)
    np.testing.assert_array_equal(ids.numpy(), ref_i.numpy())
    np.testing.assert_allclose(vals.numpy(), ref_v.numpy(), **TOL)
    if jax:
        jv, ji = _jax(q, e, k, bias, ignore, scale)
        np.testing.assert_array_equal(ids.numpy(), ji)
        np.testing.assert_allclose(vals.numpy(), jv, **TOL)
    return vals, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,n,d,k", [(4, 3001, 50, 10), (17, 2000, 96, 1),
                                     (9, 1500, 32, 128)])
def test_random_scores_match_plain_and_jax(dtype, b, n, d, k):
    """Seeded random inputs with a bias and ignore lists."""
    rng = np.random.default_rng(n + k)
    e, scale = _corpus(rng, n, d, dtype)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ign = torch.from_numpy(rng.integers(-1, n, (b, 4)).astype(np.int32))
    _check(q, e, k, bias, ign, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_filter_skips_most_tiles(dtype):
    """The premise of the redesign: once a split's list holds k values, few
    scores beat its threshold, so most parts end with no merge. One SM's
    layout, so that each split walks many parts."""
    rng = np.random.default_rng(17)
    n = 30000
    e, scale = _corpus(rng, n, 32, dtype)
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    stats = {}
    vals, ids = emulate(q, e, 10, None, None, scale, stats, sms=1)
    ref_v, ref_i = mips_topk_plain(q, e, 10, None, None, scale)
    np.testing.assert_array_equal(ids.numpy(), ref_i.numpy())
    np.testing.assert_allclose(vals.numpy(), ref_v.numpy(), **TOL)
    splits = _splits(4, n, 1, h100_layout("mips_topk", e.dtype))[2]
    assert stats["parts"] >= 4 * 10 * splits
    assert stats["flushes"] < stats["parts"] / 4
    # every row of a split's first part is offered; of the rest, few
    assert stats["offered"] - 4 * splits * PART < 0.05 * 4 * n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rising_scores_offer_every_row(dtype):
    """The filter's worst case: scores rise with the row index, every score
    beats the threshold and every part merges; still exact."""
    rng = np.random.default_rng(3)
    n = 1500
    e, scale = _corpus(rng, n, 32, dtype)
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    bias = 1000.0 * torch.arange(n, dtype=torch.float32)
    stats = {}
    vals, ids = _check(q, e, 10, bias, None, scale, stats=stats)
    assert stats["offered"] == 4 * n and stats["flushes"] >= stats["parts"]
    assert (ids == torch.arange(n - 1, n - 11, -1, dtype=torch.int32)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_buffer_overflow_offers_the_tile_again(dtype):
    """Parts that leave a buffer a quarter full (three quarters of their
    rows have bias -3e38) before full parts: the full part overflows the
    buffer, which is merged, and the part is offered again. k = 128 keeps
    the threshold at -3e38 until the list holds 128 values, so every real
    score of the first parts is a candidate. One SM's layout: splits of
    several parts; several draws of the slots' winners."""
    rng = np.random.default_rng(5)
    tile = PART
    n = 16 * tile
    e, scale = _corpus(rng, n, 32, dtype)
    q = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    bias = torch.zeros(n).reshape(8, 2, tile)
    bias[:, 0, tile // 4:] = NEG_INF  # even tiles: a quarter of their rows are scores
    bias = bias.reshape(n)
    ref_v, ref_i = mips_topk_plain(q, e, 128, bias, None, scale)
    for seed in range(3):
        stats = {}
        vals, ids = emulate(q, e, 128, bias, None, scale, stats, sms=1, seed=seed)
        np.testing.assert_array_equal(ids.numpy(), ref_i.numpy())
        np.testing.assert_allclose(vals.numpy(), ref_v.numpy(), **TOL)
        assert stats["overflows"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_identical_rows_and_split_borders(dtype):
    """All rows equal but a few: one hit at the lowest row holding the top
    value, copies of a row on both sides of every split border, and
    ignored ids that hold the true top hits."""
    rng = np.random.default_rng(11)
    b, n, d = 4, 5000, 32
    e, scale = _corpus(rng, n, d, dtype)
    _, rows, splits = _splits(b, n, H100_SMS, h100_layout("mips_topk", e.dtype))
    assert splits >= 3
    src = rows + 17
    copies = [s * rows + o for s in range(1, splits) for o in (-1, 0)
              if s * rows + o < n] + [src]
    e[copies] = e[src].clone()
    if scale is not None:
        scale[copies] = scale[src].clone()
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    q[0] = 3.0 * e[src].float() * (1.0 if scale is None else float(scale[src]))
    vals, ids = _check(q, e, 10)
    assert ids[0, 0] == rows - 1 and not np.isin(copies[1:], ids[0].numpy()).any()
    # the best five hits of every query ignored
    _, top = mips_topk_plain(q, e, 5, None, None, scale)
    vals, ids = _check(q, e, 10, None, top, scale)
    assert not bool((ids[:, :, None] == top[:, None, :]).any())
    # identical rows: one hit, then (-3e38, -1)
    same = e[:1].expand(n, d).contiguous()
    same_scale = None if scale is None else scale[:1].expand(n).contiguous()
    vals, ids = _check(q, same, 10, None, None, same_scale, jax=False)
    assert (ids[:, 0] == 0).all() and (ids[:, 1:] == -1).all()
    assert (vals[:, 1:] == NEG_INF).all()


def test_fewer_rows_than_k():
    rng = np.random.default_rng(2)
    e, _ = _corpus(rng, 5, 16, "bfloat16")
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    vals, ids = _check(q, e, 10)
    assert (ids[:, 5:] == -1).all() and (vals[:, 5:] == NEG_INF).all()


def _fixture_bow(vocab=256):
    """Bag-of-words count vectors (hash tokenizer) of the committed
    fixture's reference abstracts and of its abstracts as queries."""
    from retrieval_augmented_mds_tpu_torch.data.corpus import build_mips_corpus, load_fixture
    from retrieval_augmented_mds_tpu_torch.data.tokenizer import HashTokenizer

    df = load_fixture()
    texts = list(build_mips_corpus(df)["mips_column"])
    tok = HashTokenizer(vocab)

    def bow(batch):
        ids = tok(batch, max_length=256, add_special_tokens=False)["input_ids"]
        out = np.zeros((len(batch), vocab), np.float32)
        for i, row in enumerate(ids):
            np.add.at(out[i], row[row != tok.pad_id], 1.0)
        return torch.from_numpy(out)

    corpus = bow(texts)
    corpus = torch.cat([corpus, corpus[:40]])  # duplicate rows at the far end
    return bow(list(df["abstract"][:8])), corpus


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_real_corpus_fixture_bag_of_words(dtype):
    """Integer scores: many exact ties, and 40 rows repeated at the end."""
    q, corpus = _fixture_bow()
    if dtype == "int8":
        e, scale = quantize_corpus_sq8(corpus)
    else:
        e, scale = corpus.to(getattr(torch, dtype)), None
    _check(q, e, 16, None, None, scale)


def test_real_corpus_bench_index_mixture():
    """The `bench-index` Gaussian mixture, as bf16 and SQ8 payloads."""
    from retrieval_augmented_mds_tpu_torch.cli import gaussian_mixture

    x, qn = gaussian_mixture(6000, 64, 6, seed=0)
    q = torch.from_numpy(np.ascontiguousarray(qn))
    x = torch.from_numpy(x)
    _check(q, x.to(torch.bfloat16), 10)
    e, scale = quantize_corpus_sq8(x)
    _check(q, e, 10, None, None, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tie_at_the_threshold_after_an_overflow(dtype):
    """`tie_after_overflow`: the buffers overflow, and the value 50 that
    ends at the k-th place has rows in the part that lost the race for a
    slot. Over many draws of the winners the second pass, which offers the
    scores equal to the new threshold, returns the lowest row of 50; an
    emulation whose second pass offered only scores above the threshold
    returns a higher one in about half the draws."""
    q, e, bias, scale, want = tie_after_overflow(dtype, 4096)
    nq, rows, _ = _splits(8, 4096, 1, h100_layout("mips_topk", e.dtype))
    assert nq >= 8 and rows >= 2 * PART
    ref_v, ref_i = mips_topk_plain(q, e, 10, bias, None, scale)
    assert torch.equal(ref_i, want)
    for seed in range(12):
        stats = {}
        vals, ids = _check(q, e, 10, bias, None, scale, jax=seed == 0, stats=stats, sms=1,
                           seed=seed)
        assert stats["overflows"] >= 1
        assert torch.equal(ids, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,n,k", [(1, 1, 1), (4, 1 << 20, 10), (4, 466143, 14),
                                   (16, 1 << 20, 10), (17, 20000, 128),
                                   (256, 131072, 10), (256, 131072, 128), (40, 5003, 128)])
def test_splits_cover_every_row_once_in_whole_tiles(dtype, b, n, k):
    """The split layout on an H100: whole tiles, every row in exactly one
    split, no empty split, a query group that fits an SM (large k takes
    smaller groups), and no more (query group, split) CTAs than fill each
    SM once."""
    for kernel in ("mips_topk",) + (("mips_chunkmax",) if dtype != torch.int8 else ()):
        layout = h100_layout(kernel, dtype, k)
        nq, rows, splits = _splits(b, n, H100_SMS, layout)
        _, tile, smem, per_sm = layout(nq)
        assert rows % tile == 0 and splits * rows >= n > (splits - 1) * rows
        assert nq in (8, 16, 32, 64)
        assert per_sm >= 1 and smem <= 232448
        assert splits * -(-b // nq) <= max(H100_SMS * per_sm, -(-b // nq))
