"""The f32 MIPS score tile (K1, K10) in split TF32 keeps K1's and K10's f32
tolerances, and one TF32 pass does not: an emulation on the CPU.

On the card f32 K1 (``csrc/mips_topk.cu``) and f32 K10
(``csrc/mips_chunkmax.cu``) score the corpus on the tensor-core tile of
``csrc/mips_tile.cuh``: D in slabs of 32 dims, each slab in k-steps of 8,
each k-step three m16n8k8 TF32 MMAs (lo.hi', hi.lo', hi.hi' of the corpus
row and the query, ``cvt.rna`` splits, `tests/test_torch_tf32_split.py`).
The tensor cores add a k-step's products to their f32 accumulator cutting
toward zero, so each slab's product goes into a zeroed accumulator and is
added to the running score with an FADD (round to nearest); then the bias.
`tile_scores` does that on f32 bit patterns, each MMA through `mma`: the
products exact, the addends and the sum cut toward zero as the card's
tensor cores cut them (a model fitted to the card's f32 scores: it gives
their values at an f32 near-tie of `chip_smoke.py`'s `f32_k128`, not
every score bit for bit), the slab sums added in f32. Its scores go through K1's selection
(`_distinct_topk`, the rule the kernel's exact filter keeps) and through
K10's chunk maxima and the port's phase 2 (`chunk_topk`).

Seeded numpy inputs (B = 16 queries over N = 1500 rows, bias, 4 ignored
ids a query, the best hit of each query among them) at D = 768 and at
D = 769 (the retriever's l2 route: a last slab of one dim), held to the
JAX package's `mips_topk` and `mips_topk_blocked` in interpret mode: ids
equal and values within rtol 1e-5, atol 1e-4 (K1's card check); the
scores within 1e-4 x max|ref| of the f64 scores (K10's card check). One
TF32 pass is shown to miss both. One truncating accumulator over the whole
of D = 768 (288 MMAs, no slab sums) is measured too: it holds both
tolerances here, K1's values at 0.74 of their tolerance against the slab
sums' 0.11 (`test_one_truncating_accumulator_over_d768`).
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.mips_topk import mips_topk as jax_mips_topk
from retrieval_augmented_mds_tpu.ops.mips_topk import mips_topk_blocked as jax_blocked
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
    CHUNK,
    NEG_INF,
    _distinct_topk,
    chunk_topk,
    mips_topk_plain,
)
from tests.test_torch_tf32_split import split, tf32

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-4)  # f32 K1: chip_smoke.py `_k1_case`, the card tests
SCORE_TOL = 1e-4  # x max|ref|: f32 K10, chip_smoke.py `_k10_case`
SLAB, KSTEP = 32, 8  # dims of a slab (128 bytes of f32) and of an m16n8k8 k-step
B, N, K, N_IGNORE = 16, 1500, 10, 4
TIME_LIMIT_S = 120  # each test; ~2-6 s on one core


@pytest.fixture(autouse=True)
def time_limit():
    t0 = time.perf_counter()
    yield
    assert time.perf_counter() - t0 <= TIME_LIMIT_S, f"took over {TIME_LIMIT_S} s"


def rz(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero: to nearest, then one step back
    toward zero where that went past x in magnitude."""
    r = x.float()
    past = r.double().abs() > x.abs()
    return torch.where(past, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 TF32 MMA for every (query, row): c [B, N] f32 plus the 8
    products of b [B, 8] and a [N, 8] (TF32 values), as the tensor cores
    add them: each product exact, every addend (c too) cut toward zero to
    a multiple of 2^(e - 25), e the exponent of the largest addend, the
    sum exact, then cut toward zero to f32. (A model, fitted to f32 scores
    of the card.)"""
    terms = torch.cat([c.double()[..., None], b.double()[:, None, :] * a.double()[None]], -1)
    mag = terms.abs().amax(-1, keepdim=True)
    unit = torch.pow(2.0, torch.floor(torch.log2(torch.where(mag > 0, mag, 1.0))) - 25)
    return rz((torch.trunc(terms / unit) * unit).sum(-1))


def tile_scores(q, e, bias, ignore, *, one_pass=False, slab_sums=True):
    """The f32 tile's scores [B, N] = q . e + bias, ignored ids -3e38: each
    k-step's MMAs (three in split TF32, the small terms first; one TF32
    product with ``one_pass``) chained in a truncating accumulator, each
    slab in a zeroed one added to the score by FADD (``slab_sums``, the
    kernels) or all of D in one."""
    b, d = q.shape
    n = e.shape[0]
    dp = -(-d // SLAB) * SLAB  # dims past D load as zeros
    qp = torch.zeros((b, dp)).index_copy_(1, torch.arange(d), q)
    ep = torch.zeros((n, dp)).index_copy_(1, torch.arange(d), e)
    if one_pass:
        terms = [(tf32(ep), tf32(qp))]
    else:
        (eh, el), (qh, ql) = split(ep), split(qp)
        terms = [(el, qh), (eh, ql), (eh, qh)]  # A = corpus rows, B = queries
    acc = torch.zeros((b, n))
    part = torch.zeros((b, n))
    for s in range(dp // SLAB):
        if slab_sums:
            part = torch.zeros((b, n))
        for kk in range(s * SLAB, (s + 1) * SLAB, KSTEP):
            for a, bb in terms:
                part = mma(part, a[:, kk:kk + KSTEP], bb[:, kk:kk + KSTEP])
        if slab_sums:
            acc = acc + part  # f32, round to nearest
    scores = (acc if slab_sums else part) + bias[None, :]
    ign = ignore.long()
    rows = torch.arange(b)[:, None].expand_as(ign)
    scores[rows[ign >= 0], ign[ign >= 0]] = NEG_INF
    return scores


def k10_topk(scores, k):
    """K10's phase 1 on the tile's scores (N padded to whole chunks with
    -3e38, each chunk's maximum), then the port's phase 2."""
    b, n = scores.shape
    padded = torch.full((b, -(-n // CHUNK) * CHUNK), NEG_INF)
    padded[:, :n] = scores
    return chunk_topk(padded, padded.reshape(b, -1, CHUNK).amax(-1), k)


@functools.lru_cache(maxsize=None)
def make_case(d: int):
    """Seeded inputs at D; the f64 scores; the JAX package's `mips_topk`
    and `mips_topk_blocked` (interpret mode) on them."""
    rng = np.random.default_rng(14 + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    e = rng.standard_normal((N, d)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    ref64 = q.astype(np.float64) @ e.astype(np.float64).T + bias[None, :]
    ignore = rng.integers(-1, N, (B, N_IGNORE)).astype(np.int32)
    ignore[:, 0] = ref64.argmax(1)  # the true best hit must disappear
    for i in range(B):
        ref64[i, ignore[i][ignore[i] >= 0]] = NEG_INF
    jq, je, jb, ji = map(jnp.asarray, (q, e, bias, ignore))
    jax_k1 = [np.asarray(x) for x in jax_mips_topk(jq, je, K, row_bias=jb, ignore=ji)]
    jax_k10 = [np.asarray(x) for x in jax_blocked(jq, je, K, jb, ji, interpret=True)]
    inputs = tuple(map(torch.from_numpy, (q, e, bias, ignore)))
    return d, inputs, ref64, jax_k1, jax_k10


@pytest.fixture(params=[768, 769], ids=["d768", "d769"])
def case(request):
    return make_case(request.param)


def _score_err(scores, ref64) -> float:
    """max |scores - ref| over the unmasked cells, over max|ref|."""
    live = ref64 > NEG_INF / 2
    return float(np.abs(scores.numpy()[live] - ref64[live]).max() / np.abs(ref64[live]).max())


def _value_excess(vals, ref_vals) -> float:
    """max |vals - ref| / (atol + rtol |ref|): above 1 misses K1's check."""
    v, r = vals.numpy().astype(np.float64), ref_vals.astype(np.float64)
    return float((np.abs(v - r) / (TOL["atol"] + TOL["rtol"] * np.abs(r))).max())


def test_split_tf32_tile_meets_k1_and_k10_tolerances(case):
    d, inputs, ref64, (jv, ji), (bv, bi) = case
    scores = tile_scores(*inputs)
    live = ref64 > NEG_INF / 2
    assert np.array_equal(scores.numpy() > NEG_INF / 2, live)
    assert _score_err(scores, ref64) <= SCORE_TOL
    vals, ids = _distinct_topk(scores, K)  # K1
    np.testing.assert_array_equal(ids.numpy(), ji)
    np.testing.assert_allclose(vals.numpy(), jv, **TOL)
    np.testing.assert_array_equal(ids.numpy(), mips_topk_plain(*inputs[:2], K, *inputs[2:])[1])
    vals, ids = k10_topk(scores, K)  # K10, then phase 2
    np.testing.assert_array_equal(ids.numpy(), bi)
    np.testing.assert_allclose(vals.numpy(), bv, **TOL)
    assert not (ids.numpy()[:, :, None] == inputs[3].numpy()[:, None, :]).any()


def test_one_tf32_pass_misses_both_tolerances(case):
    """One TF32 product a k-step (each operand keeps 10 mantissa bits):
    the scores lose ~2^-11 of sum |q_i e_i|, so K1's values miss rtol
    1e-5 + atol 1e-4 by 26-34x and the scores 1e-4 x max|ref| by ~3x
    (3.0e-4), where split TF32 stays inside both (its values at ~0.1 of
    their tolerance, its scores within 3.6e-7 x max|ref|)."""
    d, inputs, ref64, (jv, _), _ = case
    one, three = tile_scores(*inputs, one_pass=True), tile_scores(*inputs)
    assert _score_err(one, ref64) > SCORE_TOL
    assert _score_err(one, ref64) > 100 * _score_err(three, ref64)
    excess = _value_excess(_distinct_topk(one, K)[0], jv)
    assert excess > 3 and excess > 100 * _value_excess(_distinct_topk(three, K)[0], jv)


def test_one_truncating_accumulator_over_d768():
    """All of D in one accumulator cut toward zero (288 MMAs at D = 768, no
    slab sums): the truncation drifts the scores toward zero by ~half an
    ulp of the running sum per MMA. At D = 768 that still holds both
    tolerances: its top values come out low by up to 6.3e-4, 0.74 of rtol
    1e-5 + atol 1e-4 (the slab sums': 0.11), its scores within 5.5e-6 x
    max|ref| (the slab sums': 3.6e-7). The drift grows with D, so the
    kernels sum each slab apart."""
    _, inputs, ref64, (jv, ji), _ = make_case(768)
    one_acc, slabs = tile_scores(*inputs, slab_sums=False), tile_scores(*inputs)
    err_one, err_slabs = _score_err(one_acc, ref64), _score_err(slabs, ref64)
    assert err_one <= SCORE_TOL and err_one > 10 * err_slabs, (err_one, err_slabs)
    vals, ids = _distinct_topk(one_acc, K)
    np.testing.assert_array_equal(ids.numpy(), ji)
    excess = _value_excess(vals, jv)
    assert 0.5 < excess <= 1, excess
    # the drift is toward zero: the top values come out low
    assert (vals.numpy() <= jv).all()


def test_rz_cuts_toward_zero():
    """rz keeps an f32 value, and rounds a value between two f32 numbers
    to the one nearer zero, on both signs."""
    x = torch.tensor([1.0, 1 + 2.0**-24, 1 + 3 * 2.0**-24, -(1 + 3 * 2.0**-24), 2.0**-30],
                     dtype=torch.float64)
    assert rz(x).tolist() == [1.0, 1.0, 1 + 2.0**-23, -(1 + 2.0**-23), 2.0**-30]


def test_mma_cuts_addends_and_sum_toward_zero():
    """An addend below 2^-25 of the largest is cut away; the sum is cut,
    not rounded, to f32 (1 + 0.75 ulp gives 1, where rounding gives
    1 + ulp); exact sums stay exact, on both signs."""
    one = torch.ones((1, 1))
    a = torch.zeros((1, 8))
    b = torch.zeros((1, 8))
    a[0, 0], b[0, 0] = 2.0**-26, 1.0
    assert mma(one, a, b).item() == 1.0
    a[0, 0], a[0, 1], b[0, 1] = 2.0**-24, 2.0**-25, 1.0  # 0.75 ulp of 1
    assert mma(one, a, b).item() == 1.0 and (one + 0.75 * 2.0**-23).float().item() != 1.0
    a[0, :2] = torch.tensor([3.0, -0.5])
    assert mma(-one, a, b).item() == 1.5
