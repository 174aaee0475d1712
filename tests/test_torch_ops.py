"""Parity of the port's kernel modules with the JAX package, on the CPU.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, or its XLA composite) and through the port's plain
PyTorch version, which is what a CPU tensor takes. Tolerances are f32
rtol=atol=1e-5 unless a test says otherwise. The CUDA kernels themselves
are compared with their plain versions in ``test_torch_cuda.py`` and by
``chip_smoke.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_dense import (
    _dense_xla,
    flash_dense_attention as jax_flash_dense,
    flash_dense_backward as jax_flash_dense_backward,
)
from retrieval_augmented_mds_tpu.ops.flash_sliding import (
    _local_rows_xla,
    flash_sliding_attention as jax_flash_sliding,
)
from retrieval_augmented_mds_tpu.ops.flash_sliding_bwd import (
    flash_sliding_backward as jax_flash_sliding_backward,
)
from retrieval_augmented_mds_tpu.ops.mips_topk import (
    mips_topk as jax_mips_topk,
    quantize_corpus_sq8 as jax_quantize,
)
from retrieval_augmented_mds_tpu.ops.sliding_attention import (
    sliding_attention_init,
    sliding_global_attention as jax_sliding_global_attention,
)
from retrieval_augmented_mds_tpu_torch.bridge import load_jax_params
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
    dense_backward_plain,
    dense_rows,
    dense_rows_plain,
    flash_dense_attention,
    flash_dense_backward,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
    flash_sliding_attention,
    local_rows_plain,
    row_delta,
    sliding_local_rows,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import (
    flash_sliding_backward,
    sliding_backward_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
    NEG_INF,
    mips_topk,
    mips_topk_plain,
    quantize_corpus_sq8,
)
from retrieval_augmented_mds_tpu_torch.ops.sliding_attention import (
    SlidingAttention,
    sliding_global_attention,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# K1: MIPS top-k
# ---------------------------------------------------------------------------

def _brute_distinct(scores: np.ndarray, k: int):
    """Independent reference of the distinct-value rule: the k largest
    distinct values, each with the lowest index holding it."""
    b = scores.shape[0]
    vals = np.full((b, k), NEG_INF, np.float32)
    ids = np.full((b, k), -1, np.int32)
    for i in range(b):
        row = scores[i]
        distinct = np.unique(row[row > NEG_INF])[::-1][:k]
        for r, v in enumerate(distinct):
            vals[i, r] = v
            ids[i, r] = int(np.flatnonzero(row == v)[0])
    return vals, ids


@pytest.mark.parametrize(
    "case,dtype,n,k",
    [
        ("plain", "f32", 300, 10),
        ("bias_ignore", "f32", 300, 10),
        ("plain", "bf16", 300, 10),
        ("sq8", "int8", 300, 10),
        ("plain", "f32", 300, 1),
        ("bias_ignore", "f32", 300, 128),
        ("duplicates", "f32", 300, 10),
        ("few_valid", "f32", 5, 10),
    ],
)
def test_mips_topk_plain_matches_jax_kernel(case, dtype, n, k):
    rng = np.random.default_rng(n + k)
    b, d = 6, 32
    q = rng.standard_normal((b, d)).astype(np.float32)
    e = rng.standard_normal((n, d)).astype(np.float32)
    if case == "duplicates":
        e[[7, 40, 41]] = e[3]  # three copies of row 3: one hit, id 3
        q[0] = e[3] * 3.0  # make row 3 the best hit of query 0
    bias = ignore = None
    if case == "bias_ignore":
        bias = rng.standard_normal(n).astype(np.float32)
        ignore = rng.integers(-1, n, (b, 4)).astype(np.int32)
        ignore[:, 0] = np.argmax(q @ e.T + bias, axis=1)  # drop the best hit
    jax_args = dict(row_bias=None if bias is None else jnp.asarray(bias),
                    ignore=None if ignore is None else jnp.asarray(ignore))
    t_args = dict(row_bias=None if bias is None else _t(bias),
                  ignore=None if ignore is None else _t(ignore))
    if dtype == "int8":
        qe, sc = jax_quantize(jnp.asarray(e))
        je, jscale = qe, sc
        te, tscale = quantize_corpus_sq8(_t(e))
        np.testing.assert_array_equal(te.numpy(), np.asarray(qe))
        np.testing.assert_allclose(tscale.numpy(), np.asarray(sc), **TOL)
    else:
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                    else (jnp.float32, torch.float32))
        je, jscale = jnp.asarray(e, jdt), None
        te, tscale = _t(e).to(tdt), None
    jv, ji = jax_mips_topk(jnp.asarray(q), je, k, row_scale=jscale, **jax_args)
    tv, ti = mips_topk(_t(q), te, k, row_scale=tscale, **t_args)

    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    if case == "duplicates":
        assert ti[0, 0] == 3 and not np.isin([7, 40, 41], ti.numpy()).any()
    if case == "few_valid":
        assert (ti[:, n:] == -1).all() and (tv[:, n:] == NEG_INF).all()
    if ignore is not None:
        hit = (ti.numpy()[:, :, None] == ignore[:, None, :]) & (ignore[:, None, :] >= 0)
        assert not hit.any()


def test_distinct_rule_matches_brute_force():
    rng = np.random.default_rng(5)
    # a coarse value grid makes exact ties common
    scores = rng.integers(-6, 6, (4, 200)).astype(np.float32)
    scores[0, 50:] = NEG_INF  # masked tail
    corpus = torch.eye(200)
    vals, ids = mips_topk_plain(_t(scores), corpus, 20)
    ref_v, ref_i = _brute_distinct(scores, 20)
    np.testing.assert_array_equal(ids.numpy(), ref_i)
    np.testing.assert_array_equal(vals.numpy(), ref_v)


def test_mips_topk_routes_cpu_to_plain():
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((3, 16)).astype(np.float32))
    e = _t(rng.standard_normal((50, 16)).astype(np.float32))
    before = mips_topk.launches
    for a, b in zip(mips_topk(q, e, 4), mips_topk_plain(q, e, 4)):
        assert torch.equal(a, b)
    assert mips_topk.launches == before  # CPU tensors never reach the kernel


# ---------------------------------------------------------------------------
# K2: sliding-window local rows
# ---------------------------------------------------------------------------

def _local_rows_inputs(dtype, b=3, nh=2, t=256, dh=16, g=4, seed=0):
    """Batch 0 normal; batch 1 with padded keys and an invalid global;
    batch 2 fully masked (every key and global)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nh, t, dh)).astype(np.float32) for _ in range(3))
    kg, vg = (rng.standard_normal((b, nh, g, dh)).astype(np.float32) for _ in range(2))
    key_bias = np.zeros((b, t), np.float32)
    key_bias[1, 180:] = -1e9
    key_bias[1, 5::17] = -1e9
    key_bias[2] = -1e9
    g_bias = np.zeros((b, g), np.float32)
    g_bias[1, -1] = -1e9
    g_bias[2] = -1e9
    return [x.astype(dtype) if x.ndim == 4 else x
            for x in (q, k, v, key_bias, kg, vg, g_bias)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("w", [64, 128])
def test_local_rows_plain_matches_jax_composite(dtype, tol, w):
    """All rows, the fully masked batch included (uniform over 3w + G
    columns in both). bf16: each side rounds its bf16 products once, at
    different places, so the tolerance is bf16 resolution."""
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    arrays = _local_rows_inputs(np_dt)
    ref = _local_rows_xla(*[jnp.asarray(a) for a in arrays], w)
    got = local_rows_plain(*[_t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
                             if a.ndim == 4 else _t(a) for a in arrays], w)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("w", [64, 128])
def test_local_rows_stats_match_pallas_kernel(w):
    """out, m and l against the Pallas kernel (interpret mode). The
    kernel's fully masked rows are uniform over its padded 3·128 + 128
    lanes rather than 3w + G, so batch 2 is compared for m only."""
    arrays = _local_rows_inputs(np.float32, seed=1)
    j_out, j_m, j_l = jax_flash_sliding(*[jnp.asarray(a) for a in arrays],
                                        window=w, interpret=True, return_stats=True)
    out, m, l = local_rows_plain(*[_t(a) for a in arrays], w, return_stats=True)
    nh = arrays[0].shape[1]
    live = slice(0, 2 * nh)  # batches 0 and 1, as [B*nh] rows
    np.testing.assert_allclose(out[:2].numpy(), np.asarray(j_out)[:2], **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m), **TOL)
    np.testing.assert_allclose(l[live].numpy(), np.asarray(j_l)[live], **TOL)
    assert (l[2 * nh:] == 3 * w + arrays[4].shape[2]).all()


def test_sliding_local_rows_routes_cpu_to_plain():
    arrays = [_t(a) for a in _local_rows_inputs(np.float32)]
    before = flash_sliding_attention.launches
    assert torch.equal(sliding_local_rows(*arrays, 64), local_rows_plain(*arrays, 64))
    assert flash_sliding_attention.launches == before


@pytest.mark.parametrize("max_globals", [1, 8])
def test_sliding_global_attention_matches_jax(max_globals):
    rng = np.random.default_rng(3)
    b, t, h, nh, w = 2, 128, 32, 2, 64
    params = sliding_attention_init(jax.random.PRNGKey(0), h)
    mod = load_jax_params(SlidingAttention(h), params)
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    pad = np.ones((b, t), np.int32)
    pad[1, 100:] = 0
    glob = np.zeros((b, t), np.int32)
    glob[:, 0] = 1
    glob[0, [10, 70]] = 1
    glob = glob * pad
    ref = jax_sliding_global_attention(params, jnp.asarray(x), nh, w, jnp.asarray(glob),
                                       jnp.asarray(pad), max_globals)
    got = sliding_global_attention(mod, _t(x), nh, w, _t(glob), _t(pad), max_globals)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# K3: the backward of the sliding-window local rows
# ---------------------------------------------------------------------------

_GRAD_ARGS = (0, 1, 2, 4, 5)  # q, k, v, kg, vg: the masks get no gradient


@pytest.mark.parametrize("w", [64, 128])
def test_sliding_backward_plain_matches_composite_vjp(w):
    """Every row, the fully masked batch (with a nonzero dO) included,
    against the VJP of the JAX composite; through `sliding_local_rows`'s
    autograd as well."""
    arrays = _local_rows_inputs(np.float32, seed=2)
    do = np.random.default_rng(7).standard_normal(arrays[0].shape).astype(np.float32)
    j = [jnp.asarray(a) for a in arrays]

    def fn(q, k, v, kg, vg):
        return _local_rows_xla(q, k, v, j[3], kg, vg, j[6], w)

    _, vjp = jax.vjp(fn, *[j[i] for i in _GRAD_ARGS])
    ref = vjp(jnp.asarray(do))
    t = [_t(a) for a in arrays]
    out, m, l = local_rows_plain(*t, w, return_stats=True)
    got = sliding_backward_plain(*t, _t(do), m, l, row_delta(_t(do), out), w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)

    leaves = [x.requires_grad_() if i in _GRAD_ARGS else x for i, x in enumerate(t)]
    sliding_local_rows(*leaves, w).backward(_t(do))
    for i, r in zip(_GRAD_ARGS, ref):
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(r), **TOL)
    assert flash_sliding_backward.launches == 0


@pytest.mark.parametrize("w", [64, 128])
def test_sliding_backward_plain_matches_pallas_kernel(w):
    """Against the Pallas backward (interpret mode), each fed its own
    forward's m and l. The kernel's fully masked rows are uniform over its
    padded lanes, not over 3w + G, so dO is zero on them (batch 2)."""
    arrays = _local_rows_inputs(np.float32, seed=3)
    do = np.random.default_rng(8).standard_normal(arrays[0].shape).astype(np.float32)
    do[2] = 0.0
    j = [jnp.asarray(a) for a in arrays]
    j_out, j_m, j_l = jax_flash_sliding(*j, window=w, interpret=True, return_stats=True)
    j_delta = jnp.sum(jnp.asarray(do) * j_out, axis=-1).reshape(-1, 1, j_out.shape[2])
    ref = jax_flash_sliding_backward(*j, jnp.asarray(do), j_m, j_l, j_delta, window=w,
                                     interpret=True)
    t = [_t(a) for a in arrays]
    out, m, l = local_rows_plain(*t, w, return_stats=True)
    got = sliding_backward_plain(*t, _t(do), m, l, row_delta(_t(do), out), w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ---------------------------------------------------------------------------
# K4/K5: dense attention rows, forward and backward
# ---------------------------------------------------------------------------

def _dense_inputs(t, s, full_mask, seed=0, b=2, nh=2, dh=16):
    """Batch 1 has a padded source tail; with ``full_mask`` batch 0 is an
    all-padding source (its rows are uniform over the S keys)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, t, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(2))
    key_bias = np.zeros((b, s), np.float32)
    key_bias[1, s // 2:] = -1e9
    if full_mask:
        key_bias[0] = -1e9
    do = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, key_bias, do


@pytest.mark.parametrize("causal,t,s,full_mask", [
    (False, 16, 128, False),
    (False, 24, 200, True),  # S not a multiple of 128
    (True, 32, 32, False),
    (True, 40, 40, True),
])
def test_dense_rows_plain_matches_composite(causal, t, s, full_mask):
    """Forward, m/l-based backward and `dense_rows`'s autograd against
    `_dense_xla` and its VJP; the key bias gets a zero gradient."""
    q, k, v, kb, do = _dense_inputs(t, s, full_mask)
    ref, vjp = jax.vjp(lambda a, b_, c: _dense_xla(a, b_, c, jnp.asarray(kb), causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    out, m, l = dense_rows_plain(_t(q), _t(k), _t(v), _t(kb), causal, return_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    got = dense_backward_plain(_t(q), _t(k), _t(v), _t(kb), _t(do), m, l,
                               row_delta(_t(do), out), causal)
    for g, r in zip(got, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)

    leaves = [_t(x).requires_grad_() for x in (q, k, v, kb)]
    dense_rows(*leaves, causal).backward(_t(do))
    for x, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **TOL)
    assert not leaves[3].grad.any()
    assert flash_dense_attention.launches == flash_dense_backward.launches == 0


@pytest.mark.parametrize("causal,t,s", [(False, 16, 128), (True, 16, 16),
                                        (False, 64, 256)])
def test_dense_rows_plain_matches_pallas_kernels(causal, t, s):
    """Against the Pallas forward and backward kernels (interpret mode)."""
    q, k, v, kb, do = _dense_inputs(t, s, full_mask=not causal, seed=1)
    j = [jnp.asarray(x) for x in (q, k, v, kb)]
    ref = jax_flash_dense(*j, causal=causal, interpret=True)
    ref_grads = jax_flash_dense_backward(*j, jnp.asarray(do), causal=causal,
                                         interpret=True)
    out, m, l = dense_rows_plain(*[_t(x) for x in (q, k, v, kb)], causal,
                                 return_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    got = dense_backward_plain(*[_t(x) for x in (q, k, v, kb, do)], m, l,
                               row_delta(_t(do), out), causal)
    for g, r in zip(got, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)
