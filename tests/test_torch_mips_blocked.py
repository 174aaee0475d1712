"""Parity of the port's two-phase exact MIPS top-k (`mips_topk_blocked`:
phase 1 `mips_chunkmax_plain`, what a CPU tensor takes in place of kernel
K10, then the plain `chunk_topk`) with the JAX package's
`mips_topk_blocked`, its Pallas phase 1 in interpret mode, on the CPU.

The same numpy inputs go to both. Ids must be equal; values within rtol
1e-5 (f32 sums of the same products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.mips_topk import mips_topk_blocked as jax_blocked
from retrieval_augmented_mds_tpu_torch.ops import mips_topk as tmips
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
    CHUNK,
    NEG_INF,
    chunk_topk,
    mips_chunkmax,
    mips_chunkmax_plain,
    mips_topk_blocked,
    mips_topk_plain,
)

torch.set_num_threads(1)


def _inputs(n, d, b, seed, bias=True, n_ignore=2):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    rb = rng.standard_normal(n).astype(np.float32) if bias else None
    ign = rng.integers(0, n, size=(b, n_ignore)).astype(np.int32) if n_ignore else None
    return q, e, rb, ign


def _both(q, e, k, rb, ign, dtype="float32"):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    opt = lambda x, f: None if x is None else f(x)  # noqa: E731
    jv, ji = jax_blocked(jnp.asarray(q), jnp.asarray(e).astype(jd), k,
                         opt(rb, jnp.asarray), opt(ign, jnp.asarray), interpret=True)
    tv, ti = mips_topk_blocked(torch.from_numpy(q), torch.from_numpy(e).to(td), k,
                               opt(rb, torch.from_numpy), opt(ign, torch.from_numpy))
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k,bias,n_ignore", [
    (4096, 64, 8, 10, True, 2),  # tests/test_mips_topk.py::test_blocked_matches_fused
    (777, 50, 3, 7, True, 2),    # ragged N: a last chunk of 9 columns
    (777, 50, 3, 7, False, 0),
    (5, 16, 2, 8, False, 0),     # k > N: slots of -3e38 get id -1
])
def test_blocked_topk_matches_jax(dtype, n, d, b, k, bias, n_ignore):
    q, e, rb, ign = _inputs(n, d, b, seed=7 + n, bias=bias, n_ignore=n_ignore)
    (jv, ji), (tv, ti) = _both(q, e, k, rb, ign, dtype)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    if ign is not None:
        assert not (ti[:, :, None] == ign[:, None, :]).any()


def test_duplicated_row_is_two_hits_lowest_index_first():
    """A row duplicated into another chunk, the best hit of every query:
    both copies come back, the lower index first, as in the JAX package
    (K1's `mips_topk` collapses them into one hit)."""
    q, e, _, _ = _inputs(1000, 32, 4, seed=3, bias=False, n_ignore=0)
    e[700] = e[90] = 100.0 * q.sum(0) / np.linalg.norm(q.sum(0))  # ahead for every query
    (jv, ji), (tv, ti) = _both(q, e, 5, None, None)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert (ti[:, 0] == 90).all() and (ti[:, 1] == 700).all()
    assert (tv[:, 0] == tv[:, 1]).all()
    _, k1 = mips_topk_plain(torch.from_numpy(q), torch.from_numpy(e), 5)
    assert (k1[:, 0] == 90).all() and not (k1 == 700).any()


def test_phase1_plain_writes_masked_scores_and_chunk_maxima():
    q, e, rb, ign = _inputs(300, 16, 3, seed=1)
    scores, cmax = mips_chunkmax_plain(*map(torch.from_numpy, (q, e, rb, ign)))
    assert scores.shape == (3, 384) and cmax.shape == (3, 3)
    ref = q @ e.T + rb[None, :]
    for i in range(3):
        ref[i, ign[i]] = NEG_INF
    np.testing.assert_allclose(scores[:, :300].numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (scores[:, 300:] == NEG_INF).all()
    np.testing.assert_array_equal(cmax.numpy(),
                                  scores.reshape(3, 3, CHUNK).amax(-1).numpy())


def test_cpu_takes_the_plain_phase1_and_the_kernel_wants_cuda(monkeypatch):
    seen = []
    plain = tmips.mips_chunkmax_plain
    monkeypatch.setattr(tmips, "mips_chunkmax_plain",
                        lambda *a: seen.append(1) or plain(*a))
    q, e, _, _ = _inputs(256, 16, 2, seed=2, bias=False, n_ignore=0)
    mips_topk_blocked(torch.from_numpy(q), torch.from_numpy(e), 3)
    assert seen == [1] and mips_chunkmax.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        mips_chunkmax(torch.from_numpy(q), torch.from_numpy(e))
    with pytest.raises(ValueError, match="exceeds"):
        chunk_topk(torch.zeros(1, CHUNK), torch.zeros(1, 1), CHUNK + 1)
