"""The premise of the dense backward's padding skip, held against the JAX
package's composite on the CPU.

The port's bf16 dense backward kernels (K5, K7) skip a key tile whose
every key bias is -1e9 for a block of rows that each have an open key:
there every p = exp(-1e9 + s - m) / l is 0 in f32, so the tile adds
exactly nothing to dq, dk or dv. Here `_dense_xla`'s VJP shows it on
numpy inputs with padded sources (S a multiple of 64 and not, causal and
not, one all-padding source): at the masked keys of a source with an open
key, dk and dv are exactly 0, and dq is the VJP taken over the open keys
alone. The port's plain backwards, which the card tests hold the kernels
to, agree with both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_dense import _dense_xla
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
    dense_backward_plain,
    dense_blocked_backward_plain,
    dense_rows_blocked_plain,
    dense_rows_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import row_delta

GRAD = dict(rtol=2e-4, atol=2e-4)

# (causal, T, S, source lengths): S a multiple of 64 and not; batch 1 an
# all-padding source; masked tails that span whole 64-key tiles
SHAPES = [
    (False, 40, 192, [100, 0, 192]),
    (False, 24, 200, [70, 0, 131]),
    (True, 96, 96, [96, 0, 50]),
    (True, 70, 70, [13, 0, 70]),
]


def _inputs(t, s, lengths, seed, nh=2, dh=8):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, g = (rng.standard_normal((b, nh, t, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(2))
    kb = np.where(np.arange(s)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, k, v, kb.astype(np.float32), g


def _vjp(q, k, v, kb, g, causal):
    """(dq, dk, dv) of `_dense_xla` at these inputs, as numpy."""
    _, vjp = jax.vjp(lambda a, b_, c: _dense_xla(a, b_, c, jnp.asarray(kb), causal),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal,t,s,lengths", SHAPES)
def test_masked_keys_pass_nothing_to_rows_with_an_open_key(causal, t, s, lengths):
    """The composite's VJP: dk = dv = 0 exactly at every masked key of a
    source with an open key, and dq equal (within 1e-6 x max|ref|, f32) to
    the VJP over that source's open keys alone, the masked ones dropped."""
    q, k, v, kb, g = _inputs(t, s, lengths, seed=5)
    dq, dk, dv = _vjp(q, k, v, kb, g, causal)
    for i, n in enumerate(lengths):
        if n == 0:  # all padding: every key reaches the uniform rows
            assert np.abs(dv[i]).min() > 0
            continue
        assert not dk[i][:, n:].any() and not dv[i][:, n:].any()
        cut = [x[i:i + 1, :, :n] for x in (k, v)]
        dq_open, dk_open, dv_open = _vjp(q[i:i + 1], *cut, kb[i:i + 1, :n], g[i:i + 1],
                                         causal)
        for a, r in ((dq[i], dq_open[0]), (dk[i][:, :n], dk_open[0]),
                     (dv[i][:, :n], dv_open[0])):
            np.testing.assert_allclose(a, r, rtol=0, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("causal,t,s,lengths", SHAPES)
def test_plain_backwards_follow_the_composite_on_padded_sources(causal, t, s, lengths):
    """K5's and K7's plain versions (from m, l and from one LSE per row)
    give the composite's VJP on every batch, the all-padding one included,
    and exact zeros for dk, dv at the masked keys of a source with an open
    key, as the skipped tiles leave them."""
    q, k, v, kb, g = _inputs(t, s, lengths, seed=6)
    truth = _vjp(q, k, v, kb, g, causal)
    tq, tk, tv, tkb, tg = map(torch.from_numpy, (q, k, v, kb, g))
    out, m, l = dense_rows_plain(tq, tk, tv, tkb, causal, return_stats=True)
    k5 = dense_backward_plain(tq, tk, tv, tkb, tg, m, l, row_delta(tg, out), causal)
    out_b, lse = dense_rows_blocked_plain(tq, tk, tv, tkb, causal)
    k7 = dense_blocked_backward_plain(tq, tk, tv, tkb, out_b, lse, tg, causal)
    for got in (k5, k7):
        for a, r in zip(got, truth):
            np.testing.assert_allclose(a.numpy(), r, **GRAD)
        for i, n in enumerate(lengths):
            if n:
                assert not got[1][i][:, n:].any() and not got[2][i][:, n:].any()
