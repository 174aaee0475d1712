"""The premises of the bf16 attention forwards' skips, held against the JAX
package's composites on the CPU.

The sliding-window forward (K2) and the dense forward (K4) skip a key tile
that the key bias masks whole for a block of rows that each have an open
column: there every p = exp(-1e9 + s - m) is 0 in f32, so the tile adds
exactly nothing. K2 decides it from its inputs before the walk (it has no
m yet): every row of a batch with a valid global sees that global. Here,
on numpy inputs with padded keys, invalid globals, a batch with no valid
global and windows of 32 and 96 (a 64-row block then spans two w-blocks):

- new values (finite) of K and V at the masked keys leave the out, m and
  l of every row with an open column bit-equal, in `local_rows_plain`
  and `dense_rows_plain`, and the out of JAX `_local_rows_xla` and
  `_dense_xla`;
- a fully masked row is uniform over its 3w + G columns: its w-block's
  window (positions outside [0, T) count, with zero values) and the
  globals;
- the port's plain versions, which the card tests hold K2 and K4 to,
  agree with the JAX composites.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_dense import _dense_xla
from retrieval_augmented_mds_tpu.ops.flash_sliding import _local_rows_xla
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import dense_rows_plain
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import local_rows_plain

NEG = np.float32(-1e9)

# (T, window, source lengths, valid globals): batch 0 open with globals;
# batch 1 a padded source with a global; batch 2 a padded source with no
# valid global (its rows past length + w are fully masked); batch 3 all
# padding with no global
SHAPES = [
    (96, 32, [96, 50, 40, 0], [3, 1, 0, 0]),
    (224, 32, [224, 100, 70, 0], [2, 2, 0, 0]),
    (480, 96, [480, 200, 150, 0], [4, 1, 0, 0]),
    (256, 128, [256, 90, 60, 0], [1, 3, 0, 0]),
]


def _inputs(t, w, lengths, n_valid, seed, nh=2, dh=8, g=4):
    """q/k/v [B, nh, T, dh], kg/vg [B, nh, G, dh] f32; key_bias -1e9 at
    padded keys and at each batch's global tokens (masked out of the band,
    as the encoder masks them); g_bias -1e9 at invalid globals."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v = (rng.standard_normal((b, nh, t, dh)).astype(np.float32) for _ in range(3))
    kg, vg = (rng.standard_normal((b, nh, g, dh)).astype(np.float32) for _ in range(2))
    key_bias = np.where(np.arange(t)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    for i, n in enumerate(lengths):
        if n_valid[i]:
            key_bias[i, rng.choice(n, n_valid[i], replace=False)] = -1e9
    g_bias = np.where(np.arange(g)[None, :] < np.asarray(n_valid)[:, None], 0.0, -1e9)
    return q, k, v, key_bias.astype(np.float32), kg, vg, g_bias.astype(np.float32)


def _plain(q, k, v, kb, kg, vg, gb, w):
    """(out [B, nh, T, dh], m, l [B, nh, T]) of `local_rows_plain`, numpy."""
    out, m, l = local_rows_plain(*map(torch.from_numpy, (q, k, v, kb, kg, vg, gb)), w,
                                 return_stats=True)
    b, nh, t, _ = q.shape
    return out.numpy(), m.reshape(b, nh, t).numpy(), l.reshape(b, nh, t).numpy()


def _jax(q, k, v, kb, kg, vg, gb, w):
    return np.asarray(_local_rows_xla(*map(jnp.asarray, (q, k, v, kb, kg, vg, gb)), w))


def _row_open(kb, gb, w):
    """[B, T] bool: rows with an open column (an unmasked key within w, or
    a valid global)."""
    t = kb.shape[1]
    pos = np.arange(t)
    band = np.abs(pos[:, None] - pos[None, :]) <= w
    return (band[None] & (kb == 0)[:, None, :]).any(-1) | (gb == 0).any(-1)[:, None]


def _garbage_at_masked(x, masked, seed):
    """x [B, nh, N, dh] with new values (finite, x30) at masked [B, N]."""
    noise = 30 * np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)
    return np.where(masked[:, None, :, None], noise, x)


@pytest.mark.parametrize("t,w,lengths,n_valid", SHAPES)
def test_masked_keys_change_no_row_with_an_open_column(t, w, lengths, n_valid):
    """New K and V at every masked key (padding and global tokens) leave
    each row that has an open column bit-equal: out, m and l of the port's
    plain version, out of the JAX composite. A batch with a valid global
    has no other row; the fully masked rows of the others do change."""
    q, k, v, kb, kg, vg, gb = _inputs(t, w, lengths, n_valid, seed=1)
    masked = kb < 0
    k2, v2 = _garbage_at_masked(k, masked, 2), _garbage_at_masked(v, masked, 3)
    rows = _row_open(kb, gb, w)
    assert rows[np.asarray(n_valid) > 0].all() and not rows[-1].any()
    for before, after in zip(_plain(q, k, v, kb, kg, vg, gb, w),
                             _plain(q, k2, v2, kb, kg, vg, gb, w)):
        np.testing.assert_array_equal(np.moveaxis(before, 2, 1)[rows],
                                      np.moveaxis(after, 2, 1)[rows])
    before, after = _jax(q, k, v, kb, kg, vg, gb, w), _jax(q, k2, v2, kb, kg, vg, gb, w)
    np.testing.assert_array_equal(np.moveaxis(before, 2, 1)[rows],
                                  np.moveaxis(after, 2, 1)[rows])
    # the all-padding batch's rows are uniform over their window: they move
    assert not np.array_equal(before[-1], after[-1])


# (causal, T, S, source lengths): S a multiple of 64 and not; every row
# of the first batches has an open key (causal: key 0 is open); the last
# batch all padding
DENSE = [
    (False, 40, 192, [100, 64, 0]),
    (False, 24, 200, [70, 131, 0]),
    (True, 96, 96, [96, 50, 0]),
    (True, 70, 130, [13, 129, 0]),
]


@pytest.mark.parametrize("causal,t,s,lengths", DENSE)
def test_dense_masked_keys_change_no_row_with_an_open_key(causal, t, s, lengths):
    """K4's premise: new K and V at the padded keys of a source with an
    open key leave out, m and l of `dense_rows_plain` and out of
    `_dense_xla` bit-equal on every row; an all-padding source's rows,
    uniform over its S keys, change."""
    rng = np.random.default_rng(4)
    b, nh, dh = len(lengths), 2, 8
    q = rng.standard_normal((b, nh, t, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(2))
    kb = np.where(np.arange(s)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    kb = kb.astype(np.float32)
    masked = kb < 0
    k2, v2 = _garbage_at_masked(k, masked, 5), _garbage_at_masked(v, masked, 6)

    def port(k_, v_):
        got = dense_rows_plain(*map(torch.from_numpy, (q, k_, v_, kb)), causal,
                               return_stats=True)
        return [x.numpy().reshape(b, nh, t, -1) for x in got]

    def ref(k_, v_):
        return np.asarray(_dense_xla(*map(jnp.asarray, (q, k_, v_, kb)), causal))

    for before, after in [*zip(port(k, v), port(k2, v2)), (ref(k, v), ref(k2, v2))]:
        np.testing.assert_array_equal(before[:-1], after[:-1])
    for out, out2 in ((port(k, v)[0], port(k2, v2)[0]), (ref(k, v), ref(k2, v2))):
        assert not np.array_equal(out[-1], out2[-1])


@pytest.mark.parametrize("t,w", [(96, 32), (224, 32), (480, 96)])
def test_fully_masked_rows_are_uniform_over_their_window(t, w):
    """A batch with no open key and no valid global: each row comes out as
    the mean over its 3w + G columns, the values of its window keys inside
    [0, T) (those outside count as zeros) and of the globals; m = -1e9 and
    l = 3w + G. The port's plain version and the JAX composite."""
    q, k, v, kb, kg, vg, gb = _inputs(t, w, [0], [0], seed=7)
    g = kg.shape[2]
    out, m, l = _plain(q, k, v, kb, kg, vg, gb, w)
    want = np.empty_like(q)
    for r in range(t):
        lo, hi = max((r // w - 1) * w, 0), min((r // w + 2) * w, t)
        want[0, :, r] = (v[0, :, lo:hi].sum(1) + vg[0].sum(1)) / (3 * w + g)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_jax(q, k, v, kb, kg, vg, gb, w), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(m, NEG)
    np.testing.assert_array_equal(l, np.float32(3 * w + g))


@pytest.mark.parametrize("t,w,lengths,n_valid", SHAPES)
def test_plain_local_rows_match_the_composite(t, w, lengths, n_valid):
    """`local_rows_plain` against JAX `_local_rows_xla` (f32, 1e-5) on
    padded, global-less and all-padding batches."""
    args = _inputs(t, w, lengths, n_valid, seed=9)
    np.testing.assert_allclose(_plain(*args, w)[0], _jax(*args, w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal,t,s,lengths", DENSE)
def test_plain_dense_rows_match_the_composite(causal, t, s, lengths):
    """`dense_rows_plain` against JAX `_dense_xla` (f32, 1e-5), the
    all-padding source's uniform rows included."""
    rng = np.random.default_rng(10)
    b, nh, dh = len(lengths), 2, 8
    q = rng.standard_normal((b, nh, t, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(2))
    kb = np.where(np.arange(s)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    kb = kb.astype(np.float32)
    got = dense_rows_plain(*map(torch.from_numpy, (q, k, v, kb)), causal).numpy()
    want = np.asarray(_dense_xla(*map(jnp.asarray, (q, k, v, kb)), causal))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
