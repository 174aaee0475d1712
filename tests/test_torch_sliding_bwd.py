"""The premises of the bf16 attention kernels' skips, held against the JAX
package's composites on the CPU.

The sliding-window backward (K3) computes no tile that adds exactly
nothing: a 64-row tile whose cotangent dO is all zero, and a band key tile
that the key bias masks whole, for rows that each have an open column.
Here the VJP of JAX `_local_rows_xla` shows both on numpy inputs with
padded keys, invalid globals, a batch with no valid global (its padded
rows are fully masked) and a window of 32 with T = 96 (a 64-key tile then
spans two w-blocks): dk = dv = 0 exactly at every masked key whose window
holds only rows with an open column; rows with a zero cotangent get dq = 0
exactly, and what they hold changes no other gradient by a bit. The
port's plain backward, which the card tests hold K3 to, does the same and
agrees with the VJP. The port's encoder attention hands the backward a dO
that is exactly zero at its padded rows and its valid global rows.

The long-source forward (K6) skips key tiles masked whole for blocks whose
rows each have an open key: `dense_rows_blocked_plain` over the open keys
alone gives those rows' out and lse over all S keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_sliding import _local_rows_xla
from retrieval_augmented_mds_tpu_torch.ops import flash_sliding as tsliding
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import dense_rows_blocked_plain
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import local_rows_plain, row_delta
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding_bwd import sliding_backward_plain
from retrieval_augmented_mds_tpu_torch.ops.sliding_attention import (
    sliding_attention_init,
    sliding_global_attention,
)

GRAD = dict(rtol=2e-4, atol=2e-4)

# (T, window, source lengths, valid globals): batch 0 open; batch 1 padded
# (all padding in the last shape); the last batch has no valid global, so
# its rows more than w past its source are fully masked
SHAPES = [
    (96, 32, [96, 50, 40], [3, 1, 0]),
    (192, 64, [192, 100, 70], [2, 2, 0]),
    (256, 128, [256, 0, 100], [1, 0, 0]),
]


def _inputs(t, w, lengths, n_valid, seed, nh=2, dh=8, g=4):
    """q/k/v/dO [B, nh, T, dh], kg/vg [B, nh, G, dh] f32; key_bias -1e9 at
    padded keys and at each batch's global tokens (masked out of the band,
    as the encoder masks them); g_bias -1e9 at invalid globals."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v, do = (rng.standard_normal((b, nh, t, dh)).astype(np.float32) for _ in range(4))
    kg, vg = (rng.standard_normal((b, nh, g, dh)).astype(np.float32) for _ in range(2))
    key_bias = np.where(np.arange(t)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    for i, n in enumerate(lengths):
        if n_valid[i]:
            key_bias[i, rng.choice(n, n_valid[i], replace=False)] = -1e9
    g_bias = np.where(np.arange(g)[None, :] < np.asarray(n_valid)[:, None], 0.0, -1e9)
    return q, k, v, key_bias.astype(np.float32), kg, vg, g_bias.astype(np.float32), do


def _jax_vjp(q, k, v, kb, kg, vg, gb, do, w):
    """(dq, dk, dv, dkg, dvg) of `_local_rows_xla`, as numpy."""
    f = lambda a, b_, c, d, e: _local_rows_xla(a, b_, c, jnp.asarray(kb), d, e,  # noqa: E731
                                               jnp.asarray(gb), w)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, kg, vg)))
    return [np.asarray(x) for x in vjp(jnp.asarray(do))]


def _port_backward(q, k, v, kb, kg, vg, gb, do, w):
    """(dq, dk, dv, dkg, dvg) of the port's plain forward and backward."""
    tq, tk, tv, tkb, tkg, tvg, tgb, tdo = map(torch.from_numpy, (q, k, v, kb, kg, vg, gb, do))
    out, m, l = local_rows_plain(tq, tk, tv, tkb, tkg, tvg, tgb, w, return_stats=True)
    got = sliding_backward_plain(tq, tk, tv, tkb, tkg, tvg, tgb, tdo, m, l,
                                 row_delta(tdo, out), w)
    return [x.numpy() for x in got]


def _quiet_keys(kb, gb, w):
    """[B, T] bool: masked keys whose window (w-blocks n - 1 .. n + 1 of the
    key's block n) holds only rows with an open column (an unmasked key
    within w, or a valid global)."""
    b, t = kb.shape
    pos = np.arange(t)
    band = np.abs(pos[:, None] - pos[None, :]) <= w
    row_open = (band[None] & (kb == 0)[:, None, :]).any(-1) | (gb == 0).any(-1)[:, None]
    window = np.abs(pos[:, None] // w - pos[None, :] // w) <= 1  # [row, key]
    all_open = ~(window[None] & ~row_open[:, :, None]).any(1)
    return (kb < 0) & all_open


def _zero_rows(lengths, kb, t):
    """[B, T] bool: the rows whose cotangent the encoder zeroes (padding)
    or overwrites (its global tokens)."""
    padded = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    return padded | ((kb < 0) & ~padded)


@pytest.mark.parametrize("t,w,lengths,n_valid", SHAPES)
def test_masked_keys_pass_nothing_to_rows_with_an_open_column(t, w, lengths, n_valid):
    """The composite's VJP and the port's plain backward: dk = dv = 0
    exactly at every masked key whose window holds only rows with an open
    column, in every batch (the one with no valid global included); the two
    agree on all five gradients."""
    args = _inputs(t, w, lengths, n_valid, seed=3)
    kb, gb = args[3], args[6]
    truth = _jax_vjp(*args, w)
    port = _port_backward(*args, w)
    quiet = _quiet_keys(kb, gb, w)
    assert quiet.any()
    for grads in (truth, port):
        for i in range(len(lengths)):
            assert not grads[1][i][:, quiet[i]].any() and not grads[2][i][:, quiet[i]].any()
    # the last batch's fully masked rows reach dv of every key of their window
    assert np.abs(truth[2][-1][:, -w:]).min() > 0
    for a, r in zip(port, truth):
        np.testing.assert_allclose(a, r, **GRAD)


@pytest.mark.parametrize("t,w,lengths,n_valid", SHAPES)
def test_zero_cotangent_rows_add_nothing(t, w, lengths, n_valid):
    """Rows whose cotangent is zero (here the padded rows and the global
    tokens, as the encoder makes them) get dq = 0 exactly, and new values
    in their queries change none of dk, dv, dkg, dvg by a bit: each of
    their terms is an exact zero. The composite's VJP and the port's plain
    backward alike."""
    q, k, v, kb, kg, vg, gb, do = _inputs(t, w, lengths, n_valid, seed=4)
    zero = _zero_rows(lengths, kb, t)
    do = np.where(zero[:, None, :, None], 0.0, do).astype(np.float32)
    q2 = np.where(zero[:, None, :, None],
                  np.random.default_rng(5).standard_normal(q.shape), q).astype(np.float32)
    for backward in (_jax_vjp, _port_backward):
        first = backward(q, k, v, kb, kg, vg, gb, do, w)
        second = backward(q2, k, v, kb, kg, vg, gb, do, w)
        for dq in (first[0], second[0]):
            assert not dq.transpose(0, 2, 1, 3)[zero].any()
        for a, b_ in zip(first[1:], second[1:]):
            np.testing.assert_array_equal(a, b_)


def test_encoder_hands_zero_cotangent_at_padded_and_global_rows(monkeypatch):
    """The port's `sliding_global_attention` on the CPU: the dO that
    `SlidingRows.backward` receives is exactly zero at the padded rows
    (their outputs are zeroed) and at the valid global rows (overwritten by
    the global attention), and nonzero elsewhere."""
    b, t, d_model, nh, w = 3, 96, 32, 4, 32
    gen = torch.Generator().manual_seed(0)
    p = sliding_attention_init(d_model, gen)
    x = torch.randn((b, t, d_model), generator=gen)
    lengths = torch.tensor([96, 50, 40])
    padding = (torch.arange(t)[None, :] < lengths[:, None]).to(torch.int32)
    glob = torch.zeros((b, t), dtype=torch.int32)
    glob[:, 0] = 1
    glob[0, [17, 60]] = 1
    glob[1, 33] = 1
    seen = []
    plain_backward = tsliding.SlidingRows.backward

    def spy(ctx, do):
        seen.append(do.detach().clone())
        return plain_backward(ctx, do)

    monkeypatch.setattr(tsliding.SlidingRows, "backward", staticmethod(spy))
    out = sliding_global_attention(p, x, nh, w, glob, padding, max_globals=4)
    (out * torch.randn(out.shape, generator=gen)).sum().backward()
    (do,) = seen
    quiet = (padding == 0) | (glob == 1)  # [B, T]
    rows = do.abs().amax(dim=(1, 3))  # [B, T]
    assert not rows[quiet].any()
    assert bool((rows[~quiet] > 0).all())


# (causal, T, S, source lengths, a masked hole [lo, hi) in batch 0 or None)
DENSE = [
    (False, 24, 200, [150, 70, 131], (64, 128)),
    (False, 40, 256, [256, 1, 200], (0, 64)),
    (True, 96, 96, [96, 50, 70], None),
]


@pytest.mark.parametrize("causal,t,s,lengths,hole", DENSE)
def test_dense_rows_over_open_keys_alone(causal, t, s, lengths, hole):
    """K6's premise on its plain version: for every row with an open key,
    out and lse over the open keys alone equal those over all S keys, to
    1e-6 x max|ref| (the masked keys' exp(-1e9 + s - m) is 0 in f32)."""
    rng = np.random.default_rng(7)
    b, nh, dh = len(lengths), 2, 8
    q = torch.from_numpy(rng.standard_normal((b, nh, t, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, nh, s, dh)).astype(np.float32))
            for _ in range(2))
    open_ = torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]
    if hole:
        open_[0, hole[0]:hole[1]] = False
    kb = torch.where(open_, 0.0, -1e9)
    out, lse = dense_rows_blocked_plain(q, k, v, kb, causal)
    lse = lse.reshape(b, nh, t)
    for i in range(b):
        keys = torch.nonzero(open_[i]).flatten()
        if causal:  # open keys are a prefix: the positions stay the same
            assert int(keys.max()) == len(keys) - 1
        cut = [x[i:i + 1][:, :, keys] for x in (k, v)]
        ref, ref_lse = dense_rows_blocked_plain(q[i:i + 1], *cut, kb[i:i + 1, keys], causal)
        rows = (torch.arange(t) >= int(keys.min())) if causal else torch.ones(t, dtype=bool)
        for a, r in ((out[i][:, rows], ref[0][:, rows]),
                     (lse[i][:, rows], ref_lse.reshape(nh, t)[:, rows])):
            torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * r.abs().max().item())
