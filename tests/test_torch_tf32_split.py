"""Split TF32 ("3xTF32") keeps the f32 sliding forward within the card's f32
tolerance, and one TF32 pass does not: an emulation on the CPU.

On the card the f32 K2/K3 run their products on the tensor cores as TF32
MMAs. A TF32 operand keeps 10 of f32's 23 mantissa bits (``cvt.rna``:
round to nearest, ties away from zero). Split TF32 writes each f32 operand
as hi = rna(x) and lo = rna(x - hi) and computes a product as
lo.hi' + hi.lo' + hi.hi', each term exact in f32 and summed in f32; the
dropped lo.lo' and lo's own rounding leave ~2^-21 of each |x y|. Here the
products of `local_rows_plain` (scores Q K^T, the global scores, P V and
P Vg, with P the unnormalised exp(s - m) as the kernel feeds it) are
replaced by that emulation on f32 bit patterns, at B=2, nh=2, T=128, w=32
(a 64-row block spans two w-blocks), G=2, dh=64, on a padded batch with a
valid global and a padded batch with none (its rows past length + w are
fully masked). The result is held to the JAX package's `_local_rows_xla`
on the same seeded numpy inputs within the card checks' tolerance (out
within 1e-4 x each row set's own max|ref|; m atol 1e-4 and l rtol 1e-4
against the port's f32 `local_rows_plain`, since the JAX composite does
not return them), and one TF32 pass is shown to miss it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_sliding import _local_rows_xla
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
    NEG_INF,
    _scale,
    local_rows_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.sliding_attention import _window_kv

TOL = 1e-4  # chip_smoke.py `_k2_case` and the card tests, for f32
B, NH, T, W, G, DH = 2, 2, 128, 32, 2, 64
LENGTHS = [80, 60]  # batch 0 has valid globals, batch 1 none
N_VALID = [2, 0]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 bit patterns: round the 13 low mantissa
    bits away, to nearest with ties away from zero (sign and magnitude:
    adding half of the dropped range to the bits rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)  # x - hi is exact in f32


def mm_split(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum in split TF32: the small terms first, as the kernels order
    their three MMAs."""
    (ah, al), (bh, bl) = split(a), split(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def mm_one_pass(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, tf32(a), tf32(b))


def rows_emulated(mm, q, k, v, key_bias, kg, vg, g_bias, w):
    """`local_rows_plain` with its products through ``mm``, in the
    kernel's order: scores of the unscaled q and k, then the scale and the
    bias; out = (P V + P Vg) / l with P = exp(s - m). Returns out
    [B, nh, T, dh], m and l [B, nh, T]."""
    b, nh, t, dh = q.shape
    nb = t // w
    qb = q.reshape(b, nh, nb, w, dh)
    kw, vw = _window_kv(k, nb, w), _window_kv(v, nb, w)
    band = mm("bhnqd,bhnkd->bhnqk", qb, kw) * _scale(dh)
    delta = torch.arange(3 * w)[None, :] - w - torch.arange(w)[:, None]
    k_pos = (torch.arange(nb)[:, None] - 1) * w + torch.arange(3 * w)[None, :]
    ok = ((delta.abs() <= w)[None, None, None]
          & ((k_pos >= 0) & (k_pos < t))[None, None, :, None, :])
    kb_w = _window_kv(key_bias[:, None, :, None], nb, w)[..., 0]
    band = torch.where(ok, band + kb_w[:, :, :, None, :], torch.tensor(NEG_INF))
    glog = mm("bhqd,bhgd->bhqg", q, kg) * _scale(dh) + g_bias[:, None, None, :]
    glog = glog.reshape(b, nh, nb, w, -1)
    m = torch.maximum(band.amax(-1, keepdim=True), glog.amax(-1, keepdim=True))
    eb, eg = torch.exp(band - m), torch.exp(glog - m)
    l = eb.sum(-1, keepdim=True) + eg.sum(-1, keepdim=True)
    pv = mm("bhnqk,bhnkd->bhnqd", eb, vw) + mm(
        "bhnqg,bhngd->bhnqd", eg, vg[:, :, None].expand(-1, -1, nb, -1, -1))
    out = pv / l
    return (out.reshape(b, nh, t, dh), m.reshape(b, nh, t), l.reshape(b, nh, t))


@pytest.fixture(scope="module")
def case():
    """Seeded numpy inputs; the JAX composite's out and the port's f32
    plain m and l on them; the three row sets of the card check."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((B, NH, T, DH)).astype(np.float32) for _ in range(3))
    kg_pos = np.stack([np.concatenate([[0], 1 + rng.choice(n - 1, G - 1, replace=False)])
                       for n in LENGTHS])
    padded = np.arange(T)[None, :] >= np.asarray(LENGTHS)[:, None]
    valid = np.arange(G)[None, :] < np.asarray(N_VALID)[:, None]
    is_global = np.zeros((B, T), bool)
    for i in range(B):
        is_global[i, kg_pos[i][valid[i]]] = True
    key_bias = np.where(padded | is_global, -1e9, 0.0).astype(np.float32)
    g_bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    take = lambda x: np.stack([x[i][:, kg_pos[i]] for i in range(B)])  # noqa: E731
    inputs = (q, k, v, key_bias, take(k), take(v), g_bias)
    ref = np.asarray(_local_rows_xla(*map(jnp.asarray, inputs), W))
    _, ref_m, ref_l = local_rows_plain(*map(torch.from_numpy, inputs), W, return_stats=True)
    with_global = valid.any(1, keepdims=True)
    sets = {"non-padded": ~padded, "padded, global": padded & with_global,
            "padded, no global": padded & ~with_global}
    return (inputs, ref, ref_m.reshape(B, NH, T).numpy(), ref_l.reshape(B, NH, T).numpy(),
            sets)


def _errors(mm, case) -> dict:
    """Each row set's max |out - ref| over its max|ref|, and the m and l
    errors, of the emulated products."""
    inputs, ref, ref_m, ref_l, sets = case
    out, m, l = (x.numpy() for x in rows_emulated(mm, *map(torch.from_numpy, inputs), W))
    errs = {}
    for name, rows in sets.items():
        sel = np.broadcast_to(rows[:, None, :, None], ref.shape)
        errs[name] = np.abs(out - ref)[sel].max() / np.abs(ref)[sel].max()
    errs["m"] = np.abs(m - ref_m).max()
    errs["l"] = (np.abs(l - ref_l) / ref_l).max()
    return errs


def test_rows_cover_every_set(case):
    """Each row set holds rows, and the batch with no valid global has
    fully masked rows (m = -1e9): the check reaches every branch."""
    _, _, ref_m, _, sets = case
    assert all(rows.any() for rows in sets.values())
    assert (ref_m[1] == np.float32(-1e9)).any()


def test_split_tf32_meets_the_f32_tolerance(case):
    errs = _errors(mm_split, case)
    for name in ("non-padded", "padded, global", "padded, no global"):
        assert errs[name] <= TOL, (name, errs)
    assert errs["m"] <= TOL and errs["l"] <= TOL, errs


def test_one_tf32_pass_misses_the_f32_tolerance(case):
    """The same rows with one TF32 product each: the scores lose ~2^-11 of
    |q||k|, so out on every row set, m and l all miss the tolerance (by
    ~4-13x here, where split TF32 stays below 2e-6)."""
    one, three = _errors(mm_one_pass, case), _errors(mm_split, case)
    assert all(err > TOL for err in one.values()), one
    assert all(one[k] > 100 * three[k] for k in one), (one, three)


def test_tf32_rounding_is_rna_on_the_bits():
    """rna keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds away from zero
    to 1 + 2^-10, 1 + 2^-12 to 1; the sign is kept; hi + lo is x to 2^-22."""
    x = torch.tensor([1 + 2.0**-11, 1 + 2.0**-12, -(1 + 2.0**-11), 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2.0**-10, 1.0, -(1 + 2.0**-10), 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo = split(y)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    assert ((hi + lo - y).abs() <= 2.0**-22 * y.abs()).all()
    assert ((hi - y).abs() > 2.0**-14 * y.abs()).any()
