"""Split TF32 keeps the f32 dense attention (K4-K7) within the card's f32
tolerance, and one TF32 pass does not: an emulation on the CPU.

On the card the f32 K4/K6 forward and K5/K7 backward run their products
on the tensor cores as split-TF32 MMAs (`tests/test_torch_tf32_split.py`
emulates the rounding and holds the sliding kernels K2/K3 to it). Here the
products of `dense_rows_plain` (scores Q K^T of the unscaled q and k, then
P V with P the unnormalised exp(s - m), as the forward kernel feeds it) and
the five of `dense_backward_plain` (S = Q K^T and dP = dO V^T recomputed,
dV = P^T dO, dK = dS^T Q, dQ = dS K) go through that emulation, in two
routes: m and l (K4/K5) and one log-sum-exp per row (K6/K7, whose
backward reads a fully masked row, lse <= -1e8, as uniform over its S
keys). Cases: causal self-attention (B=2, nh=2, T=96, dh=64, a padded
tail in batch 1); cross-attention over S=160 with an all-padding batch,
in both routes; the long-source route at S=4608, B=1. The results are held
to the JAX package's `_dense_xla` and `jax.vjp` of it on the same seeded
numpy inputs, each output of each batch within 1e-4 x that batch's own
max|ref| (the card checks' tolerance; the all-padding batch is held to
the composite's uniform row, which the JAX blocked kernels get wrong), the
statistics against the port's f32 plain versions (m atol 1e-4, l rtol
1e-4, lse atol 1e-4); one TF32 pass is shown to miss.

What this does not model: the emulation sums the products with einsum's
round-to-nearest f32 accumulation, while the tensor cores' f32
accumulator truncates. Over many keys that truncation drifts (one
accumulator over S = 16384 keys missed 1e-4 x max|ref| on the card), so
the kernels sum each key tile's P V and dS K apart (`kTileSums` in
`csrc/attn_mma.cuh`). The longest case here is S = 4608; the cases at
S = 16384 in `tests/test_torch_cuda.py` (`test_dense_backward_on_tensor_cores`,
`test_blocked_forward_on_tensor_cores`) hold the kernels on the card to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu.ops.flash_dense import _dense_xla
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
    _stats_from_lse,
    dense_rows_blocked_plain,
    dense_rows_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import NEG_INF, _scale, row_delta
from tests.test_torch_tf32_split import mm_one_pass, mm_split

TOL = 1e-4  # chip_smoke.py `_grad_tol` and the card tests, for f32
NH, DH = 2, 64
# name: (T, S, causal, valid source tokens per batch, route: "ml" (K4/K5)
# or "lse" (K6/K7))
CASES = {
    "causal_self": (96, 96, True, [96, 70], "ml"),
    "cross_all_padding": (96, 160, False, [0, 100], "ml"),
    "cross_all_padding_lse": (96, 160, False, [0, 100], "lse"),
    "long_source_lse": (32, 4608, False, [3000], "lse"),
}


def forward_emulated(mm, q, k, v, key_bias, causal):
    """`dense_rows_plain` with its products through ``mm``, in the kernel's
    order: scores of the unscaled q and k, then the scale, the bias and the
    causal mask; out = (P V) / l with P = exp(s - m). Returns out, m, l
    (m and l [B, nh, T, 1])."""
    t, s = q.shape[2], k.shape[2]
    logits = mm("bhqd,bhkd->bhqk", q, k) * _scale(q.shape[-1]) + key_bias[:, None, None, :]
    if causal:
        ok = torch.arange(s)[None, :] <= torch.arange(t)[:, None]
        logits = torch.where(ok, logits, torch.tensor(NEG_INF))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(-1, keepdim=True)
    return mm("bhqk,bhkd->bhqd", e, v) / l, m, l


def backward_emulated(mm, q, k, v, key_bias, do, m, l, delta, causal):
    """`dense_backward_plain` with its five products through ``mm``: p
    recomputed from m and l, ds = p (dp - delta) (zero at causal-masked
    columns), dv = p^T dO, dk = ds^T q and dq = ds k, each times the scale
    at the end as the kernels store them."""
    t, s = q.shape[2], k.shape[2]
    scale = _scale(q.shape[-1])
    logits = mm("bhqd,bhkd->bhqk", q, k) * scale + key_bias[:, None, None, :]
    ok = torch.arange(s)[None, :] <= torch.arange(t)[:, None] if causal else None
    if causal:
        logits = torch.where(ok, logits, torch.tensor(NEG_INF))
    p = torch.exp(logits - m) / l
    ds = p * (mm("bhqd,bhkd->bhqk", do, v) - delta)
    if causal:
        ds = torch.where(ok, ds, torch.zeros(()))
    dv = mm("bhqk,bhqd->bhkd", p, do)
    dk = mm("bhqk,bhqd->bhkd", ds, q) * scale
    dq = mm("bhqk,bhkd->bhqd", ds, k) * scale
    return dq, dk, dv


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Seeded numpy inputs of one case; the JAX composite's out and its
    VJP (dq, dk, dv) on them; the port's f32 plain statistics."""
    t, s, causal, lengths, route = CASES[request.param]
    b = len(lengths)
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, NH, t, DH)).astype(np.float32)
    k, v = (rng.standard_normal((b, NH, s, DH)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, NH, t, DH)).astype(np.float32)
    key_bias = np.where(np.arange(s)[None, :] < np.asarray(lengths)[:, None], 0.0,
                        -1e9).astype(np.float32)
    kb = jnp.asarray(key_bias)
    ref_out, vjp = jax.vjp(lambda a, b_, c: _dense_xla(a, b_, c, kb, causal),
                           *map(jnp.asarray, (q, k, v)))
    ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    tq, tk, tv, tkb = map(torch.from_numpy, (q, k, v, key_bias))
    if route == "ml":
        _, ref_m, ref_l = dense_rows_plain(tq, tk, tv, tkb, causal, return_stats=True)
        stats = (ref_m.reshape(b, NH, t, 1).numpy(), ref_l.reshape(b, NH, t, 1).numpy())
    else:
        _, ref_lse = dense_rows_blocked_plain(tq, tk, tv, tkb, causal)
        stats = (ref_lse.reshape(b, NH, t, 1).numpy(),)
    return (request.param, (q, k, v, key_bias, do), np.asarray(ref_out), ref_grads, stats)


def _rel(got, ref) -> float:
    """The largest over the batches of max |got - ref| / max |ref|."""
    return max(float(np.abs(got[i] - ref[i]).max() / np.abs(ref[i]).max())
               for i in range(ref.shape[0]))


def _errors(mm, case) -> dict:
    """Each output's error relative to each batch's own max|ref|, and the
    statistics' errors, of the emulated products (through the case's
    route: m and l, or the LSE and its closed form of a fully masked
    row)."""
    name, inputs, ref_out, ref_grads, stats = case
    _, _, causal, _, route = CASES[name]
    q, k, v, key_bias, do = map(torch.from_numpy, inputs)
    out, m, l = forward_emulated(mm, q, k, v, key_bias, causal)
    errs = {"out": _rel(out.numpy(), ref_out)}
    if route == "ml":
        errs["m"] = float(np.abs(m.numpy() - stats[0]).max())
        errs["l"] = float((np.abs(l.numpy() - stats[1]) / stats[1]).max())
    else:
        lse = m + torch.log(l)
        errs["lse"] = float(np.abs(lse.numpy() - stats[0]).max())
        m, l = _stats_from_lse(lse, k.shape[2])
    delta = row_delta(do, out).reshape(*out.shape[:3], 1)
    grads = backward_emulated(mm, q, k, v, key_bias, do, m, l, delta, causal)
    for nm, got, ref in zip(("dq", "dk", "dv"), grads, ref_grads):
        errs[nm] = _rel(got.numpy(), ref)
    return errs


def test_cases_reach_every_branch(case):
    """The cross cases hold an all-padding batch (m = -1e9 in the plain
    version, lse <= -1e8 on the LSE route); every case's statistics and
    gradients are finite and not all zero."""
    name, _, ref_out, ref_grads, stats = case
    _, _, causal, lengths, route = CASES[name]
    for i, n in enumerate(lengths):
        if n == 0:
            assert (stats[0][i] == np.float32(-1e9)).all() if route == "ml" \
                else (stats[0][i] <= -1e8).all()
    assert all(np.isfinite(x).all() and np.abs(x).max() > 0 for x in (ref_out, *ref_grads))


def test_split_tf32_forward_meets_the_f32_tolerance(case):
    errs = _errors(mm_split, case)
    for nm in ("out", "m", "l", "lse"):
        if nm in errs:
            assert errs[nm] <= TOL, (nm, errs)


def test_split_tf32_backward_meets_the_f32_tolerance(case):
    errs = _errors(mm_split, case)
    for nm in ("dq", "dk", "dv"):
        assert errs[nm] <= TOL, (nm, errs)


def test_one_tf32_pass_misses_the_f32_tolerance(case):
    """The same products with one TF32 pass each: the scores lose ~2^-11 of
    |q||k|, so some output misses the tolerance, far above split TF32's
    error on it."""
    one, three = _errors(mm_one_pass, case), _errors(mm_split, case)
    worst = max(one, key=lambda nm: one[nm] / TOL)
    assert one[worst] > TOL, one
    assert one[worst] > 20 * three[worst], (one, three)
