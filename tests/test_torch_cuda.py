"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os

import pytest
import torch

from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (
    MAX_S,
    dense_backward_plain,
    dense_blocked_backward_plain,
    dense_rows,
    dense_rows_blocked_plain,
    dense_rows_plain,
    flash_dense_attention,
    flash_dense_backward,
    flash_dense_blocked,
    flash_dense_blocked_backward,
)
from retrieval_augmented_mds_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_plain,
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
from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
    INT_MAX,
    ivf_probe_topk,
    ivf_probe_topk_plain,
)
from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
    mips_chunkmax,
    mips_chunkmax_plain,
    mips_topk,
    mips_topk_blocked,
    mips_topk_plain,
    quantize_corpus_sq8,
)
from retrieval_augmented_mds_tpu_torch.ops.adam8bit_update import (
    adam8bit_superleaf_update,
    adam8bit_superleaf_update_plain,
)
from retrieval_augmented_mds_tpu_torch.train import adam8bit as t8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_mips_kernel_matches_plain(gen, dtype, k):
    """Ids equal, values to f32 summation-order noise (rtol 1e-5, atol 1e-4),
    with bias, ignore lists, a ragged N and three duplicate rows."""
    q = torch.randn((40, 96), generator=gen, device="cuda")
    e = torch.randn((5003, 96), generator=gen, device="cuda")
    e[[10, 900, 4000]] = e[7].clone()
    q[0] = 3 * e[7]
    scale = None
    if dtype == "int8":
        e, scale = quantize_corpus_sq8(e)
    else:
        e = e.to(getattr(torch, dtype))
    bias = torch.randn(5003, generator=gen, device="cuda")
    bias[[10, 900, 4000]] = bias[7].clone()
    ign = torch.randint(-1, 5003, (40, 3), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals, ids = mips_topk(q, e, k, bias, ign, scale)
    ref_v, ref_i = mips_topk_plain(q, e, k, bias, ign, scale)
    assert torch.equal(ids, ref_i)
    torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)
    assert not torch.isin(torch.tensor([10, 900, 4000], device="cuda"), ids[0]).any()


def test_mips_kernel_pads_missing_hits(gen):
    q = torch.randn((3, 32), generator=gen, device="cuda")
    e = torch.randn((5, 32), generator=gen, device="cuda")
    vals, ids = mips_topk(q, e, 8)
    assert (ids[:, 5:] == -1).all() and (vals[:, 5:] == -3.0e38).all()
    assert torch.equal(ids, mips_topk_plain(q, e, 8)[1])


def test_mips_kernel_rejects_k_above_128(gen):
    q = torch.randn((2, 32), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        mips_topk(q, torch.randn((300, 32), generator=gen, device="cuda"), 129)


# ---------------------------------------------------------------------------
# K1 on the tensor cores (bf16, int8) and the threshold-filtered selection
# ---------------------------------------------------------------------------

def _corpus(gen, n, d, dtype):
    """A random [n, d] corpus of ``dtype`` → (corpus, row scale or None)."""
    e = torch.randn((n, d), generator=gen, device="cuda")
    if dtype == "int8":
        return quantize_corpus_sq8(e)
    return e.to(getattr(torch, dtype)), None


def _same_as_plain(q, e, k, bias=None, ign=None, scale=None):
    """K1 against `mips_topk_plain`: ids equal, values within rtol 1e-5 and
    atol 1e-4 (f32 sums of the same exact products in another order)."""
    vals, ids = mips_topk(q, e, k, bias, ign, scale)
    ref_v, ref_i = mips_topk_plain(q, e, k, bias, ign, scale)
    assert torch.equal(ids, ref_i)
    torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)
    return vals, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 4, 17, 256])
@pytest.mark.parametrize("d", [50, 96, 768])
def test_mips_kernel_query_groups_and_widths(gen, dtype, b, d):
    """Every query group (8, 16, 32, 64 queries a CTA) and both load paths
    (16-byte copies at D = 96 and 768; element copies at D = 50, whose rows
    are not 16-byte multiples), with bias, ignore lists and a ragged N."""
    e, scale = _corpus(gen, 4099, d, dtype)
    q = torch.randn((b, d), generator=gen, device="cuda")
    bias = torch.randn(4099, generator=gen, device="cuda")
    ign = torch.randint(-1, 4099, (b, 3), generator=gen, device="cuda", dtype=torch.int32)
    _same_as_plain(q, e, 10, bias, ign, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_mips_kernel_k(gen, dtype, k):
    e, scale = _corpus(gen, 20000, 96, dtype)
    q = torch.randn((17, 96), generator=gen, device="cuda")
    _same_as_plain(q, e, k, None, None, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_fewer_rows_than_k(gen, dtype):
    e, scale = _corpus(gen, 5, 50, dtype)
    q = torch.randn((4, 50), generator=gen, device="cuda")
    vals, ids = _same_as_plain(q, e, 10, None, None, scale)
    assert (ids[:, 5:] == -1).all() and (vals[:, 5:] == -3.0e38).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,k", [(4, 10), (64, 128)])
def test_mips_kernel_rising_scores(gen, dtype, b, k):
    """The worst case of the filter: scores rise with the row index (a bias
    step of 1000 over products of at most ~100), so every score beats the
    running threshold and every tile fills the candidate buffers."""
    n = 20000
    e, scale = _corpus(gen, n, 96, dtype)
    q = torch.randn((b, 96), generator=gen, device="cuda")
    bias = 1000.0 * torch.arange(n, device="cuda", dtype=torch.float32)
    vals, ids = _same_as_plain(q, e, k, bias, None, scale)
    want = torch.arange(n - 1, n - 1 - k, -1, device="cuda", dtype=torch.int32)
    assert torch.equal(ids, want.expand(b, k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_buffer_overflow(gen, dtype):
    """Tiles that leave the candidate buffers a quarter full (three quarters
    of their rows have bias -3e38) before full tiles, with k = 128 (the
    threshold stays at -3e38 until a list holds 128 values): the full
    tiles overflow the buffers, which are merged, and the part is offered
    again (tests/test_torch_mips_select.py counts the overflows). Small
    integers, so every score is an exact integer on both sides: many exact
    ties, which go to the lowest row, and no rounding near-ties. Three
    queries take 128-row tiles in every dtype."""
    tile = 128
    n = 300000 // (2 * tile) * 2 * tile
    small = lambda *shape: torch.randint(-3, 4, shape, generator=gen, device="cuda")  # noqa: E731
    e = small(n, 32).to(getattr(torch, dtype))
    scale = torch.ones(n, device="cuda") if dtype == "int8" else None
    q = small(3, 32).float()
    bias = torch.zeros((n // (2 * tile), 2, tile), device="cuda")
    bias[:, 0, tile // 4:] = -3.0e38
    _same_as_plain(q, e, 128, bias.reshape(n), None, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_tie_at_the_threshold_after_an_overflow(gen, dtype):
    """Buffers that overflow while the value that ends at the k-th place
    has rows in every warp that offers the part (tests/
    test_torch_mips_select.py `tie_after_overflow`): which rows win the
    slots is up to the scheduler, so 20 reruns, each with the lowest row of
    that value and ids equal to plain."""
    from test_torch_mips_select import tie_after_overflow

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import _k1_plan

    q, e, bias, scale, want = (None if t is None else t.cuda()
                               for t in tie_after_overflow(dtype, 300000))
    assert _k1_plan(q, e, 10)[1] >= 256  # the first split holds both parts
    ref_v, ref_i = mips_topk_plain(q, e, 10, bias, None, scale)
    assert torch.equal(ref_i, want)
    for _ in range(20):
        vals, ids = mips_topk(q, e, 10, bias, None, scale)
        assert torch.equal(ids, want)
        torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)


def test_mips_layout_matches_the_h100_stand_in(gen):
    """The layout each MIPS kernel instance reports (queries per CTA, rows
    per tile, shared bytes) equals the stand-in the CPU tests plan with, and
    its CTAs per SM, which count registers too, are no more than the
    stand-in's and zero exactly where the stand-in's are."""
    from test_torch_mips_select import h100_layout

    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import _DTYPE_CODE, _kernel_layout

    dev = torch.cuda.current_device()
    cases = [("mips_topk", dt, k) for dt in _DTYPE_CODE for k in (1, 10, 64, 128)]
    cases += [("mips_chunkmax", dt, 10) for dt in (torch.float32, torch.bfloat16)]
    for kernel, dt, k in cases:
        want = h100_layout(kernel, dt, k)
        for nq in (8, 16, 32, 64):
            for vec in (0, 1):
                args = (_DTYPE_CODE[dt], nq, vec) + ((k,) if kernel == "mips_topk" else ())
                got = _kernel_layout(kernel, dev, *args)
                w = want(nq)
                assert got[:3] == w[:3], (kernel, dt, k, nq, vec, got, w)
                assert (got[3] > 0) == (w[3] > 0) and got[3] <= w[3], (kernel, dt, k, nq, got, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_identical_rows(gen, dtype):
    """All rows equal: one hit at the lowest row (row 1 where row 0 is
    ignored), then (-3e38, -1)."""
    e, scale = _corpus(gen, 3000, 96, dtype)
    e = e[:1].expand(3000, 96).contiguous()
    if scale is not None:
        scale = scale[:1].expand(3000).contiguous()
    q = torch.randn((5, 96), generator=gen, device="cuda")
    ign = torch.tensor([[-1], [0], [-1], [0], [7]], dtype=torch.int32, device="cuda")
    vals, ids = _same_as_plain(q, e, 10, None, ign, scale)
    assert ids[:, 0].tolist() == [0, 1, 0, 1, 0]
    assert (ids[:, 1:] == -1).all() and (vals[:, 1:] == -3.0e38).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_duplicates_across_split_borders(gen, dtype):
    """Copies of one row on both sides of split borders: the lowest row
    wins, and the copies collapse into that one hit."""
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import _k1_plan

    n, b = 60000, 4
    e, scale = _corpus(gen, n, 96, dtype)
    _, rows, splits, _ = _k1_plan(torch.zeros((b, 96), device="cuda"), e, 10)
    assert splits >= 3
    src = 2 * rows + 5  # a row of the third split
    copies = [rows - 1, rows, 2 * rows - 1, 2 * rows, src]
    e[copies] = e[src].clone()
    if scale is not None:
        scale[copies] = scale[src].clone()
    q = torch.randn((b, 96), generator=gen, device="cuda")
    q[0] = 3.0 * e[src].float() * (1.0 if scale is None else float(scale[src]))
    vals, ids = _same_as_plain(q, e, 10, None, None, scale)
    assert ids[0, 0] == rows - 1
    assert not torch.isin(torch.tensor(copies[1:], device="cuda"), ids[0]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_ignores_the_true_top_hits(gen, dtype):
    """Ignored ids that hold the five best hits of every query: they never
    enter the selection, so they cannot raise its threshold either."""
    e, scale = _corpus(gen, 30000, 96, dtype)
    q = torch.randn((17, 96), generator=gen, device="cuda")
    _, top = mips_topk_plain(q, e, 5, None, None, scale)
    vals, ids = _same_as_plain(q, e, 10, None, top, scale)
    assert not bool((ids[:, :, None] == top[:, None, :]).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mips_kernel_reruns_are_bit_equal(gen, dtype):
    e, scale = _corpus(gen, 50000, 768, dtype)
    q = torch.randn((17, 768), generator=gen, device="cuda")
    bias = torch.randn(50000, generator=gen, device="cuda")
    first = mips_topk(q, e, 128, bias, None, scale)
    again = mips_topk(q, e, 128, bias, None, scale)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def _probe_inputs(gen, dtype, c=40, L=300, d=96, b=6, p=5):
    """Clusters with padded tail slots, a row repeated in one cluster and in
    another (equal scores: the lowest position wins), and each query's
    distinct probes in a random order."""
    e = torch.randn((c, L, d), generator=gen, device="cuda")
    e[3, 10] = e[3, 2].clone()
    e[7, 0] = e[3, 2].clone()
    bias = torch.randn((c, L), generator=gen, device="cuda")
    bias[3, 10] = bias[3, 2].clone()
    bias[7, 0] = bias[3, 2].clone()
    bias[:, L - 37:] = -3.0e38
    scale = None
    if dtype == "int8":
        from retrieval_augmented_mds_tpu_torch.ops.mips_topk import quantize_corpus_sq8

        q8, s8 = quantize_corpus_sq8(e.reshape(c * L, d))
        e, scale = q8.reshape(c, L, d).contiguous(), s8.reshape(c, L).contiguous()
    else:
        e = e.to(getattr(torch, dtype))
    probes = torch.stack([torch.randperm(c, generator=gen, device="cuda")[:p]
                          for _ in range(b)]).to(torch.int32)
    probes[0, :2] = torch.tensor([7, 3], device="cuda")
    q = torch.randn((b, d), generator=gen, device="cuda")
    return q, e, bias, scale, probes.contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_ivf_probe_kernel_matches_plain(gen, dtype, k):
    """K8 against its plain version: positions equal, values to f32
    summation-order noise (rtol 1e-5, atol 1e-4), with padded slots, three
    128-row tiles per cluster (one ragged) and duplicate rows."""
    args = _probe_inputs(gen, dtype)
    ivf_probe_topk.launches = 0
    vals, pos = ivf_probe_topk(*args, k)
    ref_v, ref_p = ivf_probe_topk_plain(*args, k)
    assert ivf_probe_topk.launches == 1
    assert torch.equal(pos, ref_p)
    torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)


def test_ivf_probe_kernel_pads_missing_hits(gen):
    """Fewer real rows than k: the rest are (-3e38, INT_MAX)."""
    q, e, bias, scale, probes = _probe_inputs(gen, "float32", c=8, L=20, d=32, b=2, p=2)
    bias[:, 5:] = -3.0e38
    vals, pos = ivf_probe_topk(q, e, bias, scale, probes, 16)
    assert (pos[:, 10:] == INT_MAX).all() and (vals[:, 10:] == -3.0e38).all()
    assert torch.equal(pos, ivf_probe_topk_plain(q, e, bias, scale, probes, 16)[1])


def _probe_case_on_card(dtype, seed, **kw):
    from test_torch_ivf_group import _probe_case

    return tuple(None if a is None else a.cuda() for a in _probe_case(dtype, seed, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("seed,integer,c,b,p,k", [
    (0, False, 64, 20, 3, 10), (2, True, 24, 20, 14, 10), (5, False, 24, 3, 4, 5),
    (6, False, 24, 9, 4, 128), (7, True, 24, 1, 4, 40)])
def test_ivf_probe_kernel_on_shared_clusters(gen, dtype, seed, integer, c, b, p, k):
    """K8 where queries share clusters (`tests/test_torch_ivf_group.py`'s
    cases): every query probes the same clusters at its own ranks but one;
    B = 20 above the 8 queries of a chunk (B * nprobe < C, as the route
    sends it, and at 280 probes of 24 clusters); a value in two clusters at
    different ranks (query 1) and in slots 383 and 384 of one cluster,
    across a split border (query 2); L = 600, not whole tiles, with 37
    padding slots; integer scores whose buffers overflow. Positions equal
    to the plain version's, values to f32 summation-order noise (rtol 1e-5,
    atol 1e-4)."""
    args = _probe_case_on_card(dtype, seed, c=c, b=b, p=p, integer=integer)
    ivf_probe_topk.launches = 0
    vals, pos = ivf_probe_topk(*args, k)
    ref_v, ref_p = ivf_probe_topk_plain(*args, k)
    assert ivf_probe_topk.launches == 1
    assert torch.equal(pos, ref_p)
    torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_probe_kernel_k128_over_few_rows(gen, dtype):
    """k = 128 over 2 probes of 30 real rows each, the other 270 slots
    padding (-3e38): 60 hits, then (-3e38, INT_MAX), as the plain version."""
    q, e, bias, scale, probes = _probe_inputs(gen, dtype, c=8, L=300, d=64, b=3, p=2)
    bias[:, 30:] = -3.0e38
    vals, pos = ivf_probe_topk(q, e, bias, scale, probes, 128)
    ref_v, ref_p = ivf_probe_topk_plain(q, e, bias, scale, probes, 128)
    assert torch.equal(pos, ref_p) and (pos[:, 60:] == INT_MAX).all()
    assert (vals[:, 60:] == -3.0e38).all()
    torch.testing.assert_close(vals, ref_v, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("k", [10, 128])
def test_ivf_layout_matches_the_h100_stand_in(gen, dtype, k):
    """The layout K8 reports (queries per chunk, rows per tile, shared
    bytes, CTAs per SM) equals the stand-in the CPU tests plan with."""
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import _DTYPE_CODE, _kernel_layout

    from test_torch_ivf_group import h100_layout

    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the stand-in is an H100 SXM")
    got = _kernel_layout("ivf_probe_topk", 0, _DTYPE_CODE[dtype], k)
    assert got == h100_layout(dtype, k)()


def test_ivf_probe_kernel_rejects_unaligned_dim(gen):
    q, e, bias, scale, probes = _probe_inputs(gen, "float32", d=40)
    with pytest.raises(ValueError, match="multiple of 16"):
        ivf_probe_topk(q, e, bias, scale, probes, 4)


def test_ivf_search_on_the_card_matches_the_cpu(gen):
    """An SQ8 IVF index built on the CPU and copied to the card: the
    per-query route (K8 + K1 on the spill) gives the CPU's ids."""
    from retrieval_augmented_mds_tpu_torch.index import index_to
    from retrieval_augmented_mds_tpu_torch.index.ivf import (
        build_ivf_index,
        ivf_route,
        ivf_search,
    )

    g = torch.Generator().manual_seed(1)
    centers = 5.0 * torch.randn((16, 64), generator=g)
    x = centers[torch.randint(0, 16, (4096,), generator=g)] + torch.randn((4096, 64),
                                                                          generator=g)
    q = x[:4] + 0.05 * torch.randn((4, 64), generator=g)
    ignore = torch.tensor([[0, -1], [1, 5], [2, -1], [3, 3]], dtype=torch.int32)
    cpu = build_ivf_index(x, 32, dtype="int8", alpha=1.0, keep_flat=False)
    card = index_to(cpu, "cuda")
    assert ivf_route(cpu, 4, 8, 4, 2) == "per_query" and cpu.n_spill > 0
    ivf_probe_topk.launches = mips_topk.launches = 0
    v_card, i_card = ivf_search(card, q.cuda(), k=8, nprobe=4, ignore=ignore.cuda())
    v_cpu, i_cpu = ivf_search(cpu, q, k=8, nprobe=4, ignore=ignore)
    assert (ivf_probe_topk.launches, mips_topk.launches) == (1, 1)
    assert torch.equal(i_card.cpu(), i_cpu)
    torch.testing.assert_close(v_card.cpu(), v_cpu, rtol=1e-5, atol=1e-4)


def _sliding_inputs(gen, dtype, b=3, nh=4, t=512, dh=64, g=8):
    """Batch 1 has padded keys and an invalid global; batch 2 is fully
    masked (every key and every global)."""
    q, k, v = (torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    kg, vg = (torch.randn((b, nh, g, dh), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    key_bias = torch.zeros((b, t), device="cuda")
    key_bias[1, 300:] = -1e9
    key_bias[1, 5::17] = -1e9
    key_bias[2] = -1e9
    g_bias = torch.zeros((b, g), device="cuda")
    g_bias[1, -1] = -1e9
    g_bias[2] = -1e9
    return q, k, v, key_bias, kg, vg, g_bias


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_sliding_kernel_matches_plain(gen, dh, dtype, tol):
    """out (atol 1e-4 f32 / 2e-2 bf16), m and l on every row, the fully
    masked ones included."""
    args = _sliding_inputs(gen, getattr(torch, dtype), dh=dh)
    out, m, l = flash_sliding_attention(*args, window=128, return_stats=True)
    ref, ref_m, ref_l = local_rows_plain(*args, 128, return_stats=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(m, ref_m, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=0.0)


def test_sliding_kernel_rejects_untiled_window(gen):
    args = _sliding_inputs(gen, torch.float32, t=480)
    with pytest.raises(ValueError, match="multiple"):
        flash_sliding_attention(*args, window=48)


def _close(got, ref, tol):
    """rtol = tol, atol = tol x each reference's own largest magnitude (no
    floor: gradients are far below 1): f32 summation order, or one bf16
    rounding of the result."""
    for a, r in zip(got, ref):
        atol = tol * r.float().abs().max().item()
        torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=atol)


@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_sliding_backward_kernel_matches_plain(gen, dh, dtype, tol, window):
    """K3 against the plain backward from the same m, l, delta: dq, dk, dv,
    dkg, dvg, with a fully masked batch whose dO is not zero."""
    args = _sliding_inputs(gen, getattr(torch, dtype), dh=dh)
    out, m, l = flash_sliding_attention(*args, window=window, return_stats=True)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    bwd = (*args, do, m, l, row_delta(do, out))
    got = flash_sliding_backward(*bwd, window=window)
    ref = sliding_backward_plain(*bwd, window)
    assert [x.dtype for x in got] == [x.dtype for x in ref]
    _close(got, ref, tol)


def test_sliding_backward_kernel_rejects_untiled_window(gen):
    args = _sliding_inputs(gen, torch.float32, t=480)
    out, m, l = local_rows_plain(*args, 48, return_stats=True)
    with pytest.raises(ValueError, match="multiple"):
        flash_sliding_backward(*args, out, m, l, row_delta(out, out), window=48)


def _dense_inputs(gen, dtype, t, s, dh, b=2, nh=3):
    """Batch 1 has a padded source tail; batch 0 is fully masked."""
    q = torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    key_bias = torch.zeros((b, s), device="cuda")
    key_bias[1, s // 2:] = -1e9
    key_bias[0] = -1e9
    return q, k, v, key_bias


@pytest.mark.parametrize("causal,t,s", [(True, 100, 100), (True, 64, 200),
                                        (False, 77, 300), (False, 32, 128)])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_dense_kernels_match_plain(gen, causal, t, s, dh, dtype, tol):
    """K4 (out, m, l) and K5 (dq, dk, dv from the same m, l, delta) against
    the plain versions, at ragged T and S, causal or not."""
    q, k, v, kb = _dense_inputs(gen, getattr(torch, dtype), t, s, dh)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    ref, ref_m, ref_l = dense_rows_plain(q, k, v, kb, causal, return_stats=True)
    _close([out], [ref], tol)
    torch.testing.assert_close(m, ref_m, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=0.0)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    bwd = (q, k, v, kb, do, m, l, row_delta(do, out))
    got = flash_dense_backward(*bwd, causal=causal)
    _close(got, dense_backward_plain(*bwd, causal), tol)


def test_dense_kernel_rejects_head_dim(gen):
    q, k, v, kb = _dense_inputs(gen, torch.float32, 8, 8, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_dense_attention(q, k, v, kb, causal=False)


def test_autograd_functions_launch_the_kernels(gen):
    """dense_rows and sliding_local_rows on CUDA tensors: forward and
    backward through K4/K5 and K2/K3, gradients equal to the CPU path's."""
    q, k, v, kb = _dense_inputs(gen, torch.float32, 40, 72, 32)
    args = _sliding_inputs(gen, torch.float32, dh=32)
    flash_dense_attention.launches = flash_dense_backward.launches = 0
    flash_sliding_attention.launches = flash_sliding_backward.launches = 0
    for dev in ("cuda", "cpu"):
        dq = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        ds = [x.detach().to(dev).requires_grad_() if i in (0, 1, 2, 4, 5) else x.to(dev)
              for i, x in enumerate(args)]
        loss = (dense_rows(*dq, kb.to(dev), True) ** 2).sum() \
            + (sliding_local_rows(*ds, 64) ** 2).sum()
        loss.backward()
        grads = [x.grad.cpu() for x in dq + [ds[i] for i in (0, 1, 2, 4, 5)]]
        if dev == "cuda":
            cuda_grads = grads
    _close(cuda_grads, grads, 1e-4)
    assert (flash_dense_attention.launches, flash_dense_backward.launches) == (1, 1)
    assert (flash_sliding_attention.launches, flash_sliding_backward.launches) == (1, 1)


# the baselines' shapes (f32, B=4, 16 heads, dh=64, as bart-large fine-tunes
# in `run_fit_baseline`): the encoder's self-attention over a 1024-token
# source at the fixture's padding, the decoder's causal self-attention over
# 512 target tokens, and its cross-attention over the source
BASELINE_LENGTHS = [743, 451, 306, 520]


@pytest.mark.parametrize("causal,t,s,lengths", [
    (False, 1024, 1024, BASELINE_LENGTHS), (True, 512, 512, [512] * 4),
    (False, 512, 1024, BASELINE_LENGTHS)], ids=["encoder_self", "decoder_self", "cross"])
def test_dense_kernels_at_the_baseline_shapes(gen, causal, t, s, lengths):
    """f32 K4 (out, m, l) and K5 (dq, dk, dv) against their plain versions
    at the BART baseline's three shapes, within 1e-4 x each output's max|ref|
    (m atol 1e-3, l rtol 1e-3); every row has an open key, so dk = dv = 0
    exactly at the masked keys."""
    b, nh, dh = 4, 16, 64
    q = torch.randn((b, nh, t, dh), generator=gen, device="cuda")
    k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda") for _ in range(2))
    pos = torch.arange(s, device="cuda")
    kb = torch.where(pos[None, :] < torch.tensor(lengths, device="cuda")[:, None], 0.0, -1e9)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    ref, ref_m, ref_l = dense_rows_plain(q, k, v, kb, causal, return_stats=True)
    _close([out], [ref], 1e-4)
    torch.testing.assert_close(m, ref_m, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=0.0)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    bwd = (q, k, v, kb, do, m, l, row_delta(do, out))
    got = flash_dense_backward(*bwd, causal=causal)
    _close(got, dense_backward_plain(*bwd, causal), 1e-4)
    masked = kb < 0
    for i in range(b):
        assert not got[1][i][:, masked[i]].any() and not got[2][i][:, masked[i]].any()


@pytest.mark.parametrize("family", ["bart", "t5"])
def test_baseline_step_on_the_card(gen, family):
    """One `make_seq2seq_train_step` step and greedy decoding of a small
    baseline on the card and on the CPU from one init: the losses within
    rtol 1e-4; BART launches K4 once per encoder layer and twice per
    decoder layer in the step (K5 as many) and once per encoder layer in
    the decoding; T5 launches no kernel."""
    from retrieval_augmented_mds_tpu_torch.models.bart import init_bart
    from retrieval_augmented_mds_tpu_torch.models.config import Seq2SeqConfig
    from retrieval_augmented_mds_tpu_torch.models.t5 import init_t5
    from retrieval_augmented_mds_tpu_torch.train.baseline import (
        make_seq2seq_train_step,
        seq2seq_greedy,
    )
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu_torch.train.trainer import TrainState

    cfg = Seq2SeqConfig(vocab_size=512, d_model=128, n_heads=2, enc_layers=2,
                        dec_layers=3, d_ffn=256, max_src_len=256, max_tgt_len=64)
    init = init_bart if family == "bart" else init_t5
    g = torch.Generator().manual_seed(0)
    batch = {"input_ids": torch.randint(4, 500, (3, 200), generator=g),
             "attention_mask": torch.ones((3, 200), dtype=torch.int32),
             "labels": torch.randint(4, 500, (3, 40), generator=g)}
    batch["attention_mask"][1, 130:] = 0
    losses = []
    for dev in ("cpu", "cuda"):
        model = init(cfg, torch.Generator().manual_seed(1)).to(dev)
        tx = build_optimizer(1e-3, 1, 10, grad_clip=0.1)
        step = make_seq2seq_train_step(family, cfg, tx)
        flash_dense_attention.launches = flash_dense_backward.launches = 0
        _, metrics = step(TrainState.create(model, tx), {k: x.to(dev) for k, x in batch.items()})
        losses.append(float(metrics["loss"]))
        trained = (flash_dense_attention.launches, flash_dense_backward.launches)
        ids = seq2seq_greedy(family, model, cfg, batch["input_ids"].to(dev),
                             batch["attention_mask"].to(dev), max_new_tokens=5)
        assert ids.shape == (3, 5) and ids.device.type == dev
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    want = ((per_step, per_step), per_step + cfg.enc_layers) if family == "bart" else ((0, 0), 0)
    assert (trained, flash_dense_attention.launches) == want
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]), losses


# ---------------------------------------------------------------------------
# K6/K7: dense attention rows over long sources, with one LSE per row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,t,s", [(False, 77, 300), (False, 32, 4500),
                                        (True, 100, 100), (True, 64, 200)])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_blocked_dense_kernels_match_plain(gen, causal, t, s, dh, dtype, tol):
    """K6 (out, lse) and K7 (dq, dk, dv from the same out, lse, g) against
    the plain versions, at ragged T and S (S not a multiple of the 32-key
    tile). Batch 0 is an all-padding source: its LSE rounds to -1e9 and
    K7 still gives the uniform row's gradients (the plain version's, which
    the CPU tests hold against the composite's VJP)."""
    q, k, v, kb = _dense_inputs(gen, getattr(torch, dtype), t, s, dh)
    out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
    ref, ref_lse = dense_rows_blocked_plain(q, k, v, kb, causal)
    _close([out], [ref], tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-3)
    if not causal:
        assert bool((lse[: q.shape[1]] <= -1e8).all())  # batch 0: fully masked
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = flash_dense_blocked_backward(q, k, v, kb, out, lse, g, causal=causal)
    want = dense_blocked_backward_plain(q, k, v, kb, out, lse, g, causal)
    assert [x.dtype for x in got] == [x.dtype for x in want]
    _close(got, want, tol)
    # the all-padding batch's dv: p = 1/S on every key, so each key gets
    # the mean over the rows of g (causal rows see it too: uniform over S)
    if not causal:
        dv0 = g[0].float().sum(1, keepdim=True).expand(-1, s, -1) / s
        _close([got[2][0]], [dv0], tol)


def _padded_bias(s, b=3):
    """Batch 0 all padding; batch 1 open but for a 64-key tile in the
    middle of S and a tail of whole 64-key tiles at its end; batch 2 open
    but for scattered keys (no tile masked whole)."""
    kb = torch.zeros((b, s), device="cuda")
    kb[0] = -1e9
    kb[1, 64:128] = -1e9
    kb[1, max(192, (s * 3 // 5) // 64 * 64):] = -1e9
    kb[2, 5::17] = -1e9
    return kb


# the operand policies of the attention kernels' tensor-core tiles and the
# tolerance of each against its plain version (relative to each output's
# own max|ref|): bf16 rounds P and dS as operands; f32 runs split TF32
DENSE_POLICIES = [("bfloat16", 2e-2), ("float32", 1e-4)]


@pytest.mark.parametrize("dtype,tol", DENSE_POLICIES)
@pytest.mark.parametrize("kernel", ["K5", "K7"])
@pytest.mark.parametrize("causal,t,s", [(False, 40, 300), (False, 130, 4500),
                                        (False, 130, 16384), (True, 100, 100),
                                        (True, 4500, 4500)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_dense_backward_on_tensor_cores(gen, dtype, tol, kernel, causal, t, s, dh):
    """K5/K7 (tensor-core tiles, bf16 or split TF32, that skip key tiles
    the bias masks whole) against their plain versions from the same
    statistics: each of dq, dk, dv within tol x its own max|ref|; T < 64
    and S not a multiple of 64; sums over 16384 keys; masked-whole tiles in
    the middle of S and at its end; the all-padding batch's dv uniform over S; dk = dv = 0
    exactly at the masked keys of rows that each have an open key; and the
    same bits on a second run (no atomics)."""
    dtype = getattr(torch, dtype)
    b, nh = 3, 2
    q = torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kb = _padded_bias(s, b)
    g = torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
    if kernel == "K5":
        out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
        args = (q, k, v, kb, g, m, l, row_delta(g, out))
        run = lambda: flash_dense_backward(*args, causal=causal)  # noqa: E731
        want = dense_backward_plain(*args, causal)
    else:
        out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
        run = lambda: flash_dense_blocked_backward(q, k, v, kb, out, lse, g,  # noqa: E731
                                                   causal=causal)
        want = dense_blocked_backward_plain(q, k, v, kb, out, lse, g, causal)
    got = run()
    assert [x.dtype for x in got] == [dtype] * 3
    for a, r in zip(got, want):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item()
    dv0 = g[0].float().sum(1, keepdim=True).expand(-1, s, -1) / s
    _close([got[2][0]], [dv0], tol)
    masked = kb[1] < 0
    assert not got[1][1][:, masked].any() and not got[2][1][:, masked].any()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, run()))


@pytest.mark.parametrize("dtype,tol", DENSE_POLICIES)
@pytest.mark.parametrize("causal,t,s", [(False, 77, 4500), (False, 130, 16384),
                                        (True, 100, 100), (True, 4500, 4500)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_blocked_forward_on_tensor_cores(gen, dtype, tol, causal, t, s, dh):
    """K6 (tensor-core tiles, bf16 or split TF32, that skip key tiles the
    bias masks whole) against its plain version: out within tol x
    max|ref|, lse to 1e-3; T not a multiple of 64 and S not either;
    masked-whole tiles in the middle of S and at its end; the all-padding
    batch's rows uniform over the S keys (out = the mean of v, lse <=
    -1e8); the same bits on a second run."""
    dtype = getattr(torch, dtype)
    b, nh = 3, 2
    q = torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kb = _padded_bias(s, b)
    out, lse = flash_dense_blocked(q, k, v, kb, causal=causal)
    ref, ref_lse = dense_rows_blocked_plain(q, k, v, kb, causal)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-3)
    if not causal:
        assert bool((lse[:nh] <= -1e8).all())
        _close([out[0]], [v[0].float().mean(1, keepdim=True).expand(-1, t, -1)], tol)
    again = flash_dense_blocked(q, k, v, kb, causal=causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def _led_inputs(gen, t, dh, w, nh=2, g=8, dtype=torch.bfloat16):
    """Sliding-window inputs as the LED makes them: batch 0 open, batch 1
    a padded source, batch 2 a padded source with no valid global (its
    padded rows are fully masked), batch 3 all padding; the valid globals
    are token 0 and a few positions inside each source (all g in batch 0),
    masked out of the band. Returns (args, padded rows, valid global
    rows)."""
    lengths = [t, t * 3 // 5, t * 3 // 10, 0]
    n_valid = [g, 3, 0, 0]
    b = len(lengths)
    q, k, v = (torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    padded = torch.arange(t, device="cuda")[None, :] >= torch.tensor(lengths,
                                                                      device="cuda")[:, None]
    g_idx = torch.zeros((b, g), dtype=torch.long, device="cuda")
    for i, n in enumerate(lengths):
        if n > g:
            g_idx[i, 1:] = 1 + torch.randperm(n - 1, generator=gen, device="cuda")[: g - 1]
    g_valid = torch.arange(g, device="cuda")[None, :] < torch.tensor(n_valid,
                                                                     device="cuda")[:, None]
    is_global = torch.zeros((b, t), dtype=torch.bool, device="cuda")
    is_global.scatter_(1, g_idx, g_valid)
    key_bias = torch.where(padded | is_global, -1e9, 0.0).float()
    g_bias = torch.where(g_valid, 0.0, -1e9).float()
    take = lambda x: torch.gather(  # noqa: E731
        x, 2, g_idx[:, None, :, None].expand(b, nh, g, dh))
    return (q, k, v, key_bias, take(k), take(v), g_bias), padded, is_global


# (out, m, l) tolerances of the tensor-core sliding kernels against their
# plain versions: bf16 rounds P (and dS) as operands; f32 runs split TF32,
# f32 accuracy up to the order of the sums
SLIDING_TOL = {torch.bfloat16: (2e-2, 1e-3, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}
# (T, w, G) of the f32 cases: w = 32 (a 64-row block spans two w-blocks, a
# ragged last block at T = 96 and 224), 96, 512, and 128 globals
F32_SHAPES = [(96, 32, 8), (224, 32, 8), (480, 96, 128), (1536, 512, 8), (1536, 32, 128)]


def _sliding_backward_case(gen, t, w, dh, model_do, dtype, g=8):
    """K3 against its plain version from the same m, l, delta: each of dq,
    dk, dv, dkg, dvg within tol x its own max|ref|; dq = 0 exactly on
    zero-dO rows, dk = dv = 0 exactly at the masked keys of batches whose
    every row has an open column, and the same bits on a second run."""
    args, padded, is_global = _led_inputs(gen, t, dh, w, g=g, dtype=dtype)
    tol = SLIDING_TOL[dtype][0]
    out, m, l = flash_sliding_attention(*args, window=w, return_stats=True)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    if model_do:
        do = do.masked_fill((padded | is_global)[:, None, :, None], 0.0)
    bwd = (*args, do, m, l, row_delta(do, out))
    got = flash_sliding_backward(*bwd, window=w)
    want = sliding_backward_plain(*bwd, w)
    assert [x.dtype for x in got] == [dtype] * 5
    for a, r in zip(got, want):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item()
    if model_do:
        assert not got[0].masked_select((padded | is_global)[:, None, :, None]).any()
    for i in (0, 1):  # every row has an open column (a valid global)
        masked = args[3][i] < 0
        assert not got[1][i][:, masked].any() and not got[2][i][:, masked].any()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, flash_sliding_backward(*bwd, window=w)))


@pytest.mark.parametrize("t,w", [(96, 32), (224, 32), (480, 96), (1536, 512)])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("model_do", [True, False])
def test_bf16_sliding_backward_on_tensor_cores(gen, t, w, dh, model_do):
    """bf16 K3 (tensor-core passes that skip zero-dO row tiles and band key
    tiles the bias masks whole) against its plain version from the same m,
    l, delta: each of dq, dk, dv, dkg, dvg within 2e-2 x its own max|ref|;
    T a multiple of 32 and not of 64 (a 64-key tile spans two w-blocks at w
    = 32); a batch with no valid global and an all-padding one (fully
    masked rows, uniform over their window); dO zero on the padded and
    valid global rows as the encoder makes it, or random everywhere. dq = 0
    exactly on zero-dO rows, dk = dv = 0 exactly at the masked keys of
    batches whose every row has an open column, and the same bits on a
    second run (no atomics)."""
    _sliding_backward_case(gen, t, w, dh, model_do, torch.bfloat16)


@pytest.mark.parametrize("t,w,g", F32_SHAPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("model_do", [True, False])
def test_f32_sliding_backward_on_tensor_cores(gen, t, w, g, dh, model_do):
    """f32 K3 (the bf16 passes on split-TF32 tiles, with their skips)
    against its plain version: each gradient within 1e-4 x its own
    max|ref|, at w = 32 (a 64-row block spans two w-blocks), up to 128
    globals, a batch with no valid global and an all-padding one (fully
    masked rows), 64-row tiles of zero dO (the model's) or a random dO; the
    exact zeros of the skips and a bit-equal rerun."""
    _sliding_backward_case(gen, t, w, dh, model_do, torch.float32, g=g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [0, 1])
def test_sliding_backward_on_a_ranks_extended_block(gen, dtype, s):
    """K3 as the sequence-sharded encoder runs it on shard rank s of 2: the
    rank's 256 rows of a 512-token sequence extended by its neighbours' w =
    64 K/V rows (zeros and a -1e9 bias past the sequence) and w dummy query
    rows on each side, whose cotangent is zero, beside the model's zero dO
    on padded and global rows: each gradient within the kernel tests'
    tolerance of the plain backward from the same m, l, delta; dq = 0
    exactly on the dummy rows; a bit-equal rerun."""
    import torch.nn.functional as F

    t, w, tl, dh = 512, 64, 256, 64
    args, padded, is_global = _led_inputs(gen, t, dh, w, dtype=dtype)
    q, k, v, key_bias, kg, vg, g_bias = args
    off = s * tl
    kp, vp = (F.pad(x, (0, 0, w, w)) for x in (k, v))
    ext = (F.pad(q[:, :, off:off + tl], (0, 0, w, w)).contiguous(),
           kp[:, :, off:off + tl + 2 * w].contiguous(),
           vp[:, :, off:off + tl + 2 * w].contiguous(),
           F.pad(key_bias, (w, w), value=-1e9)[:, off:off + tl + 2 * w].contiguous(),
           kg, vg, g_bias)
    out, m, l = flash_sliding_attention(*ext, window=w, return_stats=True)
    dead = F.pad((padded | is_global).int(), (w, w), value=1)[:, off:off + tl + 2 * w].bool()
    dead[:, :w] = dead[:, w + tl:] = True  # the dummy rows
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    do = do.masked_fill(dead[:, None, :, None], 0.0)
    bwd = (*ext, do, m, l, row_delta(do, out))
    got = flash_sliding_backward(*bwd, window=w)
    want = sliding_backward_plain(*bwd, w)
    tol = SLIDING_TOL[dtype][0]
    for a, r in zip(got, want):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item()
    assert not got[0][:, :, :w].any() and not got[0][:, :, w + tl:].any()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, flash_sliding_backward(*bwd, window=w)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliding_backward_in_one_split(gen, dtype):
    """At T = 64 pass 3 walks its one query tile in one split, writing dkg
    and dvg itself (longer T splits the rows and sums the partials)."""
    from retrieval_augmented_mds_tpu_torch.ops.cuda_build import load

    lib = load("flash_sliding_bwd")
    assert lib.sliding_bwd_splits(64, 8, 64, 8) == 1 < lib.sliding_bwd_splits(64, 8, 128, 8)
    _sliding_backward_case(gen, 64, 32, 64, True, dtype)


def _sliding_forward_case(gen, t, w, dh, dtype, g=8):
    """K2 against its plain version: out within tol x max|ref| on each of
    three row sets apart (non-padded rows; padded rows of batches with a
    valid global; the other padded rows), m and l on every row; the fully
    masked rows of the all-padding batch uniform over their 3w + G columns
    (m = -1e9, l = 3w + G); the padded rows of a batch with a valid global
    and no open key in their band equal to the softmax over the valid
    globals alone; the same bits on a second run."""
    args, padded, is_global = _led_inputs(gen, t, dh, w, g=g, dtype=dtype)
    tol, tol_m, tol_l = SLIDING_TOL[dtype]
    q, k, v, kb, kg, vg, gb = args
    out, m, l = flash_sliding_attention(*args, window=w, return_stats=True)
    ref, ref_m, ref_l = local_rows_plain(*args, w, return_stats=True)
    assert out.dtype == dtype
    # each row set within tol x its own max|ref|: the non-padded rows (up
    # to 2w + 1 keys, small outputs) apart from the padded rows of a batch
    # with a valid global (a few globals, large outputs) and from the
    # padded rows of the others
    with_global = (gb == 0).any(1, keepdim=True)
    for rows in (~padded, padded & with_global, padded & ~with_global):
        sel = rows[:, None, :].expand(out.shape[:3])
        err = (out.float() - ref.float()).abs()[sel].max().item()
        assert err <= tol * ref.float().abs()[sel].max().item()
    torch.testing.assert_close(m, ref_m, rtol=1e-6, atol=tol_m)
    torch.testing.assert_close(l, ref_l, rtol=tol_l, atol=0.0)
    b, nh, _, _ = q.shape
    # batch 3: every row fully masked, the mean over its window and globals
    pos = torch.arange(t, device="cuda")
    lo = torch.clamp((pos // w - 1) * w, min=0)
    hi = torch.clamp((pos // w + 2) * w, max=t)
    cum = torch.nn.functional.pad(v[3].float().cumsum(1), (0, 0, 1, 0))
    uniform = (cum[:, hi] - cum[:, lo] + vg[3].float().sum(1, keepdim=True)) / (3 * w + g)
    _close([out[3]], [uniform], tol)
    assert bool((m.reshape(b, nh, t)[3] == -1e9).all())
    torch.testing.assert_close(l.reshape(b, nh, t)[3],
                               torch.full((nh, t), 3.0 * w + g, device="cuda"),
                               rtol=1e-6, atol=0.0)
    # batch 1: padded rows with no open key within w see only its globals
    open_ = torch.nn.functional.pad((kb[1] == 0).long().cumsum(0), (1, 0))
    blind = (open_[torch.clamp(pos + w + 1, max=t)] - open_[torch.clamp(pos - w, min=0)]) == 0
    assert bool(blind.any())
    sg = torch.einsum("hrd,hjd->hrj", q[1].float(), kg[1].float()) * dh ** -0.5 + gb[1]
    only = torch.einsum("hrj,hjd->hrd", torch.softmax(sg, -1), vg[1].float())
    _close([out[1][:, blind]], [only[:, blind]], tol)
    again = flash_sliding_attention(*args, window=w, return_stats=True)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, m, l), again))


@pytest.mark.parametrize("t,w", [(96, 32), (224, 32), (480, 96), (1536, 512)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bf16_sliding_forward_on_tensor_cores(gen, t, w, dh):
    """bf16 K2 (tensor-core tiles that skip band key tiles the bias masks
    whole, decided from the inputs) against its plain version: out within
    2e-2 x max|ref| (P is rounded to bf16 as an operand) on each of three
    row sets apart (non-padded rows; padded rows of batches with a valid
    global; the other padded rows), m atol 1e-3, l rtol 1e-3 on every row;
    T a multiple of 32 and not of 64 (a ragged last block), w = 32 and 96
    (a 64-row block spans two w-blocks); a batch with no valid global and
    an all-padding one, whose fully masked rows are uniform over their
    3w + G columns (m = -1e9, l = 3w + G); the padded rows of a batch with
    a valid global and no open key in their band equal to the softmax over
    the valid globals alone; the same bits on a second run."""
    _sliding_forward_case(gen, t, w, dh, torch.bfloat16)


@pytest.mark.parametrize("t,w,g", F32_SHAPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_f32_sliding_forward_on_tensor_cores(gen, t, w, g, dh):
    """f32 K2 (the bf16 kernel on split-TF32 tiles, with its skip) against
    its plain version: out within 1e-4 x each row set's own max|ref|, m
    atol 1e-4, l rtol 1e-4, at w = 32 (a 64-row block spans two w-blocks),
    up to 128 globals, with a batch with no valid global and an all-padding
    one (fully masked rows uniform over 3w + G columns); a bit-equal rerun."""
    _sliding_forward_case(gen, t, w, dh, torch.float32, g=g)


def test_f32_sliding_kernels_reject_window_16_at_dh_128(gen):
    """The f32 window granule is the bf16 one, 32, at every head dim."""
    args = _sliding_inputs(gen, torch.float32, t=480, dh=128)
    with pytest.raises(ValueError, match="multiple of 32"):
        flash_sliding_attention(*args, window=16)
    out, m, l = local_rows_plain(*args, 16, return_stats=True)
    with pytest.raises(ValueError, match="multiple of 32"):
        flash_sliding_backward(*args, out, m, l, row_delta(out, out), window=16)


def test_bf16_sliding_forward_rejects_untiled_window(gen):
    """bf16 K2 takes what K3 takes: w a multiple of 32 dividing T."""
    args = _sliding_inputs(gen, torch.bfloat16, t=480)
    with pytest.raises(ValueError, match="multiple"):
        flash_sliding_attention(*args, window=48)
    with pytest.raises(ValueError, match="multiple"):
        flash_sliding_attention(*args, window=64)  # 480 % 64


@pytest.mark.parametrize("dtype,tol", DENSE_POLICIES)
@pytest.mark.parametrize("causal,t,s", [(True, 100, 100), (True, 512, 512),
                                        (False, 77, 300), (False, 130, 2048)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_dense_forward_on_tensor_cores(gen, dtype, tol, causal, t, s, dh):
    """K4 (the tensor-core forward of K6, writing m and l; bf16 or split
    TF32) against its plain version: out within tol x max|ref|, m atol
    1e-3, l rtol 1e-3; causal self-attention and cross-attention, T and S
    not multiples of 64; masked-whole tiles in the middle of S and at its
    end; a source of length 0 (its rows uniform over the S keys, m = -1e9,
    l = S); K5 fed K4's m and l against the plain backward from the same
    statistics; the same bits on a second run."""
    dtype = getattr(torch, dtype)
    b, nh = 3, 2
    q = torch.randn((b, nh, t, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kb = _padded_bias(s, b)
    out, m, l = flash_dense_attention(q, k, v, kb, causal=causal)
    ref, ref_m, ref_l = dense_rows_plain(q, k, v, kb, causal, return_stats=True)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()
    torch.testing.assert_close(m, ref_m, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=0.0)
    _close([out[0]], [v[0].float().mean(1, keepdim=True).expand(-1, t, -1)], tol)
    assert bool((m[:nh] == -1e9).all())
    torch.testing.assert_close(l[:nh], torch.full_like(l[:nh], float(s)), rtol=1e-6,
                               atol=0.0)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    bwd = (q, k, v, kb, g, m, l, row_delta(g, out))
    got = flash_dense_backward(*bwd, causal=causal)
    for a, r in zip(got, dense_backward_plain(*bwd, causal)):
        assert (a.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()
    again = flash_dense_attention(q, k, v, kb, causal=causal)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, m, l), again))


def test_dense_rows_routes_long_sources_to_k6_k7(gen):
    """dense_rows on CUDA tensors at S = MAX_S + 1 launches K6 and K7 (not
    K4/K5), with gradients equal to the CPU path's."""
    q, k, v, kb = _dense_inputs(gen, torch.float32, 40, MAX_S + 1, 32, nh=2)
    counters = (flash_dense_attention, flash_dense_backward, flash_dense_blocked,
                flash_dense_blocked_backward)
    for c in counters:
        c.launches = 0
    grads = {}
    for dev in ("cuda", "cpu"):
        x = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        (dense_rows(*x, kb.to(dev), False) ** 2).sum().backward()
        grads[dev] = [t.grad.cpu() for t in x]
    _close(grads["cuda"], grads["cpu"], 1e-4)
    assert [c.launches for c in counters] == [0, 0, 1, 1]


# ---------------------------------------------------------------------------
# K10: phase 1 of the two-phase MIPS top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b", [(4096, 64, 8), (777, 50, 3), (20000, 768, 40)])
def test_chunkmax_kernel_matches_plain(gen, dtype, n, d, b):
    """K10's scores and chunk maxima against `mips_chunkmax_plain`
    (ragged N and D, bias, ignored ids), within 1e-4 x max|score| (f32 sums
    in another order); columns >= N and the ignored ids exactly -3e38."""
    q = torch.randn((b, d), generator=gen, device="cuda")
    e = torch.randn((n, d), generator=gen, device="cuda").to(getattr(torch, dtype))
    rb = torch.randn(n, generator=gen, device="cuda")
    ign = torch.randint(-1, n, (b, 5), generator=gen, device="cuda", dtype=torch.int32)
    scores, cmax = mips_chunkmax(q, e, rb, ign)
    ref, ref_cmax = mips_chunkmax_plain(q, e, rb, ign)
    masked = ref < -1e38
    assert torch.equal(scores < -1e38, masked) and bool((scores[masked] == -3e38).all())
    tol = 1e-4 * ref[~masked].abs().max().item()
    torch.testing.assert_close(scores[~masked], ref[~masked], rtol=0, atol=tol)
    torch.testing.assert_close(cmax, ref_cmax, rtol=0, atol=tol)


def test_blocked_topk_on_the_card_matches_k1(gen):
    """`mips_topk_blocked` through K10 against K1 and against the plain
    phase 1 (random data, so no ties: the distinct-value rule of K1 and
    the all-hits rule of the blocked top-k agree)."""
    q = torch.randn((64, 256), generator=gen, device="cuda")
    e = torch.randn((30000, 256), generator=gen, device="cuda").to(torch.bfloat16)
    rb = torch.randn(30000, generator=gen, device="cuda")
    ign = torch.randint(0, 30000, (64, 4), generator=gen, device="cuda", dtype=torch.int32)
    mips_chunkmax.launches = 0
    vals, ids = mips_topk_blocked(q, e, 10, rb, ign)
    assert mips_chunkmax.launches == 1
    k1_vals, k1_ids = mips_topk(q, e, 10, rb, ign)
    assert torch.equal(ids, k1_ids)
    torch.testing.assert_close(vals, k1_vals, rtol=1e-5, atol=1e-4)
    cpu_vals, cpu_ids = mips_topk_blocked(q.cpu(), e.cpu(), 10, rb.cpu(), ign.cpu())
    assert torch.equal(ids.cpu(), cpu_ids)
    torch.testing.assert_close(vals.cpu(), cpu_vals, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,d", [(4, 768), (17, 96), (256, 768), (3, 50)])
def test_chunkmax_scores_are_k1_values_bit_for_bit(gen, b, d):
    """bf16 corpus, no scale: K10 and K1 walk D through the same tensor-core
    tile, so K10's score at each of K1's hits is K1's value, bit for bit;
    a rerun of K10 is bit-equal."""
    e = torch.randn((30000, d), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((b, d), generator=gen, device="cuda")
    rb = torch.randn(30000, generator=gen, device="cuda")
    ign = torch.randint(-1, 30000, (b, 4), generator=gen, device="cuda", dtype=torch.int32)
    scores, cmax = mips_chunkmax(q, e, rb, ign)
    vals, ids = mips_topk(q, e, 10, rb, ign)
    assert torch.equal(torch.gather(scores, 1, ids.long()), vals)
    again = mips_chunkmax(q, e, rb, ign)
    assert torch.equal(again[0], scores) and torch.equal(again[1], cmax)


# f32 K1 and K10 on the split-TF32 tile: (B, N, D, k, how the scores are
# made). D = 769 and 50 take the element copies (rows not 16-byte
# multiples); N = 20037 ends in a partial tile; "rising" is a bias step of
# 1000 a row, so every score is a candidate and k = 128 overflows the
# buffers; "1e4" scales queries and rows so the scores reach ~1e4.
F32_TILE_CASES = {
    "d769": (17, 4099, 769, 10, "normal"),
    "d50": (256, 4099, 50, 10, "normal"),
    "ragged_n": (64, 20037, 768, 10, "normal"),
    "rising_k128": (64, 20000, 96, 128, "rising"),
    "scores_1e4": (17, 30000, 768, 10, "1e4"),
}


@pytest.mark.parametrize("case", list(F32_TILE_CASES))
def test_f32_kernels_on_the_split_tf32_tile(gen, case):
    """f32 K1 against `mips_topk_plain` (ids equal, values within rtol
    1e-5 and atol 1e-4) and f32 K10 against `mips_chunkmax_plain` (within
    1e-4 x max|score|, masked cells -3e38), with bias and ignored ids; K10's
    scores at K1's hits are K1's values bit for bit (one tile, one walk);
    reruns of both are bit-equal."""
    b, n, d, k, kind = F32_TILE_CASES[case]
    e = torch.randn((n, d), generator=gen, device="cuda")
    q = torch.randn((b, d), generator=gen, device="cuda")
    bias = torch.randn(n, generator=gen, device="cuda")
    if kind == "rising":
        bias = 1000.0 * torch.arange(n, device="cuda", dtype=torch.float32)
    if kind == "1e4":
        e, q, bias = 20.0 * e, 20.0 * q, 100.0 * bias
    ign = torch.randint(-1, n, (b, 4), generator=gen, device="cuda", dtype=torch.int32)
    vals, ids = _same_as_plain(q, e, k, bias, ign)
    if kind == "rising":
        last = torch.arange(n - 1, -1, -1, device="cuda", dtype=torch.int32)
        want = torch.stack([last[~torch.isin(last, row)][:k] for row in ign])
        assert torch.equal(ids, want)
    if kind == "1e4":
        assert vals[:, 0].abs().min() > 5e3
    again = mips_topk(q, e, k, bias, ign)
    assert torch.equal(again[0], vals) and torch.equal(again[1], ids)
    scores, cmax = mips_chunkmax(q, e, bias, ign)
    ref, ref_cmax = mips_chunkmax_plain(q, e, bias, ign)
    masked = ref < -1e38
    assert torch.equal(scores < -1e38, masked) and bool((scores[masked] == -3e38).all())
    tol = 1e-4 * ref[~masked].abs().max().item()
    torch.testing.assert_close(scores[~masked], ref[~masked], rtol=0, atol=tol)
    torch.testing.assert_close(cmax, ref_cmax, rtol=0, atol=tol)
    assert torch.equal(torch.gather(scores, 1, ids.long()), vals)
    again = mips_chunkmax(q, e, bias, ign)
    assert torch.equal(again[0], scores) and torch.equal(again[1], cmax)


def test_predict_runs_through_both_kernels(gen):
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    mips_topk.launches = flash_sliding_attention.launches = 0
    out = cli.run_predict(cfg, device="cuda")
    assert len(out["predictions"]) == cfg.data.batch_size
    assert mips_topk.launches > 0 and flash_sliding_attention.launches > 0

    cpu = cli.run_predict(cfg, device="cpu")
    assert len(cpu["predictions"]) == len(out["predictions"])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_retriever_validation_runs_through_k1_in_f32(gen, metric):
    """`validate_retriever` of a small random retriever on the card: one K1
    launch over the f32 index (D = 64, or 65 with the l2 route's augmented
    column), the ranking of the CPU run: the score at every rank within
    rtol 1e-4 + atol 1e-4, 99% of the ids equal, the metrics within 0.01."""
    import numpy as np

    from retrieval_augmented_mds_tpu_torch.models.config import EncoderConfig
    from retrieval_augmented_mds_tpu_torch.retriever.contrastive import (
        RetrieverConfig,
        init_retriever,
    )
    from retrieval_augmented_mds_tpu_torch.retriever.validate import validate_retriever

    enc = EncoderConfig.tiny()  # window 64: the kernels' tile granule
    rcfg = RetrieverConfig(query_enc=enc, mips_enc=enc)
    params = init_retriever(rcfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(4, enc.vocab_size, (300, 64)).astype(np.int32)
    mask = np.ones_like(ids)
    corpus = {"token_ids": ids, "token_mask": mask}
    queries = {"query_input_ids": ids[:, ::-1].copy(), "query_attention_mask": mask}
    aids = np.arange(300, dtype=np.int32)[:, None]
    args = (rcfg.query_enc, rcfg.mips_enc, corpus, aids, queries, aids[:, 0],
            np.ones(300, np.int32))
    mips_topk.launches = 0
    got, det = validate_retriever(params.cuda(), *args, metric=metric, return_details=True)
    assert mips_topk.launches == 1
    ref, rdet = validate_retriever(params.cpu(), *args, metric=metric, return_details=True)
    np.testing.assert_allclose(det["scores"], rdet["scores"], rtol=1e-4, atol=1e-4)
    # the value at each rank agrees; ids may swap where two rows' scores lie
    # within the two devices' summation-order noise
    assert (det["indices"] == rdet["indices"]).mean() >= 0.99
    for k, v in ref.items():
        assert abs(got[k] - v) <= 0.01, k


# ---------------------------------------------------------------------------
# K9: the 8-bit AdamW superleaf update
# ---------------------------------------------------------------------------

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def _adam8bit_inputs(gen, sizes, wd, clip, pad_rows=3):
    """A superleaf of leaves of ``sizes`` (tails) plus ``pad_rows`` blocks
    of pure padding, with a warm state (one plain update from zero), the
    step-2 bias corrections, lr 1e-3 and the clip scale."""
    sizes, nbs, _, nb = t8._layout(sizes)
    nb += pad_rows
    nv = torch.from_numpy(t8._nvalid_for(sizes, nbs, nb)).cuda()
    mask = torch.arange(t8.BLOCK, device="cuda")[None, :] < nv
    rand = lambda s: torch.randn((nb, t8.BLOCK), generator=gen, device="cuda") * s * mask  # noqa: E731
    p = rand(0.1) if wd else None
    zeros = [torch.zeros((nb, t8.BLOCK), dtype=d, device="cuda") for d in (torch.int8, torch.uint8)]
    cols = [torch.zeros((nb, 1), device="cuda")] + [
        torch.full((nb, 1), t8._LOG_TINY, device="cuda") for _ in range(2)]
    scal0 = torch.tensor([[0.1, 0.001, 1e-3, 1.0]], device="cuda")
    _, mq, ms, nq, nlo, nhi = adam8bit_superleaf_update_plain(
        rand(1e-2), zeros[0], cols[0], zeros[1], cols[1], cols[2], nv, p, scal0, wd=wd,
        **ADAM)
    scal = torch.tensor([[1 - 0.9 ** 2, 1 - 0.999 ** 2, 1e-3, clip]], device="cuda")
    return rand(1e-2).contiguous(), mq, ms, nq, nlo, nhi, nv, p, scal


def _adam8bit_close(got, ref):
    """Tolerances of the JAX package's kernel test: update rtol 1e-6 atol
    1e-9, codes within 1, mu scales rtol 1e-6, nu range rtol/atol 1e-5."""
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-9)
    for k, dtype in ((1, torch.int8), (3, torch.uint8)):
        assert got[k].dtype == dtype
        assert (got[k].int() - ref[k].int()).abs().max().item() <= 1
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
    for k in (4, 5):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wd", [0.0, 0.02])
@pytest.mark.parametrize("clip", [1.0, 0.3])
@pytest.mark.parametrize("sizes", [[16384 + 70, 300], [5, 128, 1000, 129]])
def test_adam8bit_kernel_matches_plain(gen, wd, clip, sizes):
    """K9 against its plain version: leaf tails, 3 blocks of pure padding,
    NB (135 and 15) not a multiple of the CTA's 8 rows, wd 0 and > 0, a
    clip scale of 1 and below; one launch per call."""
    args = _adam8bit_inputs(gen, sizes, wd, clip)
    before = adam8bit_superleaf_update.launches
    got = adam8bit_superleaf_update(*args, wd=wd, **ADAM)
    torch.cuda.synchronize()
    assert adam8bit_superleaf_update.launches == before + 1
    _adam8bit_close(got, adam8bit_superleaf_update_plain(*args, wd=wd, **ADAM))
    assert (got[1][-3:] == 0).all() and (got[3][-3:] == 0).all()
    assert torch.equal(got[4][-3:], torch.full_like(got[4][-3:], t8._LOG_TINY))


@pytest.mark.parametrize("d", [0, 1])
def test_adam8bit_kernel_on_a_data_ranks_rows(gen, d):
    """K9 as the ZeRO-sharded 8-bit AdamW runs it: on data rank d's rows
    of a superleaf whose odd block count (143) is padded to 144 for 2 data
    ranks (rank 1's last row holds no valid element): against its plain
    version (`_adam8bit_close`), and those rows bit-equal to K9 over the
    whole superleaf on the same inputs."""
    sizes = [16384 + 70, 300, 5, 1000, 129]
    _, _, nb_real, nb = t8._layout(sizes, 2)
    assert (nb_real, nb) == (143, 144)
    args = _adam8bit_inputs(gen, sizes, 0.02, 0.5, pad_rows=1)
    whole = adam8bit_superleaf_update(*args, wd=0.02, **ADAM)
    rows = slice(d * nb // 2, (d + 1) * nb // 2)
    part = tuple(None if a is None else a[rows].contiguous() if a.shape[0] == nb else a
                 for a in args)
    assert int((part[6] == 0).sum()) == d
    got = adam8bit_superleaf_update(*part, wd=0.02, **ADAM)
    _adam8bit_close(got, adam8bit_superleaf_update_plain(*part, wd=0.02, **ADAM))
    for a, b in zip(got, whole):
        assert torch.equal(a, b[rows])


def test_adam8bit_kernel_writes_over_the_gradients(gen):
    """``out=g2``: the update written over the gradients equals the update
    written elsewhere."""
    args = _adam8bit_inputs(gen, [3000, 77], 0.01, 0.5)
    ref = adam8bit_superleaf_update(*args, wd=0.01, **ADAM)
    g2 = args[0].clone()
    got = adam8bit_superleaf_update(g2, *args[1:], wd=0.01, out=g2, **ADAM)
    assert got[0] is g2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_adam8bit_kernel_rejects_bad_inputs(gen):
    args = list(_adam8bit_inputs(gen, [300], 0.0, 1.0))
    args[1] = args[1].to(torch.uint8)
    with pytest.raises(ValueError, match="mu_q"):
        adam8bit_superleaf_update(*args, wd=0.0, **ADAM)
    args = list(_adam8bit_inputs(gen, [300], 0.02, 1.0))
    args[7] = None  # wd != 0 needs the parameters
    with pytest.raises(ValueError, match="p2"):
        adam8bit_superleaf_update(*args, wd=0.02, **ADAM)


def test_8bit_optimizer_on_the_card_matches_the_cpu(gen):
    """Three AdamW8bit steps with clip and weight decay on a two-group tree:
    the card's parameters and state against the CPU's (plain version)."""
    from torch import nn

    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer

    def tree(dev):
        m = nn.Module()
        m.led = nn.Linear(130, 70).to(dev)
        m.query_encoder = nn.Linear(40, 3).to(dev)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.linspace(-1, 1, p.numel()).reshape(p.shape))
        return m

    runs = {}
    for dev in ("cuda", "cpu"):
        model, g = tree(dev), torch.Generator().manual_seed(0)
        tx = build_optimizer(1e-2, 1, 10, weight_decay=0.01, grad_clip=0.5, state_8bit=True)
        state = tx.init(model)
        for _ in range(3):
            grads = {n: torch.randn(p.shape, generator=g).to(dev)
                     for n, p in model.named_parameters()}
            tx.update(model, grads, state)
        runs[dev] = (model, state)
    for (n, p), (_, q) in zip(runs["cuda"][0].named_parameters(),
                              runs["cpu"][0].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0, atol=1e-6, msg=n)
    assert runs["cuda"][1].count == 3
    assert (runs["cuda"][1].mu_q.cpu().int() - runs["cpu"][1].mu_q.int()).abs().max() <= 1


def _smoke_encoded(**generation):
    """configs/smoke.yaml's predict on the card with ``generation`` set →
    (config, its run_predict report)."""
    import dataclasses

    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(cfg, generation=dataclasses.replace(cfg.generation,
                                                                  **generation))
    report = {}
    cli.run_predict(cfg, device="cuda", report=report)
    return cfg, report


def _to_cpu(enc):
    import dataclasses

    return dataclasses.replace(enc, **{f.name: getattr(enc, f.name).cpu()
                                       for f in dataclasses.fields(enc)
                                       if getattr(enc, f.name) is not None})


def test_copy_trace_runs_through_k4_and_matches_the_cpu(gen):
    """`copy_trace` on the card launches K4 for every decoder layer's self-
    and cross-attention (f32, as predict runs it) and agrees with the same
    call on the CPU (the plain versions) on the same encoder outputs and
    ids: gate and mass within 1e-4, the top positions equal wherever the
    4th and 5th probabilities are more than 1e-4 apart."""
    import copy

    from retrieval_augmented_mds_tpu_torch.models.generate import copy_trace

    cfg, rep = _smoke_encoded(output_copy_probs=True)
    params, enc, ids = rep["params"], rep["enc"], rep["ids"]
    flash_dense_attention.launches = 0
    got = copy_trace(params, cfg.model, enc, ids, top_positions=5)
    assert flash_dense_attention.launches == 2 * cfg.model.led.dec_layers
    ref = copy_trace(copy.deepcopy(params).cpu(), cfg.model, _to_cpu(enc), ids.cpu(),
                     top_positions=5)
    for k in ("copy_gate", "copy_mass"):
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0, atol=1e-4)
    gap = ref["top_mem_prob"][..., 3] - ref["top_mem_prob"][..., 4]
    clear = gap > 1e-4
    assert clear.any()
    assert torch.equal(got["top_mem_pos"][..., :4].cpu()[clear], ref["top_mem_pos"][..., :4][clear])


def test_sampling_on_the_card_is_seeded(gen):
    """Sampled `generate` on the card: one seed gives bit-equal ids (the
    default generator is seed 0)."""
    from retrieval_augmented_mds_tpu_torch.models.generate import GenerationOptions, generate

    cfg, rep = _smoke_encoded()
    params, enc = rep["params"], rep["enc"]
    opts = GenerationOptions(max_new_tokens=16, do_sample=True, temperature=0.8, top_k=50,
                             top_p=0.95)
    a = generate(params, cfg.model, enc, opts)
    b = generate(params, cfg.model, enc, opts,
                 generator=torch.Generator(device="cuda").manual_seed(0))
    assert torch.equal(a, b)


def test_top_k_1_sampling_on_the_card_is_greedy(gen):
    """Top-k 1 sampling on the card gives the greedy ids bit for bit."""
    from retrieval_augmented_mds_tpu_torch.models.generate import GenerationOptions, generate

    cfg, rep = _smoke_encoded()
    params, enc = rep["params"], rep["enc"]
    greedy = generate(params, cfg.model, enc, GenerationOptions(max_new_tokens=16))
    top1 = generate(params, cfg.model, enc, GenerationOptions(
        max_new_tokens=16, do_sample=True, temperature=0.8, top_k=1, top_p=0.95))
    assert torch.equal(top1, greedy)


# ---------------------------------------------------------------------------
# the cached decoder step's attention (ops/flash_decode.py)
# ---------------------------------------------------------------------------

def _decode_inputs(gen, dtype, dh, b, g, s, nh=3):
    """q [b g, nh, 1, dh] and k/v [b, nh, s, dh] as the decoder makes them:
    heads split from [*, T, nh dh] projections (strided, not contiguous)."""
    def heads(rows, t):
        x = torch.randn((rows, t, nh * dh), generator=gen, device="cuda").to(dtype)
        return x.reshape(rows, t, nh, dh).permute(0, 2, 1, 3)

    return heads(b * g, 1), heads(b, s), heads(b, s)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_decode_kernel_cross_matches_plain(gen, dh, dtype, tol):
    """Folded beams (g = 4) against un-expanded, strided cross K/V: sources
    of 1, 63, 64, 65 and 2048 tokens of S = 2048, and one of none (its rows
    uniform over the S keys), within tol x max|ref|; a rerun bit-equal."""
    lengths = [1, 63, 64, 65, 2048, 0]
    q, k, v = _decode_inputs(gen, getattr(torch, dtype), dh, len(lengths), 4, 2048)
    assert not k.is_contiguous()
    mask = (torch.arange(2048, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])
    before = flash_decode_attention.launches
    out = flash_decode_attention(q, k, v, mask)
    assert flash_decode_attention.launches == before + 1
    _close([out], [flash_decode_plain(q, k, v, mask)], tol)
    assert torch.equal(out, flash_decode_attention(q, k, v, mask))


@pytest.mark.parametrize("pos", [0, 63, 64, 256])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_decode_kernel_cache_matches_plain(gen, pos, dh, dtype, tol):
    """The self-attention over a 257-slot cache at the one-token step's
    causal mask (keys up to ``pos``), the slots after it holding values that
    must not count; one mask row for every beam."""
    from retrieval_augmented_mds_tpu_torch.models.core import causal_mask

    dt = getattr(torch, dtype)
    q = torch.randn((8, 3, 1, dh), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((8, 3, 257, dh), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    mask = causal_mask(1, 257, torch.tensor(pos, device="cuda"), "cuda").reshape(1, 257)
    out = flash_decode_attention(q, k, v, mask)
    _close([out], [flash_decode_plain(q, k, v, mask)], tol)


def test_decode_kernel_rejects_bad_inputs(gen):
    q, k, v = _decode_inputs(gen, torch.float32, 48, 2, 2, 64)
    mask = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_attention(q, k, v, mask)
    q, k, v = _decode_inputs(gen, torch.float32, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="key_mask"):
        flash_decode_attention(q, k, v, mask.float())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_generate_through_the_decode_kernel(gen, monkeypatch, dtype, tol):
    """`generate` (beam 2, configs/smoke.yaml's tiny LED with its copy head)
    on the card takes the kernel for every decoder layer's self- and
    cross-attention, 2 x dec_layers launches a step, and serves the ids of
    the same card's plain path (`decode_key_mask` turned off), each step's
    log-probs within tol x max|ref|."""
    from retrieval_augmented_mds_tpu_torch.models import core
    from retrieval_augmented_mds_tpu_torch.models.generate import (
        copy_head_kv,
        decode_step,
        generate,
    )

    cfg, rep = _smoke_encoded()
    params, enc = rep["params"], rep["enc"]

    def run():
        logps = []
        inner = decode_step(params, cfg.model, dtype, copy_head_kv(params, cfg.model, enc,
                                                                   dtype))

        def step(*args):
            logp, caches = inner(*args)
            logps.append(logp)
            return logp, caches

        before = flash_decode_attention.launches
        ids = generate(params, cfg.model, enc, cfg.generation, dtype=dtype, step=step)
        return ids, torch.stack(logps), flash_decode_attention.launches - before

    ids, logp, launches = run()
    steps = cfg.generation.max_new_tokens
    assert launches == 2 * cfg.model.led.dec_layers * steps
    monkeypatch.setattr(core, "decode_key_mask", lambda *a: None)
    ref_ids, ref_logp, ref_launches = run()
    assert ref_launches == 0
    assert torch.equal(ids, ref_ids)
    finite = ref_logp > -1e3  # tokens the mixture gives no mass: -inf or ~-1e9 on both
    assert torch.equal(finite, logp > -1e3)
    _close([logp[finite]], [ref_logp[finite]], tol)
