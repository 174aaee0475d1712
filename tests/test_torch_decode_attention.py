"""The cached decoder step's attention on the CPU: `ops.flash_decode`'s
plain version against `core.attention`'s plain path, the routing predicate
`core.decode_key_mask`, and the cached step exported through the custom op
``ramds::flash_decode`` on "cuda" fakes (the kernel itself:
tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from retrieval_augmented_mds_tpu_torch.models import core
from retrieval_augmented_mds_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_plain,
)

torch.set_num_threads(1)
NH, DH = 2, 32


def _mha(seed, d=NH * DH):
    return core.build_module(lambda: core.MHA(d), torch.Generator().manual_seed(seed))


def _cross_case(dtype, lengths=(1, 63, 64, 65, 0), g=4, s=130, seed=0):
    """A folded-beam cross-attention: g beams of each of len(lengths) items
    against un-expanded, strided K/V heads (split from a [B, S, H]
    projection), item i's source ``lengths[i]`` long (0: all padding)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    p = _mha(seed)
    x_q = torch.from_numpy(rng.standard_normal((b * g, 1, NH * DH), np.float32)).to(dtype)
    enc = torch.from_numpy(rng.standard_normal((b, s, NH * DH), np.float32)).to(dtype)
    kv = core.precompute_cross_kv(p, enc, NH)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None])[:, None, None, :]
    return p, x_q, enc, mask, dict(kv=kv)


def _self_case(dtype, pos, t_max=257, rows=6, seed=1):
    """A self-attention cache of ``t_max`` slots after ``pos`` writes, and the
    causal mask of the one-token step at ``pos``."""
    rng = np.random.default_rng(seed)
    p = _mha(seed)
    cache = core.make_cache(rows, NH, DH, t_max, dtype)
    filled = torch.from_numpy(rng.standard_normal((2, rows, NH, pos, DH), np.float32))
    cache["k"][:, :, :pos], cache["v"][:, :, :pos] = filled.to(dtype)
    cache["pos"] = torch.tensor(pos)
    x = torch.from_numpy(rng.standard_normal((rows, 1, NH * DH), np.float32)).to(dtype)
    return p, x, x, core.causal_mask(1, t_max, cache["pos"]), dict(cache=cache)


CASES = [("cross", None), ("self", 0), ("self", 63), ("self", 64), ("self", 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,pos", CASES)
def test_plain_decode_rows_are_core_attentions_math(kind, pos, dtype):
    """`flash_decode_plain` on the heads `core.attention` reads gives its
    output bit for bit: folded beams over ragged sources (lengths 1, 63, 64,
    65 and an all-padding one, whose rows are uniform) and a cache at
    positions 0, 63, 64 and 256 of 257 slots."""
    p, x_q, x_kv, mask, kw = (_cross_case(dtype) if kind == "cross"
                              else _self_case(dtype, pos))
    got, cache = core.attention(p, x_q, x_kv, NH, mask=mask, **kw)
    if kind == "cross":
        k, v = kw["kv"]
    else:
        k, v = cache["k"], cache["v"]
        assert int(cache["pos"]) == pos + 1
    q = core._split_heads(core.dense(p.q, x_q), NH)
    assert core.decode_key_mask(q, k, v, mask, None) is None  # CPU: the plain path
    out = flash_decode_plain(q, k, v, mask.reshape(mask.shape[0], -1))
    assert torch.equal(core.dense(p.o, core._merge_heads(out)), got)
    if kind == "cross":  # the all-padding item: its rows are the mean of its values
        mean = v[-1].float().mean(dim=1).to(dtype).float()
        rows = out[-4:].float()
        torch.testing.assert_close(rows, mean[None, :, None].expand_as(rows), rtol=0,
                                   atol=1e-2 if dtype == torch.bfloat16 else 1e-6)


def _fake_cuda(*xs):
    return [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="cuda")
            for x in xs]


ROUTES = {
    # name: (kind, mask transform, q dtype, bias, head dim, expected key-mask shape or None)
    "cross": ("cross", None, torch.bfloat16, False, DH, (5, 130)),
    "cross_f32": ("cross", None, torch.float32, False, DH, (5, 130)),
    "self_one_token": ("self", None, torch.bfloat16, False, DH, (1, 257)),
    "self_two_tokens": ("self", "two_tokens", torch.bfloat16, False, DH, None),
    "per_query_mask": ("cross", "per_query", torch.bfloat16, False, DH, None),
    "per_head_mask": ("cross", "per_head", torch.bfloat16, False, DH, None),
    "float16": ("cross", None, torch.float16, False, DH, None),
    "additive_bias": ("cross", None, torch.bfloat16, True, DH, None),
    "head_dim_48": ("cross", None, torch.bfloat16, False, 48, None),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", list(ROUTES))
def test_routing_takes_the_kernel_only_for_per_key_masks_on_the_card(name, device):
    """`decode_key_mask` picks the kernel for CUDA tensors of bf16 or f32,
    head dim 32/64/128, no bias and a mask of one value per key ([B|1, 1, 1,
    S]); CPU tensors, a two-token step's causal mask, per-query and
    per-head masks, f16, a bias and other head dims keep the plain path."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kind, change, dtype, with_bias, dh, expect = ROUTES[name]
    b, s = (5, 130) if kind == "cross" else (6, 257)
    bq = 4 * b if kind == "cross" else b
    q = torch.zeros((bq, NH, 1, dh), dtype=dtype)
    k = v = torch.zeros((b, NH, s, dh), dtype=dtype)
    if kind == "cross":
        mask = torch.ones((b, 1, 1, s), dtype=torch.bool)
        if change == "per_query":
            mask = torch.ones((b, 1, 4, s), dtype=torch.bool)
        elif change == "per_head":
            mask = torch.ones((b, NH, 1, s), dtype=torch.bool)
    else:
        mask = core.causal_mask(2 if change == "two_tokens" else 1, s, torch.tensor(3))
    bias = torch.zeros((1, 1, 1, s)) if with_bias else None
    if device == "cpu":
        assert core.decode_key_mask(q, k, v, mask, bias) is None
        return
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v, mask = _fake_cuda(q, k, v, mask)
        got = core.decode_key_mask(q, k, v, mask, bias)
        assert (None if got is None else tuple(got.shape)) == expect
        if got is not None:
            assert got.dtype == torch.bool and got.device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["cross", "self"])
def test_wrapper_traces_on_fake_cuda_tensors(kind, dtype):
    """`flash_decode_attention` on "cuda" fakes reaches the custom op's fake:
    the plain version's shape and dtype, on "cuda", no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    p, x_q, x_kv, mask, kw = (_cross_case(dtype) if kind == "cross"
                              else _self_case(dtype, 64))
    q = core._split_heads(core.dense(p.q, x_q), NH)
    k, v = kw["kv"] if kind == "cross" else (kw["cache"]["k"], kw["cache"]["v"])
    key_mask = mask.reshape(mask.shape[0], -1)
    ref = flash_decode_plain(q, k, v, key_mask)
    before = flash_decode_attention.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        got = flash_decode_attention(*_fake_cuda(q, k, v, key_mask))
    assert (got.shape, got.dtype, got.device.type) == (ref.shape, ref.dtype, "cuda")
    assert flash_decode_attention.launches == before


def test_cached_attention_exports_through_the_custom_op():
    """A decoder layer's two cached attentions as the serving step runs them
    (the self-attention writing its cache at a tensor position, then the
    cross-attention over precomputed, strided heads, g = 4 beams), exported
    from "cuda" fakes with the weights as inputs (`serving._with_param_leaves`),
    call ``ramds::flash_decode`` once each, launch nothing, and return the
    plain version's shapes. (A whole step cannot be traced on "cuda" fakes
    without a CUDA build: indexing a fake CUDA tensor calls into CUDA.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from retrieval_augmented_mds_tpu_torch import serving

    layer = torch.nn.Module()
    layer.self_attn, layer.cross_attn = _mha(2), _mha(3)
    b, g, s, t_max, dtype = 3, 4, 130, 17, torch.float32

    def attend(layer, x, k, v, ck, cv, pos, smask, cmask):
        cache = {"k": k, "v": v, "pos": pos}
        a, cache = core.attention(layer.self_attn, x, x, NH, mask=smask, cache=cache)
        c, _ = core.attention(layer.cross_attn, a, None, NH, mask=cmask, kv=(ck, cv))
        return c, cache["k"], cache["v"]

    before = flash_decode_attention.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        def cuda(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device="cuda")

        heads = cuda((b, s, NH * DH)).reshape(b, s, NH, DH).permute(0, 2, 1, 3)
        args = (tuple(cuda(p.shape) for p in layer.parameters()), cuda((b * g, 1, NH * DH)),
                cuda((b * g, NH, t_max, DH)), cuda((b * g, NH, t_max, DH)), heads, heads,
                cuda((), torch.int64), cuda((1, 1, 1, t_max), torch.bool),
                cuda((b, 1, 1, s), torch.bool))
        ep = torch.export.export(serving._Program(serving._with_param_leaves(layer, attend)),
                                 args)
    calls = [n for n in ep.graph.nodes if n.target is torch.ops.ramds.flash_decode.default]
    assert len(calls) == 2
    out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    assert [tuple(o.meta["val"].shape) for o in out] == [
        (b * g, 1, NH * DH), (b * g, NH, t_max, DH), (b * g, NH, t_max, DH)]
    assert flash_decode_attention.launches == before
