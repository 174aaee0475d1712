"""The sequence-sharded encoder's gradient against the JAX package, on the CPU.

`ops.seq_attention.sliding_global_attention_seqsharded` and
`led_encode(seq_mesh=)` run forward and backward over the (1, 4) and
(2, 2) meshes of 4 processes (`torch_mesh_launch`: one launch for the
file). Each rank takes its share of a fixed linear loss (the sum of its
output times a seeded cotangent R): the attention's output is the rank's
own block, so its share is that block's term; the LED encoder returns the
whole sequence on every rank of a ``shard`` group, so each takes 1/S of
its rows' term (the mesh train step's convention). Each rank returns its
block's input gradient and its parameters' gradients; the parameters'
are summed over the 4 ranks and held, with the input gradient, against
``jax.grad`` of the JAX package's UNSHARDED functions on the same inputs.
The mask kinds are the forward test's (`test_torch_seq_parallel`): globals
scattered over every block, all on the last rank, all on the first, none
beyond CLS, and a row padded from token 40 on (its later blocks all
padding, its halos at the sequence's ends). f32; rtol = atol = 2e-5, the
forward's tolerance; a parameter's atol is 2e-5 of its leaf's largest
entry where that exceeds 1 (an entry is a sum over every token, whose
roundoff scales with its terms: the LED's embedding table holds entries
near 70 beside entries near 0.3 that cancel to 4e-5 of roundoff).
"""

import sys

import numpy as np
import torch

from retrieval_augmented_mds_tpu_torch.bridge import load_jax_params
from retrieval_augmented_mds_tpu_torch.models.config import Seq2SeqConfig
from retrieval_augmented_mds_tpu_torch.models.led import LED, led_encode
from retrieval_augmented_mds_tpu_torch.ops.seq_attention import (
    sliding_global_attention_seqsharded,
)
from retrieval_augmented_mds_tpu_torch.ops.sliding_attention import SlidingAttention
from retrieval_augmented_mds_tpu_torch.parallel import MeshSpec, make_mesh
from tests.test_torch_seq_parallel import B, G, H, KINDS, NH, SPECS, T, W, _block, _masks
from torch_mesh_launch import launch, store_url

TOL = dict(rtol=2e-5, atol=2e-5)
LAUNCH_TIMEOUT = 240  # s: the launch takes ~15 s here; a hang is killed, never waited out


def _grads(module) -> dict:
    return {n: p.grad.numpy().copy() for n, p in module.named_parameters()
            if p.grad is not None}


def rank_grads(init, attn_tree, x, cot, masks, led_tree, ids, led_masks, led_cot):
    """One rank: for each mesh, the attention's input and parameter
    gradients on every mask kind, then the LED encoder's parameter
    gradients → {key: arrays}."""
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init)
    attn = load_jax_params(SlidingAttention(H), attn_tree)
    led = load_jax_params(LED(Seq2SeqConfig.tiny()), led_tree)
    out = {}
    for spec in SPECS:
        mesh = make_mesh(MeshSpec(*spec), "cpu")
        rows = mesh.data_rows(B)
        for kind, (glob, pad) in masks.items():
            attn.zero_grad(set_to_none=True)
            xl = torch.from_numpy(_block(mesh, x, T)).requires_grad_()
            y = sliding_global_attention_seqsharded(
                attn, xl, NH, W, torch.from_numpy(glob[rows]), torch.from_numpy(pad[rows]),
                G, mesh)
            (y * torch.from_numpy(_block(mesh, cot, T))).sum().backward()
            out[(spec, "attn", kind)] = (xl.grad.numpy(), _grads(attn))
        led.zero_grad(set_to_none=True)
        glob, pad = (torch.from_numpy(a[rows]) for a in led_masks)
        y = led_encode(led, Seq2SeqConfig.tiny(), torch.from_numpy(ids[rows]), pad, glob,
                       seq_mesh=mesh)
        ((y * torch.from_numpy(led_cot[rows])).sum() / mesh.shard).backward()
        out[(spec, "led")] = _grads(led)
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "retrieval_augmented_mds_tpu.")) or m == "retrieval_augmented_mds_tpu")
    return out


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(got: dict, ref_tree, what: str):
    from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree

    ref = flatten_tree(ref_tree)
    assert set(got) <= set(ref), (what, set(got) - set(ref))
    for n, r in ref.items():  # a leaf the port's graph never reached: JAX's zero
        atol = TOL["atol"] * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got.get(n, 0.0 * r), r, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{what}: {n}")


def test_seqsharded_gradients_equal_jax_grad(tmp_path):
    """On every mask kind and both meshes: each rank's input gradient
    equals its block of ``jax.grad`` of the unsharded attention, and the
    parameters' gradients summed over the ranks equal JAX's; the LED
    encoder's summed parameter gradients equal ``jax.grad`` of the
    unsharded ``led_encode``. Within TOL. The ranks load no JAX."""
    import jax
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.models import led as jled
    from retrieval_augmented_mds_tpu.models.config import Seq2SeqConfig as JS2S
    from retrieval_augmented_mds_tpu.ops.sliding_attention import (
        sliding_attention_init,
        sliding_global_attention,
    )

    rng = np.random.default_rng(17)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    cot = rng.standard_normal((B, T, H)).astype(np.float32)
    attn_tree = sliding_attention_init(jax.random.PRNGKey(0), H)
    masks = {kind: _masks(kind, seed=i) for i, kind in enumerate(KINDS)}

    def attn_loss(p, xx, g, pm):
        return jnp.sum(sliding_global_attention(p, xx, NH, W, g, pm, G) * cot)

    attn_grad = jax.jit(jax.grad(attn_loss, argnums=(0, 1)))
    refs = {kind: attn_grad(attn_tree, jnp.asarray(x), jnp.asarray(g), jnp.asarray(p))
            for kind, (g, p) in masks.items()}

    led_tree = jled.init_led(jax.random.PRNGKey(1), JS2S.tiny())
    ids = rng.integers(4, 500, (B, T)).astype(np.int32)
    ids[:, 0] = 0
    led_glob, led_pad = _masks("scattered", seed=11)
    led_cot = rng.standard_normal((B, T, JS2S.tiny().d_model)).astype(np.float32)

    def led_loss(p):
        return jnp.sum(jled.led_encode(p, JS2S.tiny(), jnp.asarray(ids), jnp.asarray(led_pad),
                                       jnp.asarray(led_glob)) * led_cot)

    led_ref = jax.jit(jax.grad(led_loss))(led_tree)

    results = launch(f"{__name__}:rank_grads", 4, workdir=str(tmp_path),
                     args=(store_url(str(tmp_path)), _numpy_tree(attn_tree), x, cot, masks,
                           _numpy_tree(led_tree), ids, (led_glob, led_pad), led_cot),
                     timeout=LAUNCH_TIMEOUT)
    assert all(res["modules"] == [] for res in results), [r["modules"] for r in results]
    for spec in SPECS:
        data, shard = spec
        tl = T // shard
        for kind in KINDS:
            p_ref, x_ref = refs[kind]
            for r, res in enumerate(results):
                d, s = divmod(r, shard)
                rows = slice(d * B // data, (d + 1) * B // data)
                np.testing.assert_allclose(
                    res[(spec, "attn", kind)][0],
                    np.asarray(x_ref)[rows, s * tl:(s + 1) * tl],
                    err_msg=f"rank {r} mesh {spec} {kind}: dx", **TOL)
            summed = {n: sum(res[(spec, "attn", kind)][1][n] for res in results)
                      for n in results[0][(spec, "attn", kind)][1]}
            _assert_tree(summed, p_ref, f"mesh {spec} {kind}: parameters")
        summed = {n: sum(res[(spec, "led")][n] for res in results)
                  for n in results[0][(spec, "led")]}
        _assert_tree(summed, led_ref, f"mesh {spec} led_encode")
