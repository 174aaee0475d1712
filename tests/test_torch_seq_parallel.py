"""The sequence-sharded encoder forward against the JAX package, on the CPU.

`ops.seq_attention.sliding_global_attention_seqsharded` and the LED and
Longformer encoders with ``seq_mesh`` run over a (data, shard) mesh of 4
processes (`torch_mesh_launch`, gloo on a ``file://`` store under
``tmp_path``): the (1, 4) and (2, 2) meshes in one launch. Each rank
returns its block of the output (its batch rows, its tokens); the blocks
are held against the JAX package's UNSHARDED functions
(``sliding_global_attention``, ``led_encode``, ``longformer_encode``) on
the same inputs, which the JAX package's own ``tests/test_seq_parallel.py``
shows equal to its sharded ones (those run there only under ``slow``).

The masks cover: globals scattered over every block with a ragged padded
tail; non-CLS globals all on the last rank; globals (CLS among them) all
on the first rank; no global beyond CLS; and a row padded from token 40
on, so that every later block of it is padding (zero rows) and its
queries' bands end in masked keys. f32 throughout; tolerance rtol = atol =
2e-5, the JAX package's own for its sharded-against-unsharded test (the
cross-rank softmax of the global rows sums in another order).
"""

import sys

import numpy as np
import torch

from retrieval_augmented_mds_tpu_torch.bridge import load_jax_params
from retrieval_augmented_mds_tpu_torch.models.config import EncoderConfig, Seq2SeqConfig
from retrieval_augmented_mds_tpu_torch.models.led import LED, led_encode
from retrieval_augmented_mds_tpu_torch.models.longformer import Longformer, longformer_encode
from retrieval_augmented_mds_tpu_torch.ops.seq_attention import (
    sliding_global_attention_seqsharded,
)
from retrieval_augmented_mds_tpu_torch.ops.sliding_attention import SlidingAttention
from retrieval_augmented_mds_tpu_torch.parallel import MeshSpec, make_mesh
from torch_mesh_launch import launch, store_url

B, T, H, NH, W, G = 4, 256, 32, 2, 16, 8
SPECS = [(1, 4), (2, 2)]
TOL = dict(rtol=2e-5, atol=2e-5)
LAUNCH_TIMEOUT = 240  # s: the launch takes ~10 s here; a hang is killed, never waited out


def _masks(kind, t=T, seed=0):
    rng = np.random.default_rng(seed)
    pad = np.ones((B, t), np.int32)
    pad[1, t - 12:] = 0  # a ragged tail on the last block
    pad[3, 40:] = 0  # every block but the first all padding
    glob = np.zeros((B, t), np.int32)
    glob[:, 0] = 1
    if kind == "scattered":
        for i in range(B):
            glob[i, rng.choice(np.arange(1, t - 16), size=5, replace=False)] = 1
    elif kind == "last_rank":
        for i in range(B):
            glob[i, rng.choice(np.arange(3 * t // 4, t - 16), size=5, replace=False)] = 1
    elif kind == "first_rank":
        for i in range(B):
            glob[i, rng.choice(np.arange(1, t // 4), size=5, replace=False)] = 1
    return glob * pad, pad


KINDS = ("scattered", "last_rank", "first_rank", "cls_only")


def _block(mesh, x, t):
    """This rank's rows and tokens of [B, t, ...]."""
    tl = t // mesh.shard
    return x[mesh.data_rows(B), mesh.s * tl:(mesh.s + 1) * tl]


def rank_cases(init, attn_tree, x, masks, led_tree, lf_tree, ids, led_masks):
    from retrieval_augmented_mds_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init)
    attn = load_jax_params(SlidingAttention(H), attn_tree)
    led = load_jax_params(LED(Seq2SeqConfig.tiny()), led_tree)
    lf = load_jax_params(Longformer(EncoderConfig.tiny()), lf_tree)
    out = {}
    with torch.no_grad():
        for spec in SPECS:
            mesh = make_mesh(MeshSpec(*spec), "cpu")
            rows = mesh.data_rows(B)
            for kind, (glob, pad) in masks.items():
                xl = torch.from_numpy(_block(mesh, x, T))
                got = sliding_global_attention_seqsharded(
                    attn, xl, NH, W, torch.from_numpy(glob[rows]),
                    torch.from_numpy(pad[rows]), G, mesh)
                out[(spec, "attn", kind)] = got.numpy()
            glob, pad = (torch.from_numpy(a[rows]) for a in led_masks)
            tid = torch.from_numpy(ids[rows])
            out[(spec, "led")] = led_encode(led, Seq2SeqConfig.tiny(), tid, pad, glob,
                                            seq_mesh=mesh).numpy()
            out[(spec, "longformer")] = longformer_encode(lf, EncoderConfig.tiny(), tid, pad,
                                                          seq_mesh=mesh).numpy()
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "retrieval_augmented_mds_tpu.")) or m == "retrieval_augmented_mds_tpu")
    return out


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_seqsharded_forward_equals_jax(tmp_path):
    """Attention on every mask kind, then `led_encode` and
    `longformer_encode` at the tiny preset (T = 256, window 64), on the
    (1, 4) and (2, 2) meshes: each rank's block equals the JAX package's
    unsharded output there, within TOL; the encoders return the whole
    sequence on every rank of a ``shard`` group. The ranks load no JAX."""
    import jax
    import jax.numpy as jnp

    from retrieval_augmented_mds_tpu.models import led as jled
    from retrieval_augmented_mds_tpu.models import longformer as jlong
    from retrieval_augmented_mds_tpu.models.config import EncoderConfig as JEnc
    from retrieval_augmented_mds_tpu.models.config import Seq2SeqConfig as JS2S
    from retrieval_augmented_mds_tpu.ops.sliding_attention import (
        sliding_attention_init,
        sliding_global_attention,
    )

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    attn_tree = sliding_attention_init(jax.random.PRNGKey(0), H)
    masks = {kind: _masks(kind, seed=i) for i, kind in enumerate(KINDS)}
    refs = {kind: np.asarray(sliding_global_attention(
        attn_tree, jnp.asarray(x), NH, W, jnp.asarray(g), jnp.asarray(p), G))
        for kind, (g, p) in masks.items()}

    led_tree = jled.init_led(jax.random.PRNGKey(1), JS2S.tiny())
    lf_tree = jlong.init_longformer(jax.random.PRNGKey(2), JEnc.tiny())
    ids = rng.integers(4, 500, (B, T)).astype(np.int32)
    ids[:, 0] = 0
    led_glob, led_pad = _masks("scattered", seed=11)
    led_ref = np.asarray(jled.led_encode(led_tree, JS2S.tiny(), jnp.asarray(ids),
                                         jnp.asarray(led_pad), jnp.asarray(led_glob)))
    lf_ref = np.asarray(jlong.longformer_encode(lf_tree, JEnc.tiny(), jnp.asarray(ids),
                                                jnp.asarray(led_pad)))

    results = launch(f"{__name__}:rank_cases", 4, workdir=str(tmp_path),
                     args=(store_url(str(tmp_path)), _numpy_tree(attn_tree), x, masks,
                           _numpy_tree(led_tree), _numpy_tree(lf_tree), ids,
                           (led_glob, led_pad)),
                     timeout=LAUNCH_TIMEOUT)
    for r, res in enumerate(results):
        assert res["modules"] == [], res["modules"]
        for spec in SPECS:
            data, shard = spec
            d, s = divmod(r, shard)
            rows = slice(d * B // data, (d + 1) * B // data)
            tl = T // shard
            for kind in KINDS:
                np.testing.assert_allclose(
                    res[(spec, "attn", kind)], refs[kind][rows, s * tl:(s + 1) * tl],
                    err_msg=f"rank {r} mesh {spec} {kind}", **TOL)
            np.testing.assert_allclose(res[(spec, "led")], led_ref[rows],
                                       err_msg=f"rank {r} mesh {spec} led", **TOL)
            np.testing.assert_allclose(res[(spec, "longformer")], lf_ref[rows],
                                       err_msg=f"rank {r} mesh {spec} longformer", **TOL)
    # the padded row's later blocks come out zero
    np.testing.assert_array_equal(results[3][((1, 4), "attn", "scattered")][3], 0.0)
