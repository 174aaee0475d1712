"""The BART and T5 baselines of the port against the JAX package, on the
CPU: encode, decode and logits, the cached decoder, T5's relative position
buckets and shift, the HF converters (against ``transformers`` models built
in code), the loaders, the train step, greedy decoding, and
``run_fit_baseline``.

Parameters come from the JAX package's ``init_bart`` / ``init_t5``, moved
off their 0.02 init by seeded noise (so that greedy decoding emits varied
ids), through `bridge.load_jax_params`; inputs are numpy arrays made from a
seed, with a padded source row; everything is f32. Tolerances are stated
per test.
"""

import dataclasses
import json
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from retrieval_augmented_mds_tpu.models import bart as jbart  # noqa: E402
from retrieval_augmented_mds_tpu.models import t5 as jt5  # noqa: E402
from retrieval_augmented_mds_tpu.models.config import (  # noqa: E402
    Seq2SeqConfig as JSeq2SeqConfig,
)
from retrieval_augmented_mds_tpu.models.core import make_cache as jmake_cache  # noqa: E402
from retrieval_augmented_mds_tpu.train import baseline as jbase  # noqa: E402
from retrieval_augmented_mds_tpu.train import optimizer as joptim  # noqa: E402
from retrieval_augmented_mds_tpu.train import trainer as jtrainer  # noqa: E402
from retrieval_augmented_mds_tpu_torch import cli  # noqa: E402
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree, load_jax_params  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import bart as tbart  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import hf_import as timport  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import led as tled  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import t5 as tt5  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models.config import Seq2SeqConfig  # noqa: E402
from retrieval_augmented_mds_tpu_torch.ops.flash_dense import (  # noqa: E402
    flash_dense_attention,
    flash_dense_backward,
)
from retrieval_augmented_mds_tpu_torch.train import baseline as tbase  # noqa: E402
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim  # noqa: E402
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer  # noqa: E402
from retrieval_augmented_mds_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from retrieval_augmented_mds_tpu_torch.utils.config import load_config  # noqa: E402

from tests.test_torch_models import _np, _t  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    _jax_tree,
    _KeepGradients,
    _keep_gradients_tx,
    _state_arrays,
    check_bf16_mu_state,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=128, d_model=32, n_heads=2, enc_layers=2, dec_layers=2, d_ffn=64,
          max_src_len=32, max_tgt_len=16)
JCFG, CFG = JSeq2SeqConfig(**KW), Seq2SeqConfig(**KW)
B, S, T = 3, 24, 8
FAMILIES = ("bart", "t5")
J = {"bart": jbart, "t5": jt5}
P = {"bart": tbart, "t5": tt5}


def jax_params(family: str, seed: int = 0):
    """The JAX init, every leaf moved by N(0, 0.15^2) noise from ``seed``."""
    params = getattr(J[family], f"init_{family}")(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.15 * rng.standard_normal(x.shape),
                              jnp.float32), params)


def port_model(family: str, tree):
    module = tbart.Bart(CFG) if family == "bart" else tt5.T5(CFG)
    return load_jax_params(module, tree)


def inputs(seed: int = 0):
    """Sources [B, S] (row 1 padded after 15 tokens), targets [B, T]."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 120, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 15:] = 0
    tgt = rng.integers(4, 120, (B, T)).astype(np.int32)
    return src, am, tgt


def fns(family: str, pkg):
    m = pkg[family]
    return (getattr(m, f"{family}_encode"), getattr(m, f"{family}_decode"),
            (lambda p, h: m.t5_lm_logits(p, h, JCFG if pkg is J else CFG))
            if family == "t5" else m.bart_lm_logits)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_encode_decode_logits_match_jax(family):
    """Encoder states, the teacher-forced decoder's states and the logits,
    at rtol = atol = 1e-5 (f32 roundoff of two summation orders)."""
    jp = jax_params(family)
    model = port_model(family, jp)
    src, am, tgt = inputs()
    jenc, jdec, jlogits = fns(family, J)
    tenc, tdec, tlogits = fns(family, P)
    e_j = jenc(jp, JCFG, jnp.asarray(src), jnp.asarray(am))
    h_j, _ = jdec(jp, JCFG, jnp.asarray(tgt), e_j, jnp.asarray(am))
    with torch.no_grad():
        e_t = tenc(model, CFG, _t(src), _t(am))
        h_t, _ = tdec(model, CFG, _t(tgt), e_t, _t(am))
        lt = tlogits(model, h_t)
    for got, ref in ((e_t, e_j), (h_t, h_j), (lt, jlogits(jp, h_j))):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_cached_decode_matches_teacher_forced(family):
    """Decoding one token at a time over the cache (with precomputed
    cross-attention heads, as greedy decoding runs it) gives the
    teacher-forced states within atol 2e-5; for T5 also the JAX package's
    cached states step by step (rtol = atol = 1e-5). The JAX package's BART
    decoder places a cached step at position ``pos_offset``, which its
    greedy loop leaves at 0 (`test_greedy_ids`); here each step is given its
    position."""
    jp = jax_params(family)
    model = port_model(family, jp)
    src, am, tgt = inputs(1)
    tenc, tdec, _ = fns(family, P)
    init = tled.init_decode_caches if family == "bart" else tt5.init_t5_caches
    with torch.no_grad():
        enc = tenc(model, CFG, _t(src), _t(am))
        full, _ = tdec(model, CFG, _t(tgt), enc, _t(am))
        caches = init(model, CFG, B, T, enc_hidden=enc)
        steps = [tdec(model, CFG, _t(tgt[:, i:i + 1]), enc, _t(am), caches=caches,
                      pos_offset=i)[0] for i in range(T)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), rtol=0, atol=2e-5)
    if family == "t5":
        e_j = jt5.t5_encode(jp, JCFG, jnp.asarray(src), jnp.asarray(am))
        dh = CFG.d_model // CFG.n_heads
        jc = [jmake_cache(B, CFG.n_heads, dh, T, jnp.float32) for _ in range(CFG.dec_layers)]
        for i in range(T):
            h, jc = jt5.t5_decode(jp, JCFG, jnp.asarray(tgt[:, i:i + 1]), e_j,
                                  jnp.asarray(am), caches=jc)
            np.testing.assert_allclose(_np(steps[i]), np.asarray(h), rtol=1e-5, atol=1e-5)


EDGES = [0, 1, 7, 8, 15, 16, 31, 32, 63, 64, 127, 128, 129, 500]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(bidirectional):
    """Equal buckets at the log buckets' edges (n = 8, 16, 32, 64, 127, 128,
    500 and their neighbours, either sign) and over every offset of
    -600..600."""
    rel = np.array(sorted({s * n for n in EDGES for s in (1, -1)} | set(range(-600, 601))),
                   np.int32)
    got = tt5.relative_position_bucket(_t(rel), bidirectional).numpy()
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("offset", [0, 5, 400])
def test_t5_position_bias_matches_jax(offset):
    """Equal biases, also where the offsets pass MAX_DISTANCE (the lookup
    clamps them there) in either direction."""
    table = np.random.default_rng(2).standard_normal((32, 3)).astype(np.float32)
    for bidi, (tq, tk) in ((True, (7, 7)), (False, (1, 9)), (False, (6, 6)),
                           (True, (300, 300)), (False, (3, 700))):
        got = tt5._pos_bias(_t(table), tq, tk, bidi, offset=offset)
        ref = jt5._pos_bias(jnp.asarray(table), tq, tk, bidi, offset=offset)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_t5_shift_right_matches_jax():
    ids = np.array([[5, 6, 7, -100], [-100, 9, -100, 3]], np.int32)
    got = tt5.t5_shift_right(_t(ids), pad_id=1, start_id=0).numpy()
    ref = np.asarray(jt5.t5_shift_right(jnp.asarray(ids), pad_id=1, start_id=0))
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [[0, 5, 6, 7], [0, 1, 9, 1]]


def test_init_draws_the_reference_distributions():
    """Seeded inits with the JAX trees' names and shapes: T5's relative-bias
    tables drawn like its kernels (not zeroed as a bias), BART's
    ``final_logits_bias`` 0 and its position tables 2 rows longer."""
    g = torch.Generator().manual_seed(0)
    t5, bart = tt5.init_t5(CFG, g), tbart.init_bart(CFG, g)
    for family, model in (("t5", t5), ("bart", bart)):
        ref = flatten_tree(getattr(J[family], f"init_{family}")(jax.random.PRNGKey(0), JCFG))
        got = {n: p.shape for n, p in model.named_parameters()}
        assert got == {n: tuple(a.shape) for n, a in ref.items()}
    for table in (t5.enc_rel_bias, t5.dec_rel_bias):
        assert 0.01 < float(table.detach().std()) < 0.04
    assert torch.equal(bart.final_logits_bias, torch.zeros(CFG.vocab_size))
    assert bart.enc_pos.table.shape[0] == CFG.max_src_len + tbart.POS_OFFSET


# ---------------------------------------------------------------------------
# HF converters and loaders
# ---------------------------------------------------------------------------

def hf_bart():
    from transformers import BartConfig, BartForConditionalGeneration

    torch.manual_seed(0)
    hf = BartForConditionalGeneration(BartConfig(
        vocab_size=256, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=66, pad_token_id=1, bos_token_id=0,
        eos_token_id=2, decoder_start_token_id=2, forced_eos_token_id=None)).eval()
    with torch.no_grad():  # nonzero biases, so a transposed or swapped bias shows
        hf.final_logits_bias.normal_()
        for n, p in hf.named_parameters():
            if n.endswith("bias"):
                p.normal_(0, 0.02)
    return hf


def hf_t5():
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(1)
    return T5ForConditionalGeneration(T5Config(
        vocab_size=256, d_model=32, num_layers=2, num_decoder_layers=2, num_heads=2,
        d_kv=16, d_ff=64, feed_forward_proj="relu", pad_token_id=1, eos_token_id=2,
        decoder_start_token_id=0, tie_word_embeddings=True)).eval()


# BART's 66 positions are its tables' 68 rows less the 2 offset rows
HF_KW = {**KW, "vocab_size": 256, "max_src_len": 66, "max_tgt_len": 66}
HF_CFG, JHF_CFG = Seq2SeqConfig(**HF_KW), JSeq2SeqConfig(**HF_KW)


@pytest.mark.parametrize("family", FAMILIES)
def test_converters_match_jax_and_hf(family):
    """The converter's tree equals the JAX package's array for array; the
    port's logits on it are HF's within rtol = atol = 1e-4 (the JAX package's
    own test allows 2e-3)."""
    hf = hf_bart() if family == "bart" else hf_t5()
    convert = getattr(timport, f"{family}_params_from_hf")
    tree = convert(hf.state_dict(), HF_CFG)
    ref = flatten_tree(getattr(J[family], f"{family}_params_from_hf")(hf.state_dict(), JHF_CFG))
    flat = flatten_tree(tree)
    assert set(flat) == set(ref)
    for k in ref:
        assert flat[k].dtype == np.float32, k
        np.testing.assert_array_equal(flat[k], np.asarray(ref[k]), err_msg=k)
    model = getattr(timport, f"{family}_from_tree")(tree, HF_CFG)
    rng = np.random.default_rng(3)
    src = rng.integers(4, 250, (2, 20))
    am = np.ones((2, 20), np.int64)
    am[1, 12:] = 0
    dec = rng.integers(4, 250, (2, 8))
    with torch.no_grad():
        want = hf(input_ids=_t(src), attention_mask=_t(am), decoder_input_ids=_t(dec)).logits
        m = P[family]
        enc = getattr(m, f"{family}_encode")(model, HF_CFG, _t(src), _t(am))
        hid, _ = getattr(m, f"{family}_decode")(model, HF_CFG, _t(dec), enc, _t(am))
        got = (m.bart_lm_logits(model, hid) if family == "bart"
               else m.t5_lm_logits(model, hid, HF_CFG))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.fixture
def offline(monkeypatch):
    """Hub lookups fail at once, and no socket reaches another host."""
    import socket

    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    local = ("127.0.0.1", "::1", "localhost")
    connect, getaddrinfo = socket.socket.connect, socket.getaddrinfo

    def guarded_connect(self, address):
        if isinstance(address, tuple) and address[0] not in local:
            raise OSError(f"tests may not reach {address}")
        return connect(self, address)

    def guarded_getaddrinfo(host, *a, **k):
        if host not in local:
            raise OSError(f"tests may not resolve {host}")
        return getaddrinfo(host, *a, **k)

    monkeypatch.setattr(socket.socket, "connect", guarded_connect)
    monkeypatch.setattr(socket, "getaddrinfo", guarded_getaddrinfo)


@pytest.mark.parametrize("family", FAMILIES)
def test_loaders_read_a_local_directory_and_refuse_a_hub_name_offline(
        tmp_path, offline, family):
    """A saved HF model loads into the tree its state dict converts to; a
    hub name raises offline, so the load policy warns and skips it."""
    hf = hf_bart() if family == "bart" else hf_t5()
    hf.save_pretrained(str(tmp_path / family))
    load = getattr(timport, f"load_{family}_from_pretrained")
    got = flatten_tree(load(str(tmp_path / family), HF_CFG))
    want = flatten_tree(getattr(timport, f"{family}_params_from_hf")(hf.state_dict(), HF_CFG))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(Exception):
        load("no-such-org/no-such-model", HF_CFG)
    with pytest.warns(UserWarning, match=r"\[weights\] SKIPPING"):
        assert timport.load_with_policy("weights", "no-such-org/no-such-model", family,
                                        lambda n: load(n, HF_CFG)) is None


# ---------------------------------------------------------------------------
# the train step and greedy decoding
# ---------------------------------------------------------------------------

HYPER = dict(lr=3e-3, warmup_steps=1, total_steps=100)
OPT = dict(grad_clip=0.1, mu_dtype="bfloat16")  # `run_fit_baseline`'s optimizer knobs


def batches(n: int = 3):
    out = []
    for i in range(n):
        src, am, tgt = inputs(10 + i)
        tgt[0, 5:] = CFG.pad_id  # a padded target row
        out.append({"input_ids": src, "attention_mask": am, "labels": tgt})
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_match_jax(family):
    """Three ``make_seq2seq_train_step`` steps (AdamW with warmup, the clip
    and a bf16 mu, as `run_fit_baseline` builds it), each begun by both
    packages from the JAX trajectory's state (its parameters and optimizer
    state loaded into the port):

    * the loss within rtol 1e-5;
    * every gradient leaf within 2^-12 of its norm plus 2^-20 of the
      largest leaf's (f32 roundoff: the leaves that are zero in exact
      arithmetic, BART's attention ``k`` biases, are roundoff of the
      largest terms in both packages);
    * the parameters after the port's update within rtol = atol = 1e-6 of
      the JAX optimizer's update on the port's gradients, and the optimizer
      state as `test_train_steps_match_jax` of the RAG step holds it.

    Beside it, a copy of the port runs the three steps on its own: its
    losses within rtol 1e-4 of the JAX package's, and its parameters within
    atol 1e-4 of them, leaf by leaf."""
    jp = jax_params(family, seed=4)
    jtx = joptim.build_optimizer(HYPER["lr"], HYPER["warmup_steps"], HYPER["total_steps"],
                                 **OPT)
    jstep = jbase.make_seq2seq_train_step(family, JCFG, jtx)
    jgrad_step = jbase.make_seq2seq_train_step(family, JCFG, _keep_gradients_tx())
    jupdate = jax.jit(jtx.update)
    jstate = jtrainer.TrainState.create(jp, jtx)

    def port():
        tx = toptim.build_optimizer(HYPER["lr"], HYPER["warmup_steps"],
                                    HYPER["total_steps"], **OPT)
        kept = _KeepGradients(tx)
        model = port_model(family, jp)
        return (tx, kept, ttrainer.TrainState.create(model, tx),
                tbase.make_seq2seq_train_step(family, CFG, kept))

    ttx, tkept, tstate, tstep = port()
    _, _, fstate, fstep = port()
    for i, hb in enumerate(batches()):
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        tb = {k: _t(v) for k, v in hb.items()}
        start = jax.tree_util.tree_map(jnp.array, jstate)  # the step donates jstate
        flat = _state_arrays(start)
        tckpt.load_params(tstate.params, flat)
        tstate.opt_state = ttx.load_state_arrays(tstate.params, flat)
        params = jax.tree_util.tree_map(jnp.array, start.params)  # donated below
        kept = jtrainer.TrainState(params=params, opt_state=_keep_gradients_tx().init(params),
                                   step=jnp.array(start.step))
        jgrads = flatten_tree(jgrad_step(kept, jb)[0].opt_state)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        fstate, fm = fstep(fstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(fm["loss"]), float(jm["loss"]), rtol=1e-4)
        g = tkept.grads[-1]
        assert set(g) == set(jgrads)
        top = max(float(np.linalg.norm(x)) for x in jgrads.values())
        for n, x in g.items():
            gap = float(np.linalg.norm(_np(x) - jgrads[n]))
            allowed = 2.0 ** -12 * float(np.linalg.norm(jgrads[n])) + 2.0 ** -20 * top
            assert gap <= allowed, f"step {i}: {n} gradient {gap:.3g} apart, {allowed:.3g}"
        upd, ref_opt = jupdate(_jax_tree(start.params, {n: _np(x) for n, x in g.items()}),
                               start.opt_state, start.params)
        ref_params = optax.apply_updates(start.params, upd)
        ref = flatten_tree(ref_params)
        for n, p in tstate.params.named_parameters():
            np.testing.assert_allclose(_np(p), ref[n], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i}: {n}")
        ref_state = _state_arrays(jtrainer.TrainState(params=ref_params, opt_state=ref_opt,
                                                      step=jnp.int32(0)))
        got = ttx.state_arrays(tstate.params, tstate.opt_state)
        ref_state = {k: v for k, v in ref_state.items() if k.startswith(".opt_state")}
        assert set(got) == set(ref_state)
        norm = float(np.sqrt(sum(float((x.double() ** 2).sum()) for x in g.values())))
        clip = OPT["grad_clip"] / max(norm, OPT["grad_clip"])
        check_bf16_mu_state(got, ref_state, flat, {n: x * clip for n, x in g.items()})
    assert tstate.step == fstate.step == 3 and int(jstate.step) == 3
    ref = flatten_tree(jstate.params)
    for n, p in fstate.params.named_parameters():
        np.testing.assert_allclose(_np(p), ref[n], rtol=0, atol=1e-4, err_msg=n)


def jax_greedy_teacher_forced(family, jp, src, am, n):
    """Greedy decoding from the JAX package's teacher-forced decoder: step
    t decodes the sequence so far (its row t sees positions 0..t only, the
    decoder being causal) and takes row t's argmax; eos ends a row, which
    then gets pad, as in ``seq2seq_greedy``."""
    enc = jbart.bart_encode(jp, JCFG, src, am)
    logits = jax.jit(lambda seqs: jbart.bart_lm_logits(
        jp, jbart.bart_decode(jp, JCFG, seqs, enc, am)[0]))
    seqs = np.full((src.shape[0], n + 1), JCFG.pad_id, np.int32)
    seqs[:, 0] = JCFG.eos_id
    done = np.zeros(src.shape[0], bool)
    for t in range(n):
        nxt = np.asarray(jnp.argmax(logits(jnp.asarray(seqs))[:, t], -1)).astype(np.int32)
        nxt = np.where(done, JCFG.pad_id, nxt)
        seqs[:, t + 1] = nxt
        done |= nxt == JCFG.eos_id
    return seqs[:, 1:]


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_ids(family, monkeypatch):
    """``seq2seq_greedy`` for 10 steps, a row ending at eos on the way:
    T5's ids equal the JAX package's (its scan). BART's equal greedy
    decoding from the JAX package's teacher-forced decoder, each token at
    its position; and with every cached step put at position 0, as the JAX
    package's BART greedy does (a fault of the reference), they equal that
    one's ids, so position is the only difference."""
    jp = jax_params(family, seed=6)
    model = port_model(family, jp)
    src, am, _ = inputs(7)
    n = 10
    got = tbase.seq2seq_greedy(family, model, CFG, _t(src), _t(am), max_new_tokens=n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    scan = np.asarray(jbase.seq2seq_greedy(family, jp, JCFG, jnp.asarray(src),
                                           jnp.asarray(am), max_new_tokens=n))
    if family == "t5":
        np.testing.assert_array_equal(got.numpy(), scan)
    else:
        ref = jax_greedy_teacher_forced(family, jp, jnp.asarray(src), jnp.asarray(am), n)
        np.testing.assert_array_equal(got.numpy(), ref)
        decode = tbase.bart_decode
        monkeypatch.setattr(tbase, "bart_decode",
                            lambda *a, pos_offset=0, **k: decode(*a, pos_offset=0, **k))
        at_zero = tbase.seq2seq_greedy(family, model, CFG, _t(src), _t(am), max_new_tokens=n)
        np.testing.assert_array_equal(at_zero.numpy(), scan)
        assert not np.array_equal(ref, scan)
    ids = got.numpy()
    assert len(np.unique(ids)) > 3, ids


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_run_fit_baseline_on_cpu(tmp_path, monkeypatch, family):
    """``configs/baseline_bart.yaml`` (and the same with ``baseline: t5``),
    with both mirrors on, on the CPU: 6 steps drawn from the train split
    only (the JAX package draws from every example, the val split
    included), greedy decoding over the val split's one padded batch, the
    JSONL, TensorBoard and mlflow files and the outputs left in
    ``log_dir``, no kernel launched; T5's sources carry "summarize: "."""
    from retrieval_augmented_mds_tpu_torch.data.pipeline import RAGDataModule

    cfg = load_config(os.path.join(REPO, "configs", "baseline_bart.yaml"))
    log_dir = tmp_path / "runs"
    cfg = dataclasses.replace(cfg, baseline=family, logging=dataclasses.replace(
        cfg.logging, log_dir=str(log_dir), tensorboard=True, mlflow=True))
    splits, modules = [], []
    batches_of = RAGDataModule.batches

    def spy(self, *a, **k):
        splits.append(k.get("split"))
        modules.append(self)
        return batches_of(self, *a, **k)

    monkeypatch.setattr(RAGDataModule, "batches", spy)
    rep = {}
    kernels = (flash_dense_attention, flash_dense_backward)
    before = [k.launches for k in kernels]
    out = cli.run_fit_baseline(cfg, device="cpu", report=rep)
    assert [k.launches for k in kernels] == before
    assert out["steps"] == cfg.max_steps == len(rep["losses"])
    assert {"loss", "rouge1", "rouge2", "rougeL"} <= set(out)
    assert all(np.isfinite(rep["losses"]))
    assert set(splits) == {"train", "val"} and splits[-1] == "val"
    assert modules[0].prompt_prefix == ("summarize: " if family == "t5" else "")
    (val_ids,) = rep["val_ids"]
    assert val_ids.shape == (cfg.data.batch_size, cfg.generation.max_new_tokens)
    name = f"{cfg.logging.run_name}_{family}"
    rows = [json.loads(x) for x in (log_dir / f"{name}.metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(cfg.max_steps))
    np.testing.assert_allclose([r["loss"] for r in rows], rep["losses"], rtol=1e-6)
    assert os.listdir(log_dir / "tb" / name)
    (run,) = [d for d in os.listdir(log_dir / "mlruns" / "0")
              if (log_dir / "mlruns" / "0" / d).is_dir()]
    lines = (log_dir / "mlruns" / "0" / run / "metrics" / "loss").read_text().splitlines()
    assert len(lines) == cfg.max_steps
    assert "status: FINISHED" in (log_dir / "mlruns" / "0" / run / "meta.yaml").read_text()
    dump = json.loads((log_dir / f"baseline_{family}_val_outputs.json").read_text())
    assert len(dump) == len(modules[0].split_indices("val"))
