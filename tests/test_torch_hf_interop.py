"""Pretrained weights in and out of the port, against the JAX package, on
the CPU: the HF converters, the encoders and the LED with imported weights,
the HF export, the ``encoders.npz`` handoff, and the load policy.

Every HF model is random, built in code from a small config (``transformers``
is in this container; nothing is downloaded). Hub names are made to fail
fast and offline: ``HF_HUB_OFFLINE`` is set before ``transformers`` loads,
its flags are forced on in each test, and any connection to another host
than this one raises.
"""

import dataclasses
import os

os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import socket  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from retrieval_augmented_mds_tpu.models import hf_export as jexport  # noqa: E402
from retrieval_augmented_mds_tpu.models import hf_import as jimport  # noqa: E402
from retrieval_augmented_mds_tpu.models import led as jled  # noqa: E402
from retrieval_augmented_mds_tpu.models import longformer as jlong  # noqa: E402
from retrieval_augmented_mds_tpu.models.config import (  # noqa: E402
    EncoderConfig as JEncoderConfig,
    Seq2SeqConfig as JSeq2SeqConfig,
)
from retrieval_augmented_mds_tpu.models.retriever_generator import (  # noqa: E402
    RAGConfig as JRAGConfig,
    init_rag as jinit_rag,
)
from retrieval_augmented_mds_tpu.utils import checkpoint as jckpt  # noqa: E402
from retrieval_augmented_mds_tpu_torch import cli  # noqa: E402
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import hf_export as texport  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import hf_import as timport  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models import led as tled  # noqa: E402
from retrieval_augmented_mds_tpu_torch.models.config import (  # noqa: E402
    EncoderConfig,
    Seq2SeqConfig,
)
from retrieval_augmented_mds_tpu_torch.models.longformer import (  # noqa: E402
    init_longformer,
    longformer_encode,
)
from retrieval_augmented_mds_tpu_torch.models.retriever_generator import (  # noqa: E402
    RAGConfig,
    init_rag,
    init_rag_pretrained,
)
from retrieval_augmented_mds_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict  # noqa: E402

from tests.test_torch_models import _np, _t  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
W, T = 16, 64
ENC = dict(vocab_size=256, d_model=32, n_heads=2, n_layers=2, d_ffn=64, max_len=T,
           window=W, max_globals=8)
LED_KW = dict(vocab_size=256, d_model=32, n_heads=2, enc_layers=2, dec_layers=2, d_ffn=64,
              max_src_len=T, max_tgt_len=32, window=W, max_globals=8, doc_sep_id=255)
HUB = "no-such-org/no-such-model"


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Hub lookups fail at once, and no socket reaches another host."""
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


def _tree_equal(got: dict, ref: dict):
    a, b = flatten_tree(got), flatten_tree(ref)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


def _hf_led():
    from transformers import LEDConfig, LEDForConditionalGeneration

    torch.manual_seed(7)
    hf = LEDForConditionalGeneration(LEDConfig(
        vocab_size=256, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_encoder_position_embeddings=T,
        max_decoder_position_embeddings=32, attention_window=[2 * W] * 2, pad_token_id=1,
        bos_token_id=0, eos_token_id=2, decoder_start_token_id=2)).eval()
    with torch.no_grad():  # nonzero biases, so a transposed or swapped bias shows
        hf.final_logits_bias.normal_()
        for n, p in hf.named_parameters():
            if n.endswith("bias"):
                p.normal_(0, 0.02)
    return hf


def _hf_longformer():
    from transformers import LongformerConfig, LongformerModel

    torch.manual_seed(8)
    hf = LongformerModel(LongformerConfig(
        vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=T + 2, attention_window=[2 * W] * 2,
        type_vocab_size=1, pad_token_id=1, bos_token_id=0, eos_token_id=2),
        add_pooling_layer=False).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if n.endswith("bias"):
                p.normal_(0, 0.02)
    return hf


def _bert_sd(adapter: str | None):
    """A random BertModel's state dict, with bottleneck adapter weights
    planted under the ``adapters`` library's key layout."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(9)
    hf = BertModel(BertConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=64,
                              max_position_embeddings=T, type_vocab_size=2,
                              pad_token_id=1), add_pooling_layer=False).eval()
    sd = dict(hf.state_dict())
    if adapter:
        g = torch.Generator().manual_seed(10)
        for i in range(2):
            ad = f"encoder.layer.{i}.output.adapters.{adapter}"
            sd[f"{ad}.adapter_down.0.weight"] = torch.randn((8, 32), generator=g)
            sd[f"{ad}.adapter_down.0.bias"] = torch.randn(8, generator=g)
            sd[f"{ad}.adapter_up.weight"] = torch.randn((32, 8), generator=g)
            sd[f"{ad}.adapter_up.bias"] = torch.randn(32, generator=g)
    return hf, sd


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------

def test_led_converter_tree_equals_jax():
    sd = _hf_led().state_dict()
    _tree_equal(timport.led_params_from_hf(sd, Seq2SeqConfig(**LED_KW)),
                jimport.led_params_from_hf(sd, JSeq2SeqConfig(**LED_KW)))


@pytest.mark.parametrize("prefix", ["", "longformer"])
def test_longformer_converter_tree_equals_jax(prefix):
    sd = {(f"{prefix}." if prefix else "") + k: v
          for k, v in _hf_longformer().state_dict().items()}
    got = timport.longformer_params_from_hf(sd, EncoderConfig(**ENC), prefix=prefix)
    _tree_equal(got, jimport.longformer_params_from_hf(sd, JEncoderConfig(**ENC),
                                                       prefix=prefix))
    assert got["type_emb"]["table"].shape == (1, 32)


@pytest.mark.parametrize("adapter", [None, "specter2"])
def test_bert_converter_tree_equals_jax(adapter):
    """With and without the planted adapter keys; the global projections
    are copies of the local ones: equal values, separate arrays, and
    separate parameters of the module built from the tree."""
    _, sd = _bert_sd(adapter)
    cfg = EncoderConfig(**{**ENC, "pos_offset": 0})
    got = timport.bert_params_from_hf(sd, cfg, prefix="", adapter_name=adapter)
    _tree_equal(got, jimport.bert_params_from_hf(sd, JEncoderConfig(**{**ENC, "pos_offset": 0}),
                                                 prefix="", adapter_name=adapter))
    attn = got["layers"][0]["attn"]
    for loc, glob in (("q", "qg"), ("k", "kg"), ("v", "vg")):
        for leaf in ("kernel", "bias"):
            assert not np.shares_memory(attn[loc][leaf], attn[glob][leaf])
    module = timport.encoder_from_tree(got, cfg)
    assert hasattr(module, "type_emb")
    assert hasattr(module.layers[0], "adapter") == (adapter is not None)
    ptrs = [p.data_ptr() for p in module.parameters()]
    assert len(ptrs) == len(set(ptrs))
    a = module.layers[0].attn
    assert torch.equal(a.q.kernel, a.qg.kernel)
    with torch.no_grad():
        a.qg.kernel.add_(1.0)
    assert not torch.equal(a.q.kernel, a.qg.kernel)


# ---------------------------------------------------------------------------
# forwards with imported weights
# ---------------------------------------------------------------------------

def test_imported_encoders_match_jax_and_hf():
    """A Longformer checkpoint and a BERT checkpoint with an adapter, each
    imported by both packages: hidden states within 1e-5 of the JAX
    package's on the same ids (a padded row included); the Longformer
    within 2e-3 of HF's own forward (its sliding-window code differs in
    summation order and masking constants)."""
    rng = np.random.default_rng(11)
    ids = rng.integers(4, 250, (2, T)).astype(np.int32)
    mask = np.ones((2, T), np.int32)
    mask[1, 40:] = 0
    ids[1, 40:] = 1
    hf = _hf_longformer()
    cfg, jcfg = EncoderConfig(**ENC), JEncoderConfig(**ENC)
    cases = [(timport.longformer_params_from_hf(hf.state_dict(), cfg, prefix=""),
              jimport.longformer_params_from_hf(hf.state_dict(), jcfg, prefix=""), cfg, jcfg)]
    _, sd = _bert_sd("specter2")
    bcfg, jbcfg = EncoderConfig(**{**ENC, "pos_offset": 0}), JEncoderConfig(
        **{**ENC, "pos_offset": 0})
    cases.append((timport.bert_params_from_hf(sd, bcfg, prefix="", adapter_name="specter2"),
                  jimport.bert_params_from_hf(sd, jbcfg, prefix="", adapter_name="specter2"),
                  bcfg, jbcfg))
    for tree, jtree, c, jc in cases:
        module = timport.encoder_from_tree(tree, c)
        got = longformer_encode(module, c, _t(ids), _t(mask))
        ref = jlong.longformer_encode(jtree, jc, jnp.asarray(ids), jnp.asarray(mask))
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    gm = np.zeros((2, T), np.int64)
    gm[:, 0] = 1
    with torch.no_grad():
        out = hf(input_ids=_t(ids).long(), attention_mask=_t(mask).long(),
                 global_attention_mask=torch.from_numpy(gm)).last_hidden_state
        ours = longformer_encode(timport.encoder_from_tree(cases[0][0], cfg), cfg, _t(ids),
                                 _t(mask))
    np.testing.assert_allclose(_np(ours)[0], out.numpy()[0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(ours)[1, :40], out.numpy()[1, :40], rtol=2e-3, atol=2e-3)


def test_imported_led_matches_jax_and_hf():
    """Logits of the LED imported by both packages within 1e-5 of each
    other, and within 2e-3 of HF's LEDForConditionalGeneration."""
    hf = _hf_led()
    cfg, jcfg = Seq2SeqConfig(**LED_KW), JSeq2SeqConfig(**LED_KW)
    module = timport.led_from_tree(timport.led_params_from_hf(hf.state_dict(), cfg), cfg)
    jp = jimport.led_params_from_hf(hf.state_dict(), jcfg)
    rng = np.random.default_rng(12)
    ids = rng.integers(4, 250, (2, T)).astype(np.int32)
    am = np.ones((2, T), np.int32)
    gm = np.zeros((2, T), np.int32)
    gm[:, 0] = 1
    dec = rng.integers(4, 250, (2, 8)).astype(np.int32)
    with torch.no_grad():
        enc = tled.led_encode(module, cfg, _t(ids), _t(am), _t(gm))
        hid, _ = tled.led_decode(module, cfg, _t(dec), enc, _t(am))
        got = tled.led_lm_logits(module, hid)
        ref_hf = hf(input_ids=_t(ids).long(), attention_mask=_t(am).long(),
                    global_attention_mask=_t(gm).long(),
                    decoder_input_ids=_t(dec).long()).logits
    jenc = jled.led_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(gm))
    jhid, _ = jled.led_decode(jp, jcfg, jnp.asarray(dec), jenc, jnp.asarray(am))
    ref = np.asarray(jled.led_lm_logits(jp, jhid))
    np.testing.assert_allclose(_np(got), ref, **TOL)
    np.testing.assert_allclose(_np(got), ref_hf.numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_export_then_import_is_the_identity(tmp_path):
    """`longformer_state_dict_arrays` is the inverse of the import (equal to
    the JAX package's export of the same weights); the exported directory
    reloads in ``transformers`` with hidden states within 2e-3 of the
    port's encoder (HF's sliding-window code), and through
    `load_encoder_from_pretrained` back into the same tree, exactly."""
    from transformers import LongformerModel

    cfg = EncoderConfig(**ENC)
    module = init_longformer(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.endswith("bias"):
                p.normal_(0, 0.02)
    tree = flatten_tree({n: p.detach().numpy() for n, p in module.named_parameters()})
    sd = texport.longformer_state_dict_arrays(module, cfg)
    back = timport.longformer_params_from_hf(sd, cfg, prefix="")
    back.pop("type_emb")  # exported as a zero row: the module has none
    assert flatten_tree(back).keys() == tree.keys()
    for k, v in flatten_tree(back).items():
        np.testing.assert_array_equal(v, tree[k], err_msg=k)
    jsd = jexport.longformer_state_dict_arrays(
        jax.tree_util.tree_map(jnp.asarray, _nested(module)), JEncoderConfig(**ENC))
    assert set(jsd) == set(sd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)

    manifest = texport.save_encoder_pretrained(module, cfg, str(tmp_path / "hf"))
    assert manifest == {"format": "transformers:LongformerModel", "n_tensors": len(sd),
                        "adapter": False}
    hf = LongformerModel.from_pretrained(str(tmp_path / "hf")).eval()
    rng = np.random.default_rng(13)
    ids = rng.integers(4, 250, (2, T)).astype(np.int64)
    gm = np.zeros((2, T), np.int64)
    gm[:, 0] = 1
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.ones(2, T).long(),
                 global_attention_mask=torch.from_numpy(gm)).last_hidden_state
        ours = longformer_encode(module, cfg, torch.from_numpy(ids).int(),
                                 torch.ones(2, T, dtype=torch.int32))
    np.testing.assert_allclose(_np(ours), out.numpy(), rtol=2e-3, atol=2e-3)
    loaded = timport.load_encoder_from_pretrained(str(tmp_path / "hf"), cfg)
    loaded.pop("type_emb")
    for k, v in flatten_tree(loaded).items():
        np.testing.assert_array_equal(v, tree[k], err_msg=k)


def _nested(module) -> dict:
    """A Longformer's parameters as the JAX package's nested tree."""
    out: dict = {}
    for n, p in module.named_parameters():
        node, parts = out, n.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach().numpy().copy()
    out["layers"] = [out["layers"][str(i)] for i in range(len(out["layers"]))]
    return out


def test_export_writes_the_adapter_beside_the_model(tmp_path):
    cfg = EncoderConfig(**{**ENC, "adapter_dim": 8})
    module = init_longformer(cfg, torch.Generator().manual_seed(4))
    manifest = texport.save_encoder_pretrained(module, cfg, str(tmp_path / "hf"))
    jmanifest = jexport.save_encoder_pretrained(
        jax.tree_util.tree_map(jnp.asarray, _nested(module)),
        JEncoderConfig(**{**ENC, "adapter_dim": 8}), str(tmp_path / "jhf"))
    assert manifest == jmanifest and manifest["adapter"]
    got, ref = np.load(tmp_path / "hf" / "adapter.npz"), np.load(tmp_path / "jhf" / "adapter.npz")
    assert set(got.files) == set(ref.files) and len(got.files) == 8
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the encoders.npz handoff
# ---------------------------------------------------------------------------

def _rag_cfgs(**kw):
    enc = dict(ENC)
    d = dict(query_enc=enc, mips_enc=enc, memory_enc=enc, mips_topk=2, memory_len=T)
    d.update(kw)
    t = {k: EncoderConfig(**v) if k.endswith("enc") else v for k, v in d.items()}
    j = {k: JEncoderConfig(**v) if k.endswith("enc") else v for k, v in d.items()}
    return (RAGConfig(led=Seq2SeqConfig(**LED_KW), **t),
            JRAGConfig(led=JSeq2SeqConfig(**LED_KW), **j))


def test_encoders_npz_loads_in_both_directions(tmp_path):
    """An ``encoders.npz`` the JAX package exports fills the port's query and
    mips encoders exactly (every other group untouched), through
    ``model.encoder_state_path``; the port's export loads into the JAX
    package's `import_encoders` exactly."""
    cfg, jcfg = _rag_cfgs(memory_model_fixed=False)
    jp = jinit_rag(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "jax_encoders.npz")
    jckpt.export_encoders(path, jp)
    fresh = init_rag(cfg, torch.Generator().manual_seed(0))
    model = init_rag_pretrained(dataclasses.replace(cfg, encoder_state_path=path),
                                torch.Generator().manual_seed(0))
    want = flatten_tree({g: jp[g] for g in ("query_encoder", "mips_encoder")})
    before = dict(fresh.named_parameters())
    for n, p in model.named_parameters():
        if n in want:
            np.testing.assert_array_equal(_np(p), want[n], err_msg=n)
        else:
            assert torch.equal(p, before[n]), n
    out = str(tmp_path / "port_encoders.npz")
    tckpt.export_encoders(out, fresh)
    back = jckpt.import_encoders(out, jp)
    params = dict(fresh.named_parameters())
    for g in ("query_encoder", "mips_encoder"):
        for n, a in flatten_tree(back[g]).items():
            np.testing.assert_array_equal(np.asarray(a), _np(params[f"{g}.{n}"]), err_msg=n)
    np.testing.assert_array_equal(np.asarray(back["led"]["shared_emb"]["table"]),
                                  np.asarray(jp["led"]["shared_emb"]["table"]))


# ---------------------------------------------------------------------------
# the load policy
# ---------------------------------------------------------------------------

def test_missing_encoder_state_path_raises():
    cfg, jcfg = _rag_cfgs(encoder_state_path="/nonexistent/encoders.npz")
    with pytest.raises(FileNotFoundError) as got:
        init_rag_pretrained(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(FileNotFoundError) as ref:
        jimport.load_pretrained_rag(jinit_rag(jax.random.PRNGKey(0), jcfg), jcfg)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("field", ["led_weights", "query_encoder_weights",
                                   "memory_encoder_weights"])
def test_a_local_path_that_fails_to_load_raises(tmp_path, field):
    bad = tmp_path / "not_a_model"
    bad.mkdir()
    cfg, _ = _rag_cfgs(memory_model_fixed=False, **{field: str(bad)})
    with pytest.raises(RuntimeError, match=f"failed to load {field}="):
        init_rag_pretrained(cfg, torch.Generator().manual_seed(0))


def test_an_unfetchable_hub_name_warns_and_keeps_the_seeded_init():
    """Each of the four fields naming a hub model that cannot be fetched:
    four ``[weights] SKIPPING`` warnings, and every parameter bit-equal to
    the seeded init (as the JAX package keeps its random init)."""
    cfg, _ = _rag_cfgs(memory_model_fixed=False, led_weights=HUB, query_encoder_weights=HUB,
                       mips_encoder_weights=HUB, memory_encoder_weights=HUB)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        model = init_rag_pretrained(cfg, torch.Generator().manual_seed(0))
    skipped = [str(x.message) for x in w if "[weights] SKIPPING" in str(x.message)]
    assert len(skipped) == 4
    for field in ("led_weights", "query_encoder_weights", "mips_encoder_weights",
                  "memory_encoder_weights"):
        assert any(f"{field}='{HUB}'" in s for s in skipped)
    fresh = dict(init_rag(cfg, torch.Generator().manual_seed(0)).named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, fresh[n]), n


def test_local_hf_directories_load_through_the_config(tmp_path):
    """``led_weights`` and ``query_encoder_weights`` naming saved HF
    directories (an LED and a Longformer): those groups take the imported
    weights (the Longformer with its token-type row); the rest keep the
    seeded init."""
    hf_led, hf_long = _hf_led(), _hf_longformer()
    hf_led.save_pretrained(str(tmp_path / "led"))
    hf_long.save_pretrained(str(tmp_path / "long"))
    cfg, _ = _rag_cfgs(led_weights=str(tmp_path / "led"),
                       query_encoder_weights=str(tmp_path / "long"))
    model = init_rag_pretrained(cfg, torch.Generator().manual_seed(0))
    want = flatten_tree({
        "led": timport.led_params_from_hf(hf_led.state_dict(), cfg.led),
        "query_encoder": timport.longformer_params_from_hf(hf_long.state_dict(),
                                                           cfg.query_enc, prefix="")})
    fresh = dict(init_rag(cfg, torch.Generator().manual_seed(0)).named_parameters())
    names = dict(model.named_parameters())
    assert "query_encoder.type_emb.table" in names
    for n, p in names.items():
        if n in want:
            np.testing.assert_array_equal(_np(p), want[n], err_msg=n)
        else:
            assert torch.equal(p, fresh[n]), n


def test_build_params_keeps_the_config_s_weight_names_and_fit_runs(tmp_path):
    """A tiny config that keeps the four ``*_weights`` lines of
    configs/led_base_multi_x_science.yaml: `build_params` warns four times
    and returns the seeded init, and `fit` takes its step."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "led_base_multi_x_science.yaml")) as f:
        named = {k: v for k, v in yaml.safe_load(f)["model"].items() if k.endswith("_weights")}
    assert len(named) == 4
    cfg = config_from_dict({
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64,
                  "memory_model_fixed": False, **named},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16, "memory_len": 64,
                 "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10},
        "max_steps": 1, "eval_every": 0,
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "w"},
    })
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        params = cli.build_params(cfg, torch.device("cpu"))
        out = cli.run_fit(cfg, device="cpu")
    skipped = [str(x.message) for x in w if "[weights] SKIPPING" in str(x.message)]
    assert len(skipped) == 8  # four in build_params, four in fit's own
    fresh = dict(init_rag(cfg.model, torch.Generator().manual_seed(cfg.seed))
                 .named_parameters())
    for n, p in params.named_parameters():
        assert torch.equal(p, fresh[n]), n
    assert out["steps"] == 1 and np.isfinite(out["loss"])
