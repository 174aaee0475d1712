"""HF weight import: ``transformers`` state dicts → the port's modules.

Counterpart of ``retrieval_augmented_mds_tpu/models/hf_import.py``. The
converters read an HF state dict (tensors or arrays) and return the param
tree under the JAX package's names and layouts, as numpy f32 arrays:
dense kernels [d_in, d_out] (the HF weight transposed),
``final_logits_bias`` as [V], token-type row 0 as ``type_emb``. The tree
loads into a module with no renames (`bridge.load_jax_params`);
`led_from_tree` and `encoder_from_tree` build the module the tree fits.
``transformers`` is imported inside the loaders only.

`load_pretrained_rag` applies the JAX package's policy: a field that names
an existing local path must load, or the call raises; a name that is not a
local path and fails to load (no network, no cache, no ``transformers``)
warns ``[weights] SKIPPING ...`` and keeps the group's random init.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from ..bridge import load_jax_params
from .config import EncoderConfig, Seq2SeqConfig
from .led import LED
from .longformer import Longformer


def _t(sd: Mapping[str, Any], key: str) -> np.ndarray:
    w = sd[key]
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().float().numpy()
    return np.array(w, np.float32)


def _dense(sd, prefix: str) -> dict:
    return {"kernel": _t(sd, prefix + ".weight").T.copy(),
            "bias": _t(sd, prefix + ".bias")}


def _ln(sd, prefix: str) -> dict:
    return {"scale": _t(sd, prefix + ".weight"), "bias": _t(sd, prefix + ".bias")}


def _emb(sd, key: str) -> dict:
    return {"table": _t(sd, key)}


def _copy(p: dict) -> dict:
    return {k: v.copy() for k, v in p.items()}


def led_params_from_hf(sd: Mapping[str, Any], cfg: Seq2SeqConfig) -> dict:
    """LEDForConditionalGeneration state dict → the LED tree."""
    p: dict = {
        "shared_emb": _emb(sd, "led.shared.weight"),
        "enc_pos": _emb(sd, "led.encoder.embed_positions.weight"),
        "dec_pos": _emb(sd, "led.decoder.embed_positions.weight"),
        "enc_emb_ln": _ln(sd, "led.encoder.layernorm_embedding"),
        "dec_emb_ln": _ln(sd, "led.decoder.layernorm_embedding"),
        "final_logits_bias": _t(sd, "final_logits_bias").reshape(-1),
    }
    enc = []
    for i in range(cfg.enc_layers):
        b = f"led.encoder.layers.{i}"
        a = f"{b}.self_attn.longformer_self_attn"
        enc.append({
            "attn": {
                "q": _dense(sd, f"{a}.query"), "k": _dense(sd, f"{a}.key"),
                "v": _dense(sd, f"{a}.value"), "qg": _dense(sd, f"{a}.query_global"),
                "kg": _dense(sd, f"{a}.key_global"), "vg": _dense(sd, f"{a}.value_global"),
                "o": _dense(sd, f"{b}.self_attn.output"),
            },
            "attn_ln": _ln(sd, f"{b}.self_attn_layer_norm"),
            "ffn": {"w1": _dense(sd, f"{b}.fc1"), "w2": _dense(sd, f"{b}.fc2")},
            "ffn_ln": _ln(sd, f"{b}.final_layer_norm"),
        })
    dec = []
    for i in range(cfg.dec_layers):
        b = f"led.decoder.layers.{i}"
        dec.append({
            "self_attn": {n: _dense(sd, f"{b}.self_attn.{h}_proj")
                          for n, h in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))},
            "self_ln": _ln(sd, f"{b}.self_attn_layer_norm"),
            "cross_attn": {n: _dense(sd, f"{b}.encoder_attn.{h}_proj")
                           for n, h in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))},
            "cross_ln": _ln(sd, f"{b}.encoder_attn_layer_norm"),
            "ffn": {"w1": _dense(sd, f"{b}.fc1"), "w2": _dense(sd, f"{b}.fc2")},
            "ffn_ln": _ln(sd, f"{b}.final_layer_norm"),
        })
    p["encoder"] = enc
    p["decoder"] = dec
    return p


def _embeddings(sd, pre: str) -> dict:
    e = f"{pre}embeddings"
    p: dict = {
        "tok_emb": _emb(sd, f"{e}.word_embeddings.weight"),
        "pos_emb": _emb(sd, f"{e}.position_embeddings.weight"),
        "emb_ln": _ln(sd, f"{e}.LayerNorm"),
    }
    # token-type row 0 is an additive constant on every position
    tt = f"{e}.token_type_embeddings.weight"
    if tt in sd:
        p["type_emb"] = {"table": _t(sd, tt)[:1].copy()}
    return p


def _block(sd, b: str, attn: dict) -> dict:
    attn["o"] = _dense(sd, f"{b}.attention.output.dense")
    return {
        "attn": attn,
        "attn_ln": _ln(sd, f"{b}.attention.output.LayerNorm"),
        "ffn": {"w1": _dense(sd, f"{b}.intermediate.dense"),
                "w2": _dense(sd, f"{b}.output.dense")},
        "ffn_ln": _ln(sd, f"{b}.output.LayerNorm"),
    }


def longformer_params_from_hf(sd: Mapping[str, Any], cfg: EncoderConfig,
                              prefix: str = "longformer") -> dict:
    """LongformerModel state dict (keys under ``prefix``) → the encoder tree."""
    pre = f"{prefix}." if prefix else ""
    p = _embeddings(sd, pre)
    layers = []
    for i in range(cfg.n_layers):
        b = f"{pre}encoder.layer.{i}"
        a = f"{b}.attention.self"
        attn = {ours: _dense(sd, f"{a}.{theirs}") for ours, theirs in (
            ("q", "query"), ("k", "key"), ("v", "value"), ("qg", "query_global"),
            ("kg", "key_global"), ("vg", "value_global"))}
        layers.append(_block(sd, b, attn))
    p["layers"] = layers
    return p


def bert_params_from_hf(sd: Mapping[str, Any], cfg: EncoderConfig, prefix: str = "bert",
                        adapter_name: str | None = None) -> dict:
    """BERT-family state dict (SPECTER2's base is a BERT encoder) → the
    encoder tree. The global projections start as copies of the local ones
    (HF's "longformerization" of RoBERTa checkpoints): separate arrays, so
    the module gets separate parameters. ``adapter_name`` also reads a
    bottleneck adapter saved by the ``adapters`` library
    (``<layer>.output.adapters.<name>.adapter_down.0`` / ``adapter_up``)."""
    pre = f"{prefix}." if prefix else ""
    p = _embeddings(sd, pre)
    layers = []
    for i in range(cfg.n_layers):
        b = f"{pre}encoder.layer.{i}"
        a = f"{b}.attention.self"
        q, k, v = (_dense(sd, f"{a}.{n}") for n in ("query", "key", "value"))
        layer = _block(sd, b, {"q": q, "k": k, "v": v,
                               "qg": _copy(q), "kg": _copy(k), "vg": _copy(v)})
        if adapter_name is not None:
            ad = f"{b}.output.adapters.{adapter_name}"
            layer["adapter"] = {"down": _dense(sd, f"{ad}.adapter_down.0"),
                                "up": _dense(sd, f"{ad}.adapter_up")}
        layers.append(layer)
    p["layers"] = layers
    return p


# ---------------------------------------------------------------------------
# trees → modules
# ---------------------------------------------------------------------------

def led_from_tree(tree: dict, cfg: Seq2SeqConfig, device=None) -> LED:
    return load_jax_params(LED(cfg), tree).to(device)


def encoder_from_tree(tree: dict, cfg: EncoderConfig, device=None) -> Longformer:
    """The Longformer that ``tree`` fits: with ``type_emb`` when the tree has
    the token-type row, and adapters of the tree's width when it has them
    (whatever ``cfg.adapter_dim`` says, as the JAX forward follows its tree)."""
    layers = tree["layers"]
    dim = layers[0]["adapter"]["down"]["kernel"].shape[1] if layers and "adapter" in layers[0] \
        else 0
    module = Longformer(dataclasses.replace(cfg, adapter_dim=dim), type_emb="type_emb" in tree)
    return load_jax_params(module, tree).to(device)


# ---------------------------------------------------------------------------
# loaders (transformers is imported here only)
# ---------------------------------------------------------------------------

def load_led_from_pretrained(name_or_path: str, cfg: Seq2SeqConfig) -> dict:
    from transformers import LEDForConditionalGeneration

    model = LEDForConditionalGeneration.from_pretrained(name_or_path)
    return led_params_from_hf(model.state_dict(), cfg)


def load_longformer_from_pretrained(name_or_path: str, cfg: EncoderConfig) -> dict:
    from transformers import LongformerModel

    model = LongformerModel.from_pretrained(name_or_path)
    return longformer_params_from_hf(model.state_dict(), cfg)


def load_encoder_from_pretrained(name_or_path: str, cfg: EncoderConfig,
                                 adapter_name: str | None = None) -> dict:
    """Any encoder the reference uses, as the encoder tree: Longformer
    checkpoints map directly, BERT-family ones (SPECTER2's base) through
    `bert_params_from_hf`."""
    from transformers import AutoConfig, AutoModel

    hf_cfg = AutoConfig.from_pretrained(name_or_path)
    if getattr(hf_cfg, "model_type", "") == "longformer":
        from transformers import LongformerModel

        model = LongformerModel.from_pretrained(name_or_path)
        return longformer_params_from_hf(model.state_dict(), cfg, prefix="")
    model = AutoModel.from_pretrained(name_or_path)
    return bert_params_from_hf(model.state_dict(), cfg, prefix="", adapter_name=adapter_name)


def load_with_policy(field: str, name: str | None, group: str, fn):
    """``fn(name)`` under the load policy → its result, or None when the
    name is unset or a hub name failed (a warning says so). A failure on an
    existing local path raises RuntimeError."""
    if not name:
        return None
    try:
        out = fn(name)
    except Exception as e:  # noqa: BLE001
        if os.path.exists(name):
            raise RuntimeError(f"failed to load {field}={name!r} into {group}: {e}") from e
        warnings.warn(f"[weights] SKIPPING {field}={name!r} ({group} stays randomly "
                      f"initialized): {type(e).__name__}: {e}", stacklevel=3)
        return None
    print(f"[weights] {group} <- {name}")
    return out


def load_pretrained_rag(params, cfg):
    """Fill a `RAG` module with the pretrained weights its config names
    (``led_weights``, ``query_encoder_weights``, ``mips_encoder_weights``,
    ``memory_encoder_weights``, then ``encoder_state_path``, the
    ``encoders.npz`` that ``pretrain-retriever`` exports). Each loaded group
    replaces the module's submodule, on the same device. A missing
    ``encoder_state_path`` raises FileNotFoundError."""
    device = next(params.parameters()).device
    groups = (
        ("led_weights", "led",
         lambda n: led_from_tree(load_led_from_pretrained(n, cfg.led), cfg.led, device)),
        ("query_encoder_weights", "query_encoder",
         lambda n: encoder_from_tree(load_encoder_from_pretrained(
             n, cfg.query_enc, adapter_name=cfg.adapter_name), cfg.query_enc, device)),
        ("mips_encoder_weights", "mips_encoder",
         lambda n: encoder_from_tree(load_encoder_from_pretrained(
             n, cfg.mips_enc, adapter_name=cfg.adapter_name), cfg.mips_enc, device)),
        ("memory_encoder_weights", "memory_encoder",
         lambda n: encoder_from_tree(load_encoder_from_pretrained(n, cfg.memory_enc),
                                     cfg.memory_enc, device)),
    )
    for field, group, fn in groups:
        module = load_with_policy(field, getattr(cfg, field), group, fn)
        if module is not None:
            setattr(params, group, module)

    if cfg.encoder_state_path:
        # the retriever-pretraining handoff
        if not os.path.exists(cfg.encoder_state_path):
            raise FileNotFoundError(
                f"model.encoder_state_path={cfg.encoder_state_path!r} does not exist "
                "(expected encoders.npz exported by `pretrain-retriever`)")
        from ..utils.checkpoint import import_encoders

        import_encoders(cfg.encoder_state_path, params)
        print(f"[weights] query/mips encoders <- {cfg.encoder_state_path}")
    return params
