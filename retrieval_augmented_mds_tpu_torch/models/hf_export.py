"""HF weight export: the port's encoders → ``transformers`` directories.

Counterpart of ``retrieval_augmented_mds_tpu/models/hf_export.py``, the
inverse of `hf_import` for the encoder family: a `Longformer` becomes a
standard ``LongformerModel`` directory that ``from_pretrained`` loads
(the retriever's ``save_pretrained`` handoff). ``transformers`` is
imported inside `save_encoder_pretrained` only.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .config import EncoderConfig
from .longformer import Longformer


def longformer_state_dict_arrays(params: Longformer, cfg: EncoderConfig,
                                 type_vocab_size: int = 1) -> dict[str, torch.Tensor]:
    """A `Longformer` → the HF ``LongformerModel`` state dict (bare-model
    names, no ``longformer.`` prefix; CPU f32 tensors that own their
    memory): the exact inverse of
    ``hf_import.longformer_params_from_hf(prefix="")``. Token-type rows
    other than 0 export as zeros (the port keeps row 0 only)."""
    sd: dict[str, torch.Tensor] = {}

    def t(x: torch.Tensor) -> torch.Tensor:
        return x.detach().to("cpu", torch.float32).clone()

    def dense_out(prefix: str, p) -> None:
        # the port's kernel is [in, out]; a torch Linear weight is [out, in]
        sd[prefix + ".weight"] = t(p.kernel).T.contiguous()
        sd[prefix + ".bias"] = t(p.bias)

    def ln_out(prefix: str, p) -> None:
        sd[prefix + ".weight"] = t(p.scale)
        sd[prefix + ".bias"] = t(p.bias)

    e = "embeddings"
    sd[f"{e}.word_embeddings.weight"] = t(params.tok_emb.table)
    sd[f"{e}.position_embeddings.weight"] = t(params.pos_emb.table)
    ln_out(f"{e}.LayerNorm", params.emb_ln)
    tt = torch.zeros((type_vocab_size, params.tok_emb.table.shape[1]))
    if hasattr(params, "type_emb"):
        tt[0] = t(params.type_emb.table)[0]
    sd[f"{e}.token_type_embeddings.weight"] = tt
    for i, layer in enumerate(params.layers):
        b = f"encoder.layer.{i}"
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"),
                             ("qg", "query_global"), ("kg", "key_global"),
                             ("vg", "value_global")):
            dense_out(f"{b}.attention.self.{theirs}", getattr(layer.attn, ours))
        dense_out(f"{b}.attention.output.dense", layer.attn.o)
        ln_out(f"{b}.attention.output.LayerNorm", layer.attn_ln)
        dense_out(f"{b}.intermediate.dense", layer.ffn.w1)
        dense_out(f"{b}.output.dense", layer.ffn.w2)
        ln_out(f"{b}.output.LayerNorm", layer.ffn_ln)
    return sd


def save_encoder_pretrained(params: Longformer, cfg: EncoderConfig,
                            out_dir: str) -> dict[str, Any]:
    """Write a ``transformers``-loadable LongformerModel directory from a
    `Longformer`. Bottleneck adapters have no slot in a vanilla Longformer:
    they go beside it as ``adapter.npz`` (``layers.<i>.<down|up>.<kernel|
    bias>``). Returns the manifest, also written as
    ``export_manifest.json``."""
    from transformers import LongformerConfig, LongformerModel

    hf_cfg = LongformerConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        intermediate_size=cfg.d_ffn, max_position_embeddings=cfg.max_len + cfg.pos_offset,
        attention_window=[2 * cfg.window] * cfg.n_layers, type_vocab_size=1,
        pad_token_id=cfg.pad_id, bos_token_id=cfg.bos_id, eos_token_id=cfg.eos_id,
    )
    model = LongformerModel(hf_cfg, add_pooling_layer=False)
    sd = longformer_state_dict_arrays(params, cfg, type_vocab_size=1)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # every exported tensor must land; the model may own buffers (such as
    # position_ids) that are not weights
    if unexpected:
        raise ValueError(f"unmapped exported keys: {unexpected}")
    bad = [m for m in missing if "position_ids" not in m]
    if bad:
        raise ValueError(f"model weights not covered by export: {bad}")
    os.makedirs(out_dir, exist_ok=True)
    model.save_pretrained(out_dir)

    manifest: dict[str, Any] = {"format": "transformers:LongformerModel",
                                "n_tensors": len(sd), "adapter": False}
    adapters = {f"layers.{i}.{ud}.{wb}": getattr(getattr(layer.adapter, ud), wb)
                .detach().cpu().float().numpy()
                for i, layer in enumerate(params.layers) if hasattr(layer, "adapter")
                for ud in ("down", "up") for wb in ("kernel", "bias")}
    if adapters:
        np.savez(os.path.join(out_dir, "adapter.npz"), **adapters)
        manifest["adapter"] = True
    with open(os.path.join(out_dir, "export_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
