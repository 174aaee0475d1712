"""The eval loop's ragged last batch, against the JAX package, on the CPU.

The JAX package's `run_eval_loop` pads the last batch of a split to
``data.batch_size`` with copies of its first row and keeps the first
``n_real`` outputs. The batch size picks the IVF search's route (B·nprobe
against the cluster count C), so a tail run at its own size can take a
probed route where the padded batch takes the exact one, and retrieve
other rows. Here the val split ends in a tail of 2 at batch size 4, over
an IVF index of C clusters with 2·nprobe < C <= 4·nprobe.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny) through
`bridge.load_jax_params`, the index is the JAX package's (its arrays
through `bridge`); everything is f32.
"""

import json

import jax
import numpy as np
import torch

from retrieval_augmented_mds_tpu import cli as jcli
from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu.utils import config as jconfig
from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.index.ivf import ivf_route
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_ivf import port_ivf
from tests.test_torch_models import _t, port_params

torch.set_num_threads(1)
B, NPROBE = 4, 4


def _config(tmp_path, seed):
    return {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 60, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16, "memory_len": 64,
                 "batch_size": B},
        "index": {"factory": "IVF16,Flat", "nprobe": NPROBE, "dtype": "float32"},
        "generation": {"max_new_tokens": 6, "num_beams": 2},
        "seed": seed,
        "logging": {"log_dir": str(tmp_path), "run_name": "tail"},
    }


def _pad(batch, n):
    return {k: np.concatenate([v, np.repeat(v[:1], n - len(v), axis=0)])
            for k, v in batch.items()}


def test_eval_tail_is_padded_as_jax_pads_it(tmp_path, monkeypatch, capsys):
    """The val split (6 rows) ends in a tail of 2: 2·4 = 8 < C <= 16 = 4·4.
    Padded to 4 rows, the tail takes the exact flat route in both packages:
    its retrieved ids equal the JAX package's, and so do the predictions of
    the whole split and its ROUGE (within 1e-6). Run at its own size, as
    the port's loop ran it before, the tail takes the per-query probed
    route and retrieves other rows than the JAX package."""
    d = _config(tmp_path, seed=3)
    jcfg, cfg = jconfig.config_from_dict(d), tconfig.config_from_dict(d)
    jdm, jtok = jcli.build_data(jcfg)
    dm, tok = cli.build_data(cfg)
    jp = jrag.init_rag(jax.random.PRNGKey(cfg.seed), jcfg.model)
    model = port_params(cfg.model, jp)
    jstore = jcli.build_store(jp, jcfg, jdm)
    arr = dm.store_arrays
    tstore = trag.MemoryStore(index=port_ivf(jstore.index), token_ids=_t(arr["token_ids"]),
                              token_mask=_t(arr["token_mask"]),
                              row_aids=_t(arr["row_aids"]), nprobe=NPROBE)
    c = tstore.index.n_clusters
    assert 2 * NPROBE < c <= B * NPROBE, c
    tail = list(dm.batches(B, shuffle=False, drop_last=False, split="val"))[-1]
    assert len(tail["input_ids"]) == 2
    k, n_ign = cfg.model.mips_topk, tail["mips_ignore"].shape[1]
    assert ivf_route(tstore.index, 2, k, NPROBE, n_ign) == "per_query"
    assert ivf_route(tstore.index, B, k, NPROBE, n_ign) == "flat"

    seen = []
    real = trag.rag_encode

    def recording(*a, **kw):
        enc = real(*a, **kw)
        seen.append(enc.retrieved_idx.clone())
        return enc

    monkeypatch.setattr(trag, "rag_encode", recording)
    got = cli.run_eval_loop(cfg, model, tstore, dm, tok, dump_name="port", split="val",
                            device=torch.device("cpu"))
    monkeypatch.setattr(trag, "rag_encode", real)
    ref = jcli.run_eval_loop(jcfg, jp, jstore, jdm, jtok, dump_name="jax", split="val")
    assert [tuple(s.shape) for s in seen] == [(B, k), (B, k)]
    port_out = json.loads((tmp_path / "port.json").read_text())
    jax_out = json.loads((tmp_path / "jax.json").read_text())
    assert len(port_out) == 6 and port_out == jax_out
    assert set(got) == set(ref)
    for m in ref:
        np.testing.assert_allclose(got[m], float(ref[m]), rtol=1e-6, err_msg=m)

    # the JAX package's tail: padded, searched by its own rag_encode
    jenc = jrag.rag_encode(jp, jcfg.model, jstore, jcli._device_batch(_pad(tail, B), jcfg))
    want = np.asarray(jenc.retrieved_idx)[:2]
    np.testing.assert_array_equal(seen[-1][:2].numpy(), want)
    # the tail at its own size: the probed route retrieves other rows
    with torch.no_grad():
        old = trag.rag_encode(model, cfg.model, tstore,
                              cli.device_batch(tail, cfg, torch.device("cpu")))
    old_ids = old.retrieved_idx.numpy()
    print(f"tail ids: padded (port and JAX) {want.tolist()}, unpadded {old_ids.tolist()}")
    assert not np.array_equal(old_ids, want)
