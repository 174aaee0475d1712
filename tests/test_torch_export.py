"""The serving step exported as two `torch.export` programs (`serving`,
``cli export``), on the CPU.

`run_export(device="cpu")` on configs/smoke.yaml (a Flat store) and on the
same config with an ``IVF16,SQ8`` store (15 clusters of the 123-row corpus,
nprobe 2: the per-query route, K8's plain version): the loaded artifact
serves ids equal to the port's eager ``generate(rag_encode(...))``
(configs/no_mips.yaml, the ``export`` subcommand and the ids' parity with
the JAX package: tests/test_torch_export_cli.py). The decode-step
program's log-probs equal the eager step's, bit for bit, at positions 0, 5
and the last: one program, valid at every position. Under `FakeTensorMode`,
the K1, K2 and K8 wrappers on "cuda" fakes give their plain versions'
shapes and dtypes without launching (or reading a pointer): what an export
on the card traces through.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch
import yaml

from retrieval_augmented_mds_tpu_torch import cli, serving
from retrieval_augmented_mds_tpu_torch.index import flat as tflat
from retrieval_augmented_mds_tpu_torch.models import generate as tgen
from retrieval_augmented_mds_tpu_torch.models.retriever_generator import (
    MemoryStore,
    rag_encode,
)
from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_dict(case: str) -> dict:
    name = "no_mips.yaml" if case == "no_mips" else "smoke.yaml"
    with open(os.path.join(REPO, "configs", name)) as f:
        d = yaml.safe_load(f)
    if case == "ivf_sq8":
        d["index"].update(factory="IVF16,SQ8", nprobe=2)
    return d


_EXPORTED: dict = {}


@pytest.fixture
def exported(request, tmp_path_factory):
    """``run_export`` of a case on the CPU, once per case in this module →
    (config, the loaded artifact, its directory, run_export's report)."""
    case = request.param
    if case not in _EXPORTED:
        cfg = config_from_dict(_config_dict(case))
        out = str(tmp_path_factory.mktemp(case))
        report = {}
        manifest = cli.run_export(cfg, out, device="cpu", report=report)
        _EXPORTED[case] = (cfg, serving.load_serving(out), manifest, report)
    return _EXPORTED[case]


def check_served_ids(cfg, art, manifest, report):
    """The manifest and files `run_export` wrote, and the loaded artifact's
    ids against the eager path's on the same params, store and batch."""
    out = os.path.dirname(manifest["artifact"][0])
    assert sorted(os.listdir(out)) == sorted([serving.ENCODE, serving.DECODE_STEP,
                                             serving.MANIFEST, serving.CONFIG])
    with open(os.path.join(out, serving.MANIFEST)) as f:
        assert json.load(f) == manifest == art.manifest
    assert manifest["platforms"] == ["cpu"] and manifest["compute_dtype"] == cfg.precision
    assert manifest["num_beams"] == cfg.generation.num_beams
    assert manifest["max_new_tokens"] == cfg.generation.max_new_tokens
    assert manifest["bytes"] == sum(os.path.getsize(p) for p in manifest["artifact"])
    # the weights and the store are inputs: the archives' data (example
    # inputs, weights, constants) is a few scalar constants
    for path in manifest["artifact"]:
        with zipfile.ZipFile(path) as z:
            data = [i.file_size for i in z.infolist()
                    if "/data/" in i.filename and not i.filename.endswith(".json")]
            assert sum(data) < 1024, data
    batch = report["batch"]
    assert manifest["batch_shapes"] == {k: list(batch[k].shape) for k in sorted(batch)
                                        if k != "labels"}
    assert art.cfg == cfg
    store = report["store"]
    if cfg.model.mips_disabled:
        assert store is None and manifest["store"] is None
    else:
        index = manifest["store"]["fields"]["index"]
        assert index["type"] == ("IVFIndex" if cfg.index.factory.startswith("IVF")
                                 else "FlatIndex")
    ids = serving.serve(art, report["params"], store, batch)
    ref = _eager_ids(cfg, report["params"], store, batch)
    assert ids.shape == (batch["input_ids"].shape[0], cfg.generation.max_new_tokens)
    assert torch.equal(ids, ref)


def _eager_ids(cfg, params, store, batch):
    with torch.no_grad():
        enc = rag_encode(params, cfg.model, store, batch, dtype=torch.float32)
    return tgen.generate(params, cfg.model, enc, cfg.generation, dtype=torch.float32)


@pytest.mark.parametrize("exported", ["flat", "ivf_sq8"], indirect=True)
def test_exported_artifact_serves_the_eager_ids(exported):
    """`check_served_ids` on the Flat and IVF SQ8 stores (no MIPS:
    tests/test_torch_export_cli.py)."""
    check_served_ids(*exported)


@pytest.mark.parametrize("exported", ["flat"], indirect=True)
def test_decode_step_program_holds_at_every_position(exported):
    """One decode-step program at positions 0, 5 and the last gives the
    eager step's log-probs and caches, bit for bit, on the same caches (the
    steps between run eager on seeded token ids). The loaded step's first
    call, at 0, goes through the checked module, the later ones through the
    graph alone."""
    cfg, art, _, report = exported
    params, dtype = report["params"], torch.float32
    enc = serving.serve_encode(art, params, report["store"], report["batch"])
    kv = tgen.copy_head_kv(params, cfg.model, enc, dtype)
    eager = tgen.decode_step(params, cfg.model, dtype, kv)
    loaded = serving.loaded_step(art, params, kv)
    rows = enc.enc_hidden.shape[0] * cfg.generation.num_beams
    steps = cfg.generation.max_new_tokens
    caches = tgen.init_caches(params, cfg.model, rows, steps + 1, dtype, enc.enc_hidden)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.model.led.vocab_size, (steps, rows)).astype(np.int32))
    checked = []
    with torch.no_grad():
        for t in range(steps):
            pos = torch.tensor(t)
            if t in (0, 5, steps - 1):
                mine, got = loaded(enc, toks[t], [dict(c) for c in caches], pos)
            ref, caches = eager(enc, toks[t], caches, pos)
            if t in (0, 5, steps - 1):
                assert torch.equal(mine, ref), t
                for a, b in zip(got, caches):
                    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
                    assert int(a["pos"]) == int(b["pos"]) == t + 1
                checked.append(t)
    assert checked == [0, 5, steps - 1]


@pytest.mark.parametrize("exported", ["flat"], indirect=True)
def test_serve_refuses_another_store(exported):
    """A store whose static part differs from the exported one (here its
    probe width) is refused, not served through the wrong program."""
    import dataclasses

    cfg, art, _, report = exported
    other = dataclasses.replace(report["store"], nprobe=report["store"].nprobe + 1)
    with pytest.raises(ValueError, match="not the one the artifact was exported with"):
        serving.serve(art, report["params"], other, report["batch"])


def test_store_leaves_round_trip():
    """A store's leaves rebuild the store; its static part is JSON."""
    idx = tflat.build_flat_index(np.eye(8, 16, dtype=np.float32), dtype="int8")
    store = MemoryStore(index=idx, token_ids=torch.zeros((8, 4), dtype=torch.int32),
                        token_mask=torch.ones((8, 4), dtype=torch.int32), nprobe=3)
    spec, leaves = serving.store_leaves(store)
    assert json.loads(json.dumps(spec)) == spec and len(leaves) == 5
    back = serving.store_from_leaves(spec, leaves)
    assert back.nprobe == 3 and back.row_aids is None and back.index.n == 8
    assert back.index.embeddings is idx.embeddings and back.index.row_scale is idx.row_scale


def test_kernel_wrappers_trace_on_fake_cuda_tensors():
    """K1 (`mips_topk`), K2 (`flash_sliding_attention`) and K8
    (`ivf_probe_topk`) on `FakeTensorMode` fakes on "cuda" reach their
    custom ops' fake implementations: the plain versions' shapes and dtypes
    on the CPU, on "cuda", no launch counted and no pointer read."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from retrieval_augmented_mds_tpu_torch.index.ivf_serving import (
        ivf_probe_topk,
        ivf_probe_topk_plain,
    )
    from retrieval_augmented_mds_tpu_torch.ops.flash_sliding import (
        flash_sliding_attention,
        local_rows_plain,
    )
    from retrieval_augmented_mds_tpu_torch.ops.mips_topk import (
        mips_topk,
        mips_topk_plain,
        quantize_corpus_sq8,
    )

    g = torch.Generator().manual_seed(0)
    cases = []
    for corpus_dtype in (torch.float32, torch.bfloat16, torch.int8):
        q = torch.randn(3, 64, generator=g)
        e = torch.randn(50, 64, generator=g)
        scale = None
        if corpus_dtype == torch.int8:
            e, scale = quantize_corpus_sq8(e)
        else:
            e = e.to(corpus_dtype)
        args = (q, e, 7, torch.zeros(50), torch.full((3, 2), -1, dtype=torch.int32), scale)
        cases.append((mips_topk, mips_topk_plain, args, {}))
    b, nh, t, dh, w, n_glob = 2, 2, 128, 32, 32, 4
    for dtype in (torch.float32, torch.bfloat16):
        x = [torch.randn(b, nh, t, dh, generator=g).to(dtype) for _ in range(3)]
        kg = [torch.randn(b, nh, n_glob, dh, generator=g).to(dtype) for _ in range(2)]
        args = (*x, torch.zeros(b, t), *kg, torch.zeros(b, n_glob))
        cases.append((lambda *a: flash_sliding_attention(*a, window=w, return_stats=True),
                      lambda *a: local_rows_plain(*a, w, return_stats=True), args, {}))
    c, L, d = 6, 16, 32
    for payload in (torch.int8, torch.bfloat16):
        e = torch.randn(c * L, d, generator=g)
        scale = None
        if payload == torch.int8:
            e, scale = quantize_corpus_sq8(e)
            scale = scale.reshape(c, L)
        args = (torch.randn(4, d, generator=g), e.to(payload).reshape(c, L, d),
                torch.zeros(c, L), scale, torch.randint(0, c, (4, 3), generator=g,
                                                        dtype=torch.int32), 5)
        cases.append((ivf_probe_topk, ivf_probe_topk_plain, args, {}))

    counters = (mips_topk, flash_sliding_attention, ivf_probe_topk)
    before = [f.launches for f in counters]
    for wrapper, plain, args, _ in cases:
        ref = plain(*args)
        with FakeTensorMode():
            fakes = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                     if isinstance(a, torch.Tensor) else a for a in args]
            got = wrapper(*fakes)
        assert len(got) == len(ref)
        for o, r in zip(got, ref):
            assert (o.shape, o.dtype, o.device.type) == (r.shape, r.dtype, "cuda")
    assert [f.launches for f in counters] == before
