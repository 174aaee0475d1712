"""The port's own copies of the JAX package's host-side modules (data,
ROUGE, metrics logging, the architecture configs) against the originals,
on the committed fixtures; and the guard that the port imports nothing of
the JAX package.

Every copy must behave exactly like its original: equal arrays, equal
token ids, equal ROUGE scores, equal config fields.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from retrieval_augmented_mds_tpu import data as jdata
from retrieval_augmented_mds_tpu.data import corpus as jcorpus
from retrieval_augmented_mds_tpu.eval import rouge as jrouge
from retrieval_augmented_mds_tpu.models import config as jmconfig
from retrieval_augmented_mds_tpu.obs import logging as jlogging
from retrieval_augmented_mds_tpu.utils import config as jconfig
from retrieval_augmented_mds_tpu_torch import data as tdata
from retrieval_augmented_mds_tpu_torch.data import corpus as tcorpus
from retrieval_augmented_mds_tpu_torch.eval import rouge as trouge
from retrieval_augmented_mds_tpu_torch.models import config as tmconfig
from retrieval_augmented_mds_tpu_torch.obs import logging as tlogging
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "retrieval_augmented_mds_tpu", "data", "fixtures")


def _frames_equal(a: pd.DataFrame, b: pd.DataFrame):
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True))


def _modules(pkg, corpus, **kw):
    df = corpus.load_fixture(os.path.join(FIXTURES, "multi_x_science_200.json.gz"))
    tok = pkg.load_tokenizer(None, vocab_size=512)
    qtok = pkg.load_tokenizer(None, vocab_size=300)
    return pkg.RAGDataModule(df, tok, qtok, max_length=128, query_max_length=64,
                             decoder_max_length=32, memory_len=48, **kw).prepare()


@pytest.mark.parametrize("kw", [{}, {"source_memory": True, "dual_memory": True},
                                {"corpus_column": "related_work"}],
                         ids=["default", "source_dual", "related_work"])
def test_data_module_arrays_equal_jax(kw):
    """The fixture through both pipelines: the same corpus, store arrays,
    example arrays, splits and batches."""
    t, j = _modules(tdata, tcorpus, **kw), _modules(jdata, jcorpus, **kw)
    _frames_equal(t.corpus, j.corpus)
    assert t.aid_vocab == j.aid_vocab
    for arrays in ("store_arrays", "examples"):
        ta, ja = getattr(t, arrays), getattr(j, arrays)
        assert sorted(ta) == sorted(ja)
        for k in ta:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=f"{arrays}.{k}")
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(t.split_indices(split), j.split_indices(split))
        tb = list(t.batches(4, seed=3, split=split, drop_last=False))
        jb = list(j.batches(4, seed=3, split=split, drop_last=False, native=False))
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_corpus_builders_equal_jax():
    df = jcorpus.load_fixture(os.path.join(FIXTURES, "multi_x_science_200.json.gz"))
    _frames_equal(tcorpus.load_fixture(), jcorpus.load_fixture())
    _frames_equal(tcorpus.aggregate_by_aid(df), jcorpus.aggregate_by_aid(df))
    _frames_equal(tcorpus.synthetic_multi_x_science(40, seed=2),
                  jcorpus.synthetic_multi_x_science(40, seed=2))
    arxiv = os.path.join(FIXTURES, "arxiv_64.parquet")
    _frames_equal(tcorpus.load_mips_arxiv2(arxiv), jcorpus.load_mips_arxiv2(arxiv))
    _frames_equal(tcorpus.load_mips_arxiv_x_science(arxiv, df),
                  jcorpus.load_mips_arxiv_x_science(arxiv, df))
    text = "as in @cite_12 and @cite_3, $x^2$ holds"
    assert tcorpus.strip_cites(text) == jcorpus.strip_cites(text)
    assert tcorpus.clean_arxiv_text(text) == jcorpus.clean_arxiv_text(text)


def test_tokenizer_ids_equal_jax():
    df = jcorpus.load_fixture()
    texts = list(df["abstract"][:30]) + ["a <DOC_SEP> b", ""]
    for vocab in (512, 50266):
        t, j = tdata.load_tokenizer(None, vocab_size=vocab), jdata.load_tokenizer(
            None, vocab_size=vocab)
        for special in (True, False):
            a, b = t(texts, max_length=96, add_special_tokens=special), j(
                texts, max_length=96, add_special_tokens=special)
            for k in ("input_ids", "attention_mask"):
                np.testing.assert_array_equal(a[k], b[k])
        ids = a["input_ids"]
        assert t.batch_decode(ids) == j.batch_decode(ids)


def test_rouge_scores_equal_jax():
    df = jcorpus.load_fixture()
    preds = [jcorpus.strip_cites(s)[:300] for s in df["related_work"][:12]]
    refs = [s[:400] for s in df["abstract"][:12]]
    assert trouge.rouge_scores(preds, refs) == jrouge.rouge_scores(preds, refs)
    assert trouge._fallback_scores(preds[0], refs[0]) == jrouge._fallback_scores(
        preds[0], refs[0])
    acc_t, acc_j = trouge.RougeAccumulator(), jrouge.RougeAccumulator()
    for acc in (acc_t, acc_j):
        acc.add_batch(preds[:5], refs[:5])
        acc.add_batch(preds[5:], refs[5:])
    assert acc_t.compute() == acc_j.compute()


def test_metrics_logger_writes_what_jax_writes(tmp_path):
    rows = []
    for pkg, sub in ((tlogging, "t"), (jlogging, "j")):
        log = pkg.MetricsLogger(str(tmp_path / sub), "run")
        log.log(3, {"loss": np.float32(1.5), "note": object}, prefix="val_")
        log.log_hyperparams({"a": 1, "b": [1, 2]})
        log.dump_outputs("out", [{"prediction": "x", "reference": "y"}])
        log.close()
        with open(tmp_path / sub / "run.metrics.jsonl") as f:
            row = json.loads(f.read())
        row.pop("time")
        rows.append(row)
        for name in ("hparams.json", "out.json"):
            with open(tmp_path / sub / name) as f:
                rows.append(f.read())
    assert rows[:3] == rows[3:]
    # the TensorBoard and mlflow mirrors (their records: tests/test_torch_obs.py)
    log = tlogging.MetricsLogger(str(tmp_path / "tb"), tensorboard=True, mlflow=True)
    log.log(0, {"loss": 1.0})
    log.close()
    assert os.listdir(tmp_path / "tb" / "tb" / "run")
    assert os.listdir(tmp_path / "tb" / "mlruns" / "0")


def test_config_presets_equal_jax_field_by_field():
    for cls in ("EncoderConfig", "Seq2SeqConfig"):
        t, j = getattr(tmconfig, cls), getattr(jmconfig, cls)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        presets = [n for n, v in vars(j).items() if isinstance(v, staticmethod)]
        assert presets == [n for n, v in vars(t).items() if isinstance(v, staticmethod)]
        for name in presets:
            assert dataclasses.asdict(getattr(t, name)()) == dataclasses.asdict(
                getattr(j, name)()), f"{cls}.{name}"
    for name in ("tiny", "led_base", "led_large"):
        assert dataclasses.asdict(tconfig._PRESETS[name]()) == dataclasses.asdict(
            jconfig._PRESETS[name]()), name


# ---------------------------------------------------------------------------
# the guard: the port imports nothing of the JAX package
# ---------------------------------------------------------------------------

_GUARD = """
import importlib, json, pkgutil, sys
import retrieval_augmented_mds_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for m in mods:
    importlib.import_module(m)
from retrieval_augmented_mds_tpu_torch import cli, serving
out, configs = sys.argv[1], sys.argv[2:]
for path in configs:
    assert cli.main(['predict', '--config', path, '--device', 'cpu']) == 0
# the export of the first config, loaded and served
assert cli.main(['export', '--config', configs[0], '--device', 'cpu', '--out', out]) == 0
art = serving.load_serving(out)
rep = {}
cli.run_predict(art.cfg, device='cpu', report=rep)
assert serving.serve(art, rep['params'], rep['store'], rep['batch']).equal(rep['ids'])
bad = sorted(k for k, v in sys.modules.items() if v is not None and (
    k == 'jax' or k.startswith('jax.') or k == 'retrieval_augmented_mds_tpu'
    or k.startswith('retrieval_augmented_mds_tpu.')))
print(json.dumps({'modules': mods, 'bad': bad}))
"""


def test_port_and_chip_smoke_import_nothing_of_jax(tmp_path):
    """A fresh interpreter imports every module of the port and runs
    `predict` on configs/smoke.yaml (Flat), on an IVF SQ8 variant, and on
    a variant that samples and returns copy traces (``do_sample``,
    ``output_copy_probs``) under ``target_in`` on the CPU (their batches
    through the native loader), then `export`s configs/smoke.yaml and
    serves the loaded artifact; neither JAX nor the JAX package is then
    loaded. chip_smoke.py imports neither either."""
    import yaml

    with open(os.path.join(REPO, "configs", "smoke.yaml")) as f:
        d = yaml.safe_load(f)
    d["index"].update(factory="IVF16,SQ8", nprobe=2)
    ivf_cfg = str(tmp_path / "smoke_ivf.yaml")
    with open(ivf_cfg, "w") as f:
        yaml.safe_dump(d, f)
    d["index"].update(factory="Flat")
    d["model"].update(memory_forcing="target_in", copy_forcing=0.5)
    d["generation"].update(num_beams=1, do_sample=True, top_k=10, top_p=0.9,
                           output_copy_probs=True)
    modes_cfg = str(tmp_path / "smoke_modes.yaml")
    with open(modes_cfg, "w") as f:
        yaml.safe_dump(d, f)
    res = subprocess.run(
        [sys.executable, "-c", _GUARD, str(tmp_path / "export"),
         os.path.join(REPO, "configs", "smoke.yaml"), ivf_cfg, modes_cfg],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for m in ("data.pipeline", "eval.rouge", "obs.logging", "models.config", "index.ivf",
              "index.ivf_serving", "index.augment", "serving", "data.native_loader",
              "data.ingest", "utils.cpu_baseline", "utils.native_build"):
        assert f"retrieval_augmented_mds_tpu_torch.{m}" in out["modules"]

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    roots = {m.split(".")[0] for m in imported}
    assert "jax" not in roots and "retrieval_augmented_mds_tpu" not in roots
    assert "retrieval_augmented_mds_tpu_torch" in roots
