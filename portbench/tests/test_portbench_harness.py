"""CPU tests of the benchmark: the traffic, the counters, the harness's
data-driven cells, its result line, the reference against the port, and the
comparison against planted faults and the control, at the tiny preset.

    python -m pytest portbench/tests -q

The tests that need a card carry the ``cuda`` marker and skip here."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, roofline, traffic, work
from portbench.reference import judge
from portbench.reference import model as ref

CELLS = Path(__file__).resolve().parent / "cells"
SEED = 2**31 + 9  # seeds run past 32 signed bits
TRAINING_NUMBERS = ("loss_rel", "grad_leaf", "update_leaf", "grad_median", "update_median")
SPEC = json.loads((harness.HERE / "workloads" / "rag_train.mxs_b16.json").read_text())["traffic"]
WIDTHS = {"source": 256, "query": 128, "target": 32, "memory": 64}


def tiny_bench(path: Path) -> Path:
    """A BENCHMARK.json of the tiny cells."""
    bench = {
        "end_to_end": [
            {"name": "train_examples_per_s", "unit": "examples/s",
             "workloads": ["tiny_rag_train", "tiny_retriever_train", "tiny_copy"]},
            {"name": "summaries_per_s", "unit": "summaries/s", "workloads": ["tiny_rag_predict"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "data_wait_ms.train", "unit": "ms", "moves": "train_examples_per_s"},
            {"name": "store_build_s.setup", "unit": "s", "moves": "setup_s"},
            {"name": "encode_ms.predict", "unit": "ms", "moves": "summaries_per_s"}]}
    path.write_text(json.dumps(bench))
    return path


def execute(tmp_path, cell, trace=False, control=None, base=CELLS, seconds=0.3):
    return harness.execute(cell, SEED, seconds, trace, device="cpu", base=base,
                           bench_file=tiny_bench(tmp_path / "BENCHMARK.json"), control=control)


def gen(seed, papers=(40, 8)):
    spec = dict(SPEC, papers={"train": papers[0], "test": papers[1]})
    return traffic.generate(spec, seed, vocab_size=512, doc_sep=511, widths=WIDTHS)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def test_traffic_is_a_function_of_the_seed():
    a, b, c = gen(SEED), gen(SEED), gen(SEED + 1)
    for split in ("train", "test"):
        for k, v in a[split].items():
            assert np.array_equal(v, b[split][k]), k
    assert not np.array_equal(a["train"]["input_ids"], c["train"]["input_ids"])
    assert np.array_equal(a["corpus"]["token_ids"], b["corpus"]["token_ids"])


@pytest.mark.parametrize("key", ["abstract_words", "cited_words", "target_words"])
def test_lengths_meet_their_stated_means(key):
    n = 20000
    x = traffic.lengths(np.random.default_rng(SEED), n, SPEC[key])
    mean = SPEC[key]["mean"]
    assert abs(x.mean() - mean) < 4 * x.std() / np.sqrt(n) + 0.5  # + the rounding


def test_citations_meet_their_stated_mean():
    n = 20000
    x = traffic.counts(np.random.default_rng(SEED), n, SPEC["cited_per_paper"])
    assert x.min() >= 1
    assert abs(x.mean() - SPEC["cited_per_paper"]["mean"]) < 4 * x.std() / np.sqrt(n)


def test_traffic_lays_out_rows_as_the_pipeline():
    spec = dict(SPEC, papers={"train": 40, "test": 8})
    t = traffic.generate(spec, SEED, vocab_size=512, doc_sep=511,
                         widths=dict(WIDTHS, source=2048))
    src, mask = t["train"]["input_ids"], t["train"]["attention_mask"]
    assert (src[:, 0] == traffic.BOS).all()
    ends = mask.sum(1) - 1
    assert (src[np.arange(len(src)), ends] == traffic.EOS).all()
    assert ((src == 511).sum(1) >= 1).all()  # a <DOC_SEP> before each cited abstract
    assert ((src == traffic.PAD) == (mask == 0)).all()
    ign = t["train"]["mips_ignore"]
    assert ((ign == -1) | ((ign >= 0) & (ign < t["corpus_rows"]))).all()
    assert (t["test"]["mips_ignore"] == -1).all()


def test_type_ids_are_the_port_tokenizer_ids():
    from retrieval_augmented_mds_tpu_torch.data.tokenizer import HashTokenizer

    tok = HashTokenizer(vocab_size=50266)
    ids = traffic.type_ids(300, 50266)
    assert [tok._tok(f"w{r}") for r in range(300)] == ids.tolist()


# ---------------------------------------------------------------------------
# counters: FLOPs against FlopCounterMode, pairs and bytes by enumeration
# ---------------------------------------------------------------------------

def _flops_by_op(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    counts = fc.get_flop_counts()["Global"]
    mm = sum(v for k, v in counts.items() if "mm" in str(k) and "bmm" not in str(k))
    bmm = sum(v for k, v in counts.items() if "bmm" in str(k))
    return mm, bmm


def _tiny_net():
    rc = ref.resolve({"model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64,
                                "memory_model_fixed": False}})
    w = {n: torch.randn(s) * 0.02 for n, s in ref.rag_specs(rc)}
    return rc, ref.Net(w, rc, ref.Precision("f32"))


def test_encoder_flops_match_flop_counter_on_unpadded_input():
    rc, net = _tiny_net()
    c = rc["query_enc"]
    b, t, d = 3, 128, c["d_model"]
    ids = torch.randint(4, 500, (b, t))
    mask = torch.ones(b, t, dtype=torch.long)
    mm, bmm = _flops_by_op(lambda: net.longformer("query_encoder", c, ids, mask))
    g = min(c["max_globals"], t)  # the reference gathers this many global rows
    layers = c["n_layers"]
    # the reference, as the port, projects the global q of every token
    assert mm == layers * work.encoder_gemm(b * t, b * t, c)
    assert bmm == layers * 4 * d * (b * t * t + b * g * t)
    # the counter's own count: global q on the real global rows only
    got = work.sliding_encoder(mask, work.cls_global_mask(mask), c, "float32", False,
                               kernels=False).flops
    key_bias, g_bias, valid = roofline.sliding_masks(mask, work.cls_global_mask(mask), 8)
    pairs = roofline.sliding_pairs(key_bias, g_bias, c["window"], 1, mask.bool() & ~valid)
    assert got == layers * (work.encoder_gemm(b * t, b, c) + 4 * d * (pairs + b * t))


def test_decoder_and_heads_match_flop_counter_on_unpadded_input():
    rc, net = _tiny_net()
    c = rc["led"]
    b, t, s, d = 2, 16, 128, c["d_model"]
    dec = torch.randint(4, 500, (b, t))
    enc = torch.randn(b, s, d)
    src_ok = torch.ones(b, s, dtype=torch.long)
    mm, bmm = _flops_by_op(lambda: net.led_decode(dec, enc, src_ok))
    assert mm == c["dec_layers"] * work.decoder_gemm(b * t, b * s, c)
    assert bmm == c["dec_layers"] * 4 * d * (b * t * t + b * t * s)  # causal run in full
    m = 2 * 64
    mem = {"hidden": torch.randn(b, m, d), "mask": torch.ones(b, m, dtype=torch.bool),
           "bias": torch.randn(b, m), "seq": torch.randint(4, 500, (b, m))}
    hid = torch.randn(b, t, d)
    mm, bmm = _flops_by_op(lambda: net.copy_mixture(hid, mem))
    assert mm + bmm == work.copy_head(b * t, b * t * m, b * m, rc)


def test_pairs_match_an_enumeration_of_the_masks():
    g = torch.Generator().manual_seed(3)
    b, t, w, nh = 2, 128, 32, 3
    pad = (torch.arange(t)[None] < torch.tensor([[100], [128]])).long()
    glob = (torch.rand(b, t, generator=g) < 0.05).long()
    glob[:, 0] = 1
    key_bias, g_bias, valid = roofline.sliding_masks(pad, glob, 4)
    rows = (pad > 0) & ~valid
    want = 0
    for i in range(b):
        gk = valid[i]
        for q in range(t):
            if not rows[i, q]:
                continue
            for k in range(t):
                band = abs(q - k) <= w and key_bias[i, k] == 0
                want += int(band or bool(gk[k]))
    assert roofline.sliding_pairs(key_bias, g_bias, w, nh, rows) == nh * want
    ok = pad.bool()
    causal = sum(int(ok[i, k] and k <= q) for i in range(b) for q in range(t) for k in range(t))
    assert roofline.dense_pairs(ok, t, nh, True) == nh * causal
    assert roofline.dense_pairs(ok, t, nh, False) == nh * t * int(ok.sum())


def test_bytes_of_an_unpadded_dense_launch():
    b, nh, t, s, dh = 2, 4, 64, 128, 32
    ok = torch.ones(b, s, dtype=torch.bool)
    e = 2
    # q and out, the mask, m and l, and K and V of every key, each once
    want = 2 * b * nh * t * dh * e + 4 * b * s + 8 * b * nh * t + 2 * b * nh * s * dh * e
    ops = 4 * dh * nh * b * t * s
    assert roofline.k4_bound(ok, t, nh, dh, False, "bfloat16") == max(
        want / roofline.HBM_BYTES_PER_S, ops / roofline.PEAK_BF16)


# ---------------------------------------------------------------------------
# the harness: cells found by name, the result line, no JAX
# ---------------------------------------------------------------------------

def test_a_workload_file_makes_a_cell(tmp_path):
    base = tmp_path / "base"
    shutil.copytree(CELLS, base)
    wl = json.loads((base / "workloads" / "tiny_rag_train.json").read_text())
    wl["batch_size"] = 2
    (base / "workloads" / "tiny_copy.json").write_text(json.dumps(wl))
    res, run = execute(tmp_path, "tiny_copy", base=base)
    assert run.workload["batch_size"] == 2
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert res["correct"] is True


def test_result_line_has_the_contract_keys(tmp_path):
    res, _ = execute(tmp_path, "tiny_rag_train")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_harness_loads_no_jax():
    code = ("import sys; import portbench.harness, portbench.work, portbench.trace;"
            "import portbench.entries.fit, portbench.entries.predict, portbench.entries.retriever;"
            "import portbench.reference.model, portbench.reference.judge;"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'retrieval_augmented_mds_tpu'}; print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.REPO, check=True).stdout.strip()
    assert out == "[]"


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "rag_train.mxs_b16", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=harness.REPO)
    assert p.returncode != 0 and p.stdout == ""


def test_cells_name_existing_files():
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        wl = harness.load_workload(w["name"])
        assert wl["config"] == w["config"]
        assert wl["limits"] and set(wl["limits"]) <= {
            "fit": set(TRAINING_NUMBERS),
            "retriever": set(TRAINING_NUMBERS),
            "predict": {"query_rel", "retrieval_gap", "store_rel", "enc_rel", "memory_rel",
                        "beam_replay", "logp_rel"}}[wl["entry"]]
    for m in bench["end_to_end"]:
        assert (harness.HERE / "end_to_end" / f"{m['name']}.py").exists()
    for m in bench["per_layer"]:
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").exists()


# ---------------------------------------------------------------------------
# the reference against the port, and the comparison against faults
# ---------------------------------------------------------------------------

def test_reference_follows_the_port(tmp_path):
    for cell in ("tiny_rag_train", "tiny_rag_predict", "tiny_retriever_train"):
        res, run = execute(tmp_path, cell)
        assert res["correct"], (cell, res["checks"])


@pytest.mark.parametrize("cell,fault", [
    ("tiny_rag_train", "state_unchanged"),
    ("tiny_rag_train", "half_batch"),
    ("tiny_retriever_train", "state_unchanged"),
    ("tiny_retriever_train", "half_batch"),
    ("tiny_rag_predict", "token_altered"),
    ("tiny_rag_predict", "rows_altered"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models import generate, retriever_generator
    from retrieval_augmented_mds_tpu_torch.retriever import contrastive
    from retrieval_augmented_mds_tpu_torch.train import optimizer

    if fault == "state_unchanged":
        monkeypatch.setattr(optimizer.AdamW, "update", lambda self, p, g, s: s)
    elif fault == "half_batch" and cell == "tiny_rag_train":
        real = cli.device_batch

        def half(host, cfg, device, mesh=None):
            out = real(host, cfg, device, mesh)
            return {k: v[: len(v) // 2] for k, v in out.items()}
        monkeypatch.setattr(cli, "device_batch", half)
    elif fault == "half_batch":
        real = contrastive.contrastive_loss

        def half(params, cfg, batch, **kw):
            return real(params, cfg, {k: v[: len(v) // 2] for k, v in batch.items()}, **kw)
        monkeypatch.setattr(contrastive, "contrastive_loss", half)
    elif fault == "token_altered":
        real = generate.generate

        def altered(*a, **k):
            ids = real(*a, **k).clone()
            ids[:, 1] = (ids[:, 1] + 256) % 512
            return ids
        monkeypatch.setattr(generate, "generate", altered)
    else:
        real = retriever_generator.rag_encode

        def altered(*a, **k):
            enc = real(*a, **k)
            enc.retrieved_idx = (enc.retrieved_idx + 1) % 100
            return enc
        monkeypatch.setattr(retriever_generator, "rag_encode", altered)
    res, _ = execute(tmp_path, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell,control", [("tiny_rag_train", "fp8"),
                                          ("tiny_rag_train", "half"),
                                          ("tiny_rag_predict", "fp8"),
                                          ("tiny_retriever_train", "fp8"),
                                          ("tiny_retriever_train", "half")])
def test_the_control_is_not_correct(tmp_path, cell, control):
    """The control (the reference at the precision below the
    configuration's, or on half of each batch) put in the program's place
    comes out not correct, while the program's own readings pass. (TF32,
    the retriever's control on the card, has no CPU counterpart: its runs
    are the card's, PERF.md.)"""
    res, run = execute(tmp_path, cell, control=control)
    assert res["correct"] is False, res["checks"]
    assert set(res["checks"]) <= set(run.facts["control"][control])
    limits = run.workload["limits"]
    assert all(v <= limits[n] for n, v in run.facts["readings"].items() if n in limits)


def test_jax_loaded_after_the_window_gives_no_result(tmp_path, monkeypatch, capsys):
    """A reader that loads a module named ``jax`` (a stub here) after the
    window: the run raises, and the command prints nothing and exits
    non-zero."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    base = tmp_path / "base"
    shutil.copytree(CELLS, base)
    (base / "end_to_end").mkdir()
    (base / "end_to_end" / "jax_probe.py").write_text("def read(run):\n    import jax\n")
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps({"end_to_end": [{"name": "jax_probe", "unit": "s"}],
                                 "per_layer": []}))
    monkeypatch.syspath_prepend(str(stub))
    try:
        with pytest.raises(harness.Forbidden, match="jax"):
            harness.execute("tiny_retriever_train", SEED, 0.3, False, device="cpu",
                            base=base, bench_file=bench)
    finally:
        sys.modules.pop("jax", None)

    def forbidden(*a, **k):
        raise harness.Forbidden("jax")
    monkeypatch.setattr(harness, "execute", forbidden)
    assert harness.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_replay_serves_what_the_port_search_serves():
    """The port's beam search over a decoder step that returns drawn
    log-probs (eos likely from step 4 on, so beams finish), replayed over
    what the step returned, serves the same ids, and its path holds the
    served tokens' log-probs."""
    from retrieval_augmented_mds_tpu_torch.models.generate import GenerationOptions, generate
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import RAG
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    exp = json.loads((CELLS / "configs" / "tiny_rag.json").read_text())["experiment"]
    cfg = config_from_dict(exp)
    params = RAG(cfg.model)
    b, beams, t_max, v = 3, 3, 10, cfg.model.led.vocab_size
    eos, pad = cfg.model.led.eos_id, cfg.model.led.pad_id
    g = torch.Generator().manual_seed(5)
    drawn = torch.randn(t_max, b * beams, v, generator=g) * 3
    drawn[4:, :, eos] += 6
    drawn = torch.log_softmax(drawn, -1)
    calls = []

    def step(enc_out, tok, caches, pos):
        calls.append(tok.clone())
        return drawn[len(calls) - 1], caches

    opts = GenerationOptions(max_new_tokens=t_max, num_beams=beams, min_length=3,
                             no_repeat_ngram_size=2)
    enc = type("Enc", (), {"enc_hidden": torch.zeros(b, 8, cfg.model.led.d_model)})()
    ids = generate(params, cfg.model, enc, opts, step=step)
    gen = {"min_length": 3, "no_repeat_ngram_size": 2, "num_beams": beams}
    finished = 0
    for r in range(b):
        got, path, slot = judge.replay_beam(drawn[:, r * beams:(r + 1) * beams], gen, 2, pad, eos)
        assert got == ids[r].tolist()
        served = judge.served_tokens(got, pad, eos)
        finished += served[-1] == eos
        assert len(path) == len(served) == len(slot)
        assert all(p > judge.NEG / 2 for p in path)
        rows = drawn[torch.arange(len(served)), r * beams + torch.tensor(slot)]
        assert torch.equal(rows[torch.arange(len(served)), torch.tensor(served)][2:],
                           torch.tensor(path[2:]))  # past min_length, nothing masked
    assert finished > 0


def test_judge_gaps():
    a = torch.tensor([-1.0, -2.0, -3.0])
    assert judge.widest(a, a + torch.tensor([0.0, 0.5, -0.25])) == 0.5
    rows = torch.tensor([[0.0, -2.0], [-1.0, -1.0]])
    assert judge.row_rel(rows + 5.0, rows) == pytest.approx(5.0 * 2 / 2 ** 0.5)
    logp = torch.log_softmax(torch.randn(3, 9, generator=torch.Generator().manual_seed(1)), -1)
    gen = {"no_repeat_ngram_size": 2, "min_length": 1}
    got = judge.served_logp(logp, [4, 5, 4], gen, 2, 1)
    assert torch.equal(got, logp[[0, 1, 2], [4, 5, 4]].double())
    scores = torch.tensor([5.0, 4.0, 1.0, 0.0, -1.0])
    assert judge.search_gap(scores, torch.tensor([0, 1]), 2) == 0.0
    assert judge.search_gap(scores, torch.tensor([0, 3]), 2) == pytest.approx(4.0 / 4.0)
    assert judge.banned_ngrams([2, 5, 6, 7, 5, 6], 3) == {7}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    """One short run of the retriever cell on the card: it builds, runs and
    comes out correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "retriever_train.mxs_b32", "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True, cwd=harness.REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
