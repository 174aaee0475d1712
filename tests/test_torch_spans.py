"""The port's program spans (`obs.profiling.span`) on the CPU: nothing is
recorded outside a profiler; under one, the span tree (parents, roots,
ordered times), the same names as ``user_annotation`` ranges of an exported
trace, the sync counter, and a fresh buffer for each profiled stretch. Then
the spans the program opens: a train step, a retriever step, a beam and a
greedy `generate` and the store build; `phase_times` on the same phase
boundaries; ``predict --profile``; and ``fit``'s logged ``tokens_per_s``."""

from __future__ import annotations

import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch
import yaml

from retrieval_augmented_mds_tpu_torch import cli
from retrieval_augmented_mds_tpu_torch.models.generate import GenerationOptions, generate
from retrieval_augmented_mds_tpu_torch.models.retriever_generator import rag_encode
from retrieval_augmented_mds_tpu_torch.obs import profiling
from retrieval_augmented_mds_tpu_torch.obs.profiling import recorded, span
from retrieval_augmented_mds_tpu_torch.train.trainer import (
    TrainState,
    make_retriever_train_step,
    make_train_step,
)
from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)
CPU = torch.device("cpu")


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def tree(spans) -> list[tuple[str, str | None]]:
    """(name, parent's name) of each span, in the order they opened."""
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in spans]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_nothing_is_recorded_outside_a_profiler():
    with profiled():
        with span("before"):
            pass
    assert [s.name for s in recorded()] == ["before"]
    with span("a") as got:
        with span("b"):
            pass
    assert got is None
    assert [s.name for s in recorded()] == ["before"]
    with profiled():
        pass
    with profiled():
        with span("c"):
            pass
    assert [s.name for s in recorded()] == ["c"]


def test_recorded_spans_nest_with_parent_root_and_times():
    t0 = time.time_ns()
    with profiled():
        with span("root") as root:
            with span("child"):
                with span("leaf"):
                    torch.ones(4).sum()
            with span("sibling"):
                pass
        with span("second"):
            pass
    t1 = time.time_ns()
    spans = recorded()
    assert tree(spans) == [("root", None), ("child", "root"), ("leaf", "child"),
                           ("sibling", "root"), ("second", None)]
    by = {s.name: s for s in spans}
    assert by["root"] is root
    assert {by[n].root for n in ("root", "child", "leaf", "sibling")} == {root.id}
    assert by["second"].root == by["second"].id != root.id
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        assert s.host_ms >= 0 and s.stream_ms() is None and s.syncs == 0
    assert by["root"].start_ns <= by["child"].start_ns <= by["leaf"].start_ns
    assert by["leaf"].end_ns <= by["child"].end_ns <= by["sibling"].start_ns
    assert by["sibling"].end_ns <= by["root"].end_ns <= by["second"].start_ns


def test_spans_are_user_annotations_of_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("train.step"):
            with span("train.forward"):
                torch.ones(8).cumsum(0)
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.forward"} <= set(ranges)
    outer, inner = ranges["train.step"], ranges["train.forward"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert [s.name for s in recorded()] == ["train.step", "train.forward"]


def test_syncs_count_every_warning_against_the_open_spans():
    """torch's sync warning, raised by hand from one line three times, once
    more from a child, and once from another thread (autograd's CUDA
    backward runs on one of its own), counts each time against the
    innermost span and its ancestors; other warnings pass through; the
    filters come back."""
    before = list(warnings.filters)
    message = profiling.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions.cpp)"
    with pytest.warns(RuntimeWarning, match="not a sync"):
        with profiled():
            with span("outer"):
                for _ in range(3):
                    warnings.warn(message)
                with span("inner"):
                    warnings.warn(message)
                    warnings.warn("not a sync", RuntimeWarning)
                    other = threading.Thread(target=warnings.warn, args=(message,))
                    other.start()
                    other.join(timeout=10)
                    assert not other.is_alive()
                with span("quiet"):
                    pass
            with span("after"):
                pass
    assert {s.name: s.syncs for s in recorded()} == {"outer": 5, "inner": 2, "quiet": 0,
                                                     "after": 0}
    assert warnings.filters == before
    with pytest.warns(UserWarning, match="synchronizing"):  # unrecorded: shown as before
        warnings.warn(message)


def test_the_buffer_is_cleared_between_two_profiles(tmp_path):
    with profiled():
        with span("first"):
            pass
    assert [s.name for s in recorded()] == ["first"]
    with profiled():
        with span("second"):
            pass
        with span("third"):
            pass
    assert [s.name for s in recorded()] == ["second", "third"]
    with profiling.trace(str(tmp_path)):
        with span("fourth"):
            pass
    assert [s.name for s in recorded()] == ["fourth"]


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def _tiny(tmp_path, **over) -> dict:
    d = {
        "model": {"preset": "tiny", "mips_topk": 2, "memory_len": 64},
        "data": {"source": "synthetic", "n_synthetic": 40, "max_length": 128,
                 "query_max_length": 64, "decoder_max_length": 16,
                 "memory_len": 64, "batch_size": 2},
        "index": {"factory": "Flat", "rebuild_every": 0},
        "train": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10},
        "generation": {"max_new_tokens": 4, "num_beams": 2},
        "max_steps": 1, "eval_every": 0,
        "logging": {"log_dir": str(tmp_path / "runs"), "run_name": "t"},
    }
    d.update(over)
    return d


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    cfg = config_from_dict(_tiny(tmp_path_factory.mktemp("spans")))
    dm, _ = cli.build_data(cfg)
    params = cli.build_params(cfg, CPU)
    with profiled():
        store = cli.build_store(params, cfg, dm, CPU)
    built = recorded()
    host = next(dm.batches(cfg.data.batch_size, seed=0, split="train"))
    return dict(cfg=cfg, params=params, store=store, built=built,
                batch=cli.device_batch(host, cfg, CPU))


def test_the_store_build_records_embed_then_index(program):
    assert tree(program["built"]) == [("store.build", None), ("store.embed", "store.build"),
                                      ("store.index", "store.build")]


def test_a_train_step_records_its_phases(program):
    cfg, params = program["cfg"], program["params"]
    tx = cli.build_tx(cfg, params)
    step = make_train_step(cfg.model, tx, cfg.train)
    state = TrainState.create(params, tx)
    with profiled():
        step(state, program["store"], program["batch"])
    got = [(n, p) for n, p in tree(recorded()) if n.startswith("train.")]
    assert got == [("train.step", None), ("train.forward", "train.step"),
                   ("train.backward", "train.step"), ("train.optimizer", "train.step")]
    # the forward's `rag_encode` is its own span inside it
    assert ("encode", "train.forward") in tree(recorded())


def test_phase_times_keep_their_keys_on_the_same_boundaries(program):
    """`phase_times` appends one dict of wall seconds a step under the same
    keys; under a profiler the phases are the spans of the same names."""
    cfg, params = program["cfg"], program["params"]
    tx = cli.build_tx(cfg, params)
    phases: list = []
    step = make_train_step(cfg.model, tx, cfg.train, phase_times=phases)
    state = TrainState.create(params, tx)
    step(state, program["store"], program["batch"])
    with profiled():
        step(state, program["store"], program["batch"])
    assert len(phases) == 2
    for times in phases:
        assert list(times) == ["forward", "backward", "optimizer"]
        assert all(v > 0 for v in times.values())
    spans = {s.name: s for s in recorded()}
    for phase, seconds in phases[1].items():
        assert spans[f"train.{phase}"].host_ms >= 1000 * seconds * 0.999


def test_a_retriever_step_records_its_phases():
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import RAGConfig
    from retrieval_augmented_mds_tpu_torch.retriever.contrastive import (
        Retriever,
        RetrieverConfig,
    )
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer

    tiny = RAGConfig.tiny()
    rcfg = RetrieverConfig(query_enc=tiny.query_enc, mips_enc=tiny.mips_enc)
    torch.manual_seed(0)
    params = Retriever(rcfg)
    tx = build_optimizer(1e-3, 1, 10)
    rng = np.random.default_rng(0)
    shape = (4, tiny.query_enc.window)
    batch = {f"{side}_{key}": (torch.as_tensor(rng.integers(3, 100, shape), dtype=torch.int32)
                               if key == "input_ids" else torch.ones(shape, dtype=torch.int32))
             for side in ("query", "mips") for key in ("input_ids", "attention_mask")}
    step = make_retriever_train_step(rcfg, tx)
    with profiled():
        step(TrainState.create(params, tx), batch)
    assert tree(recorded()) == [("train.step", None), ("train.forward", "train.step"),
                                ("train.backward", "train.step"),
                                ("train.optimizer", "train.step")]


@pytest.mark.parametrize("beams", [2, 1])
def test_generate_records_a_step_per_position(program, beams):
    cfg = program["cfg"]
    opts = GenerationOptions(max_new_tokens=4, num_beams=beams, min_length=2,
                             no_repeat_ngram_size=2)
    with torch.no_grad():
        enc = rag_encode(program["params"], cfg.model, program["store"], program["batch"])
    with profiled():
        ids = generate(program["params"], cfg.model, enc, opts)
    assert ids.shape == (2, 4)
    step = [("generate.step", "generate"), ("generate.decode", "generate.step"),
            ("generate.search", "generate.step")]
    assert tree(recorded()) == [("generate", None)] + step * 4
    root = recorded()[0]
    assert all(s.root == root.id for s in recorded())


def test_predict_profile_writes_the_generate_steps(tmp_path):
    """``predict --profile`` (every command takes it): a Chrome trace under
    ``<log_dir>/trace`` whose ``generate.step`` ranges are one a position."""
    path = tmp_path / "p.yaml"
    path.write_text(yaml.safe_dump(_tiny(tmp_path)))
    assert cli.main(["predict", "--config", str(path), "--device", "cpu", "--profile"]) == 0
    (name,) = os.listdir(tmp_path / "runs" / "trace")
    events = json.load(open(tmp_path / "runs" / "trace" / name))["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("generate.step") == 4
    assert {"generate", "generate.decode", "generate.search", "encode", "store.build",
            "store.embed", "store.index"} <= set(ranges)


def test_fit_logs_real_source_tokens_over_the_whole_wait(tmp_path, monkeypatch):
    """``tokens_per_s`` counts a padded batch's real source tokens, over the
    time since the previous step ended: the wait for the batch (here a
    device copy slowed by 0.2 s) is in it, not in ``steps_per_s``."""
    cfg = config_from_dict(_tiny(tmp_path, max_steps=2))
    hosts = []
    real = cli.device_batch

    def slow(host, cfg, device, mesh=None):
        hosts.append(host)
        time.sleep(0.2)
        return real(host, cfg, device, mesh)

    monkeypatch.setattr(cli, "device_batch", slow)
    cli.run_fit(cfg, device="cpu")
    with open(tmp_path / "runs" / "t.metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    logged = [m for m in logged if "tokens_per_s" in m]
    assert len(logged) == len(hosts) == 2
    for m, host in zip(logged, hosts):
        mask = np.asarray(host["attention_mask"])
        assert mask.sum() < mask.size  # padded
        seconds = mask.sum() / m["tokens_per_s"]  # the interval it was taken over
        assert seconds >= 0.2 + 1 / m["steps_per_s"]
        assert seconds < 0.2 + 1 / m["steps_per_s"] + 5.0
