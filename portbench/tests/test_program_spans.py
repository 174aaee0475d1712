"""CPU tests of the per-layer metrics that read the program's own spans
(`portbench.program_spans`): the tiny cells run with ``--trace 1`` report
the dispatch and sync readings, and no stream time (a CPU span has no CUDA
events); a program without the recorder gives no reading and no error.

    python -m pytest portbench/tests -q"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import harness

CELLS = Path(__file__).resolve().parent / "cells"
SEED = 2**31 + 17
TRAIN = ["step_dispatch_ms.train", "step_syncs.train"]
PREDICT = ["beam_dispatch_ms.predict", "beam_syncs.predict", "decoder_stream_ms.predict"]


def span_bench(path: Path) -> Path:
    """A BENCHMARK.json of the tiny cells with the span metrics."""
    train, predict = ["tiny_rag_train", "tiny_retriever_train"], ["tiny_rag_predict"]
    bench = {
        "end_to_end": [
            {"name": "train_examples_per_s", "unit": "examples/s", "workloads": train},
            {"name": "summaries_per_s", "unit": "summaries/s", "workloads": predict},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            *({"name": n, "unit": "ms" if "_ms" in n else "count",
               "moves": "train_examples_per_s", "workloads": train} for n in TRAIN),
            *({"name": n, "unit": "ms" if "_ms" in n else "count",
               "moves": "summaries_per_s", "workloads": predict} for n in PREDICT)]}
    path.write_text(json.dumps(bench))
    return path


def traced(tmp_path, cell):
    return harness.execute(cell, SEED, 0.3, True, device="cpu", base=CELLS,
                           bench_file=span_bench(tmp_path / "BENCHMARK.json"))


@pytest.mark.parametrize("cell", ["tiny_rag_train", "tiny_retriever_train"])
def test_training_cells_read_the_step_span(tmp_path, cell):
    res, run = traced(tmp_path, cell)
    got = res["metrics"]
    assert set(got) == set(TRAIN)
    steps = run.facts["profiled_items" if cell == "tiny_rag_train" else "window_items"]
    assert steps > 0
    # the host's step, the loss read left out, within the benchmark's own span
    step_ms = sorted(1000 * (b - a) for n, a, b in run.spans if n == "step")
    assert 0 < got["step_dispatch_ms.train"]["value"] <= step_ms[-1]
    assert got["step_syncs.train"] == {"value": 0.0, "unit": "count"}  # no CUDA here


def test_the_predict_cell_reads_the_beam_step_spans(tmp_path):
    res, run = traced(tmp_path, "tiny_rag_predict")
    got = res["metrics"]
    # a CPU span has no CUDA events: no stream time, and the metric is left out
    assert set(got) == {"beam_dispatch_ms.predict", "beam_syncs.predict"}
    per_step = 1000 * sum(run.facts["generate_s"]) / run.facts["decode_steps"]
    assert 0 < got["beam_dispatch_ms.predict"]["value"] <= per_step * 3
    assert got["beam_syncs.predict"]["value"] == 0.0


def test_a_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    """A program that has no ``recorded`` (one from before the recorder):
    every span metric is left out of the line, and nothing raises."""
    from retrieval_augmented_mds_tpu_torch.obs import profiling

    monkeypatch.delattr(profiling, "recorded")
    for cell in ("tiny_rag_predict", "tiny_retriever_train"):
        res, _ = traced(tmp_path, cell)
        assert res["metrics"] == {}
