"""Entry ``fit``: the training loop of ``cli.run_fit``, time-bounded.

Set-up builds the model, the store (``cli.build_store``), the optimizer
(``cli.build_tx``) and one train step (``train.trainer.make_train_step``)
from the seed, then drives that step through its first ``check_steps``
steps and ``warmup_steps`` more, on the window's own feed: the port's
``RAGDataModule.batches`` (the native loader) and ``cli.device_batch``.
The window goes on with the same state and feed, one loss read a step as
``run_fit`` does, and no store refresh (``index.rebuild_every`` is 10000).
It does not log metrics to files, as ``run_fit`` does once a step.

The check: the reference follows the first ``check_steps`` steps from the
same weights on the same rows, with the rows the program's search
returned (`training_numbers`).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import work
from ..reference import model as ref
from . import common


@dataclasses.dataclass
class State:
    cfg: object = None
    traffic: dict = None
    program: dict = None  # the program's objects, dropped by `release`
    batches: list = dataclasses.field(default_factory=list)  # the check steps' rows
    retrieved: list = dataclasses.field(default_factory=list)  # their rows found
    prog: dict = dataclasses.field(default_factory=dict)  # the program's check readings
    profiled: list = dataclasses.field(default_factory=list)  # (batch, rows) of the trace


def setup(run) -> State:
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import RAG
    from retrieval_augmented_mds_tpu_torch.train.trainer import TrainState, make_train_step

    wl = run.workload
    cfg = common.port_config(run)
    st = State(cfg=cfg)
    st.traffic = common.make_traffic(run, cfg, ("corpus", "train"))
    rc = ref.resolve(common.experiment(run))
    params = common.program_module(lambda: RAG(cfg.model), ref.rag_specs(rc), run.seed,
                                   run.device)
    dm = common.data_module(st.traffic["train"])
    dm.store_arrays = st.traffic["corpus"]
    t0 = time.perf_counter()
    store = cli.build_store(params, cfg, dm, run.device)
    run.sync()
    run.facts["store_build_s"] = time.perf_counter() - t0
    tx = cli.build_tx(cfg, params)
    state = TrainState.create(params, tx)
    retrieved: list = []
    dtype = cli.compute_dtype(cfg)
    step_fn = make_train_step(cfg.model, tx, cfg.train, dtype=dtype, remat=cfg.train.remat,
                              retrieved=retrieved)
    feed = common.epochs(dm, cfg.data.batch_size, run.seed)
    st.program = dict(cli=cli, params=params, store=store, tx=tx, state=state,
                      step_fn=step_fn, feed=feed, retrieved=retrieved, dtype=dtype,
                      make_step=make_train_step)

    for i in range(int(wl["check_steps"]) + int(wl["warmup_steps"])):
        batch, loss = _step(run, st, step_fn)
        if i < int(wl["check_steps"]):
            st.batches.append(batch)
            st.retrieved.append(retrieved[-1].cpu())
            st.prog.setdefault("loss", []).append(loss)
        if i == 0:
            st.prog["grad"] = common.leaf_grad_norms_from_nu(params, state.opt_state.nu)
        if i == int(wl["check_steps"]) - 1:
            st.prog["after"] = common.host_params(params)
    return st


def _step(run, st: State, step_fn):
    p = st.program
    with run.span("data"):
        batch = next(p["feed"])
        dbatch = p["cli"].device_batch(batch, st.cfg, run.device)
    with run.span("step"):
        p["state"], metrics = step_fn(p["state"], p["store"], dbatch, None)
        loss = float(metrics["loss"])  # waits for the device
    return batch, loss


def window(run, st: State, seconds: float) -> None:
    p = st.program
    b = st.cfg.data.batch_size

    def one(step_fn):
        def call():
            batch, loss = _step(run, st, step_fn)
            return batch, math.isfinite(loss)
        return call

    if not run.trace:
        common.record_loop(run, common.measured(seconds, one(p["step_fn"]), b))
        return
    # traced: half the window under the profiler, as it runs untraced; half
    # with the step's own phase timer, which synchronises between phases
    from ..layer_counters import launches

    before = launches()
    first, n0 = len(p["retrieved"]), len(run.spans)
    with run.profiled():
        loop = common.measured(seconds / 2, one(p["step_fn"]), b, keep=True)
    run.facts["launches"] = {k: v - before[k] for k, v in launches().items()}
    st.profiled = list(zip(loop.batches, [r.cpu() for r in p["retrieved"][first:]]))
    common.record_loop(run, loop, "profiled")
    run.facts["data_wait_s"] = [t1 - t0 for n, t0, t1 in run.spans[n0:] if n == "data"]
    phases: list = []
    timed = p["make_step"](st.cfg.model, p["tx"], st.cfg.train, dtype=p["dtype"],
                           remat=st.cfg.train.remat, phase_times=phases)
    common.record_loop(run, common.measured(seconds / 2, one(timed), b), "phased")
    run.facts["phases"] = phases


def release(st: State) -> None:
    st.program = None


def profiled_work(run, st: State) -> work.Work:
    """The model FLOPs and kernel bounds of the profiled steps."""
    rc = ref.resolve(common.experiment(run))
    corpus = st.traffic["corpus"]
    total = work.Work()
    for batch, rows in st.profiled:
        idx = rows.clamp(min=0).numpy()
        total.add(work.rag_train_step(batch, corpus["token_ids"][idx],
                                      corpus["token_mask"][idx], rc,
                                      run.cfg_file["experiment"]["precision"]))
    return total


def reference_run(run, st: State, prec: ref.Precision, half: bool = False) -> dict:
    """The reference's check steps → {"loss", "grad", "delta"}; ``half``:
    on the first half of each batch's rows alone (a planted fault)."""
    exp = common.experiment(run)
    rc = ref.resolve(exp)
    specs = ref.rag_specs(rc)
    dev = run.device
    w = common.reference_weights(specs, run.seed, dev)
    net = ref.Net(w, rc, prec)
    opt = ref.AdamW(w, exp["train"])
    led = rc["led"]
    eps = exp["train"]["label_smoothing_eps"]
    corpus = st.traffic["corpus"]
    per_block = int(run.workload.get("check_rows_per_block", 4))
    out = {"loss": []}
    with prec.active():
        for s, (batch, rows) in enumerate(zip(st.batches, st.retrieved)):
            full = len(np.asarray(batch["labels"]))
            if len(rows) != full:
                raise ValueError(f"the search returned rows for {len(rows)} of {full} rows")
            keep = full // 2 if half else full
            t = {k: torch.as_tensor(np.asarray(v)[:keep]).to(dev) for k, v in batch.items()}
            idx = rows[:keep].clamp(min=0).long().numpy()
            mem_ids = torch.as_tensor(corpus["token_ids"][idx]).to(dev)
            mem_mask = torch.as_tensor(corpus["token_mask"][idx]).to(dev)
            dec_in = ref.shift_right(t["labels"], led["pad_id"],
                                     exp["generation"].get("decoder_start_id", 2))
            n_tok = float((t["labels"] != led["pad_id"]).sum())
            loss = 0.0
            for a in range(0, len(dec_in), per_block):
                blk = {k: v[a:a + per_block] for k, v in t.items()}
                logp, _ = net.rag_logprobs(blk, mem_ids[a:a + per_block],
                                           mem_mask[a:a + per_block], dec_in[a:a + per_block])
                lsum, _ = ref.smoothed_loss_sums(logp, blk["labels"], eps, led["pad_id"])
                (lsum / n_tok).backward()
                loss += lsum.item() / n_tok
                del logp, lsum
            out["loss"].append(loss)
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in w.items()}
            taken = opt.step(w, grads)
            for p in w.values():
                p.grad = None
            if s == 0:
                out["grad"] = ref.leaf_norms(taken)
            del grads, taken
    out["delta"] = common.deltas({n: p.detach() for n, p in w.items()}, specs, run.seed, dev)
    return out


def check(run, st: State, control: str | None) -> None:
    if run.trace:
        run.facts["work"] = profiled_work(run, st)
    rc = ref.resolve(common.experiment(run))
    common.training_check(run, st, ref.rag_specs(rc), reference_run, control)
