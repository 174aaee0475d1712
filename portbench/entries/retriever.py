"""Entry ``retriever``: the train loop of ``cli.run_pretrain_retriever``,
time-bounded and without its full-KB validations.

Set-up builds the dual encoder (``retriever.contrastive.Retriever``), the
optimizer as the command builds it (``train.optimizer.build_optimizer``)
and one step (``train.trainer.make_retriever_train_step``), f32, from the
seed, then drives the step through its first ``check_steps`` steps and
``warmup_steps`` more. Step s draws its pairs as the command does, B of
them without replacement by ``default_rng(seed + s)``; the window goes on
with the same state, one loss read a step.

The check: the reference follows the first ``check_steps`` steps
(`common.training_numbers`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import work
from ..reference import model as ref
from . import common


@dataclasses.dataclass
class State:
    cfg: object = None
    traffic: dict = None
    program: dict = None
    batches: list = dataclasses.field(default_factory=list)
    prog: dict = dataclasses.field(default_factory=dict)
    profiled: list = dataclasses.field(default_factory=list)
    step: int = 0


def setup(run) -> State:
    from retrieval_augmented_mds_tpu_torch.retriever.contrastive import (
        Retriever,
        RetrieverConfig,
    )
    from retrieval_augmented_mds_tpu_torch.train.optimizer import build_optimizer
    from retrieval_augmented_mds_tpu_torch.train.trainer import (
        TrainState,
        make_retriever_train_step,
    )

    wl = run.workload
    cfg = common.port_config(run)
    st = State(cfg=cfg)
    st.traffic = common.make_traffic(run, cfg, ("pairs",))
    rcfg = RetrieverConfig(query_enc=cfg.model.query_enc, mips_enc=cfg.model.mips_enc,
                           temperature=cfg.retriever.temperature,
                           pooling_dim=cfg.retriever.pooling_dim,
                           token_loss=cfg.retriever.token_loss)
    rc = ref.resolve(common.experiment(run))
    params = common.program_module(lambda: Retriever(rcfg), ref.retriever_specs(rc),
                                   run.seed, run.device)
    t = cfg.train
    tx = build_optimizer(t.lr, t.warmup_steps, t.total_steps, grad_clip=t.grad_clip,
                         mu_dtype=t.adam_mu_dtype)
    state = TrainState.create(params, tx)
    st.program = dict(params=params, state=state, step_fn=make_retriever_train_step(rcfg, tx))
    for i in range(int(wl["check_steps"]) + int(wl["warmup_steps"])):
        batch, loss = _step(run, st)
        if i < int(wl["check_steps"]):
            st.batches.append(batch)
            st.prog.setdefault("loss", []).append(loss)
        if i == 0:
            st.prog["grad"] = common.leaf_grad_norms_from_nu(params, state.opt_state.nu)
        if i == int(wl["check_steps"]) - 1:
            st.prog["after"] = common.host_params(params)
    return st


def _step(run, st: State):
    p = st.program
    pairs = st.traffic["pairs"]
    with run.span("data"):
        n = len(pairs["query_input_ids"])
        sel = np.random.default_rng(run.seed + st.step).choice(
            n, size=min(st.cfg.data.batch_size, n), replace=False)
        host = {k: np.asarray(v)[sel] for k, v in pairs.items()}
        batch = {k: torch.from_numpy(v).to(run.device) for k, v in host.items()}
    with run.span("step"):
        p["state"], metrics = p["step_fn"](p["state"], batch)
        loss = float(metrics["loss"])  # waits for the device
    st.step += 1
    return host, loss


def window(run, st: State, seconds: float) -> None:
    b = st.cfg.data.batch_size

    def one():
        host, loss = _step(run, st)
        return host, math.isfinite(loss)

    if not run.trace:
        common.record_loop(run, common.measured(seconds, one, b))
        return
    from ..layer_counters import launches

    before, n0 = launches(), len(run.spans)
    with run.profiled():
        loop = common.measured(seconds, one, b, keep=True)
    run.facts["launches"] = {k: v - before[k] for k, v in launches().items()}
    run.facts["data_wait_s"] = [t1 - t0 for n, t0, t1 in run.spans[n0:] if n == "data"]
    st.profiled = loop.batches
    common.record_loop(run, loop)


def release(st: State) -> None:
    st.program = None


def _encode(net, rc, batch, rows):
    q = net.longformer("query_encoder", rc["query_enc"], batch["query_input_ids"][rows],
                       batch["query_attention_mask"][rows])[:, 0]
    m = net.longformer("mips_encoder", rc["mips_enc"], batch["mips_input_ids"][rows],
                       batch["mips_attention_mask"][rows])[:, 0]
    return q, m


def reference_run(run, st: State, prec: ref.Precision, half: bool = False) -> dict:
    """The reference's check steps. The in-batch loss needs every row's
    embedding: they are computed without gradients in blocks, the loss's
    gradient taken with respect to them, and each block run again with
    gradients and given its rows' part of it (the same gradient, in
    memory that a block bounds)."""
    exp = common.experiment(run)
    rc = ref.resolve(exp)
    specs = ref.retriever_specs(rc)
    dev = run.device
    w = common.reference_weights(specs, run.seed, dev)
    net = ref.Net(w, rc, prec)
    opt = ref.AdamW(w, exp["train"])
    temp = float(exp.get("retriever", {}).get("temperature", 1.0))
    per = int(run.workload.get("check_rows_per_block", 8))
    out = {"loss": []}
    with prec.active():
        for s, host in enumerate(st.batches):
            keep = len(host["query_input_ids"]) // (2 if half else 1)
            batch = {k: torch.as_tensor(v[:keep]).to(dev) for k, v in host.items()}
            b = len(batch["query_input_ids"])
            blocks = [slice(a, a + per) for a in range(0, b, per)]
            with torch.no_grad():
                qm = [_encode(net, rc, batch, r) for r in blocks]
            q = torch.cat([x for x, _ in qm]).requires_grad_(True)
            m = torch.cat([y for _, y in qm]).requires_grad_(True)
            loss = F.cross_entropy(net.prec.mm(q, m.T) / temp, torch.arange(b, device=dev))
            gq, gm = torch.autograd.grad(loss, (q, m))
            for r in blocks:
                qb, mb = _encode(net, rc, batch, r)
                ((qb * gq[r]).sum() + (mb * gm[r]).sum()).backward()
            out["loss"].append(loss.item())
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
    rc = ref.resolve(common.experiment(run))
    if run.trace:
        total = work.Work()
        for host in st.profiled:
            total.add(work.retriever_step(host, rc, "float32"))
        run.facts["work"] = total
    common.training_check(run, st, ref.retriever_specs(rc), reference_run, control)
