"""What the entries share: the program's configuration, the traffic, the
program's weights, the measured loop, and the numbers that compare a
training run with the reference."""

from __future__ import annotations

import copy
import dataclasses
import math
import time

import numpy as np
import torch

from .. import traffic
from ..reference import model as ref
from ..weights import draw, fill_module


def experiment(run) -> dict:
    """The configuration file's ``experiment``, with the cell's batch."""
    exp = copy.deepcopy(run.cfg_file["experiment"])
    exp.setdefault("data", {})["batch_size"] = int(run.workload["batch_size"])
    exp["seed"] = int(run.seed)
    return exp


def port_config(run):
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    return config_from_dict(experiment(run))


def make_traffic(run, cfg, parts: tuple) -> dict:
    spec = dict(run.workload["traffic"])
    spec["papers"] = {"train": run.cfg_file["train_papers"],
                      "test": run.cfg_file["test_papers"]}
    d = cfg.data
    widths = {"source": d.max_length, "query": d.query_max_length,
              "target": d.decoder_max_length, "memory": d.memory_len}
    return traffic.generate(spec, run.seed, vocab_size=cfg.model.led.vocab_size,
                            doc_sep=cfg.model.led.doc_sep_id, widths=widths, parts=parts)


def program_module(make, specs, seed: int, device) -> torch.nn.Module:
    """The program's parameter tree, allocated on the device and filled from
    the seed (`weights.draw`)."""
    with torch.device(device):
        module = make()
    fill_module(module, draw(specs, seed, device))
    return module


def reference_weights(specs, seed: int, device) -> dict:
    """The same weights as separate leaves that take gradients."""
    return {n: t.clone().requires_grad_(True) for n, t in draw(specs, seed, device).items()}


def data_module(examples: dict):
    """The port's data module over examples the traffic made: `batches`
    (the native loader) is what the window drives; the tokenising
    `prepare` pass is the traffic generator's."""
    from retrieval_augmented_mds_tpu_torch.data.pipeline import RAGDataModule

    dm = RAGDataModule(df=None, tokenizer=None, query_tokenizer=None)
    dm.examples = examples
    return dm


def epochs(dm, batch_size: int, seed: int):
    """Whole batches forever, epoch e shuffled with seed + e, as `run_fit`."""
    e = 0
    while True:
        yield from dm.batches(batch_size, seed=seed + e, split=None)
        e += 1


@dataclasses.dataclass
class Loop:
    """What a measured loop did."""

    steps: int = 0
    items: int = 0
    failed: int = 0
    seconds: float = 0.0
    batches: list = dataclasses.field(default_factory=list)  # host batches, if kept


def measured(seconds: float, one, items_per_call: int, keep: bool = False) -> Loop:
    """Call ``one()`` → (host batch, ok) until ``seconds`` have passed; the
    window ends when the call running at the deadline returns, so the
    rate is taken over whole calls and all the time they took."""
    out = Loop()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        batch, ok = one()
        out.steps += 1
        out.items += items_per_call
        out.failed += 0 if ok else items_per_call
        if keep:
            out.batches.append(batch)
        if time.perf_counter() >= deadline:
            break
    out.seconds = time.perf_counter() - t0
    return out


def record_loop(run, loop: Loop, key: str = "window") -> None:
    run.facts[f"{key}_s"] = loop.seconds
    run.facts[f"{key}_items"] = loop.items
    run.facts["attempted"] = run.facts.get("attempted", 0) + loop.items
    run.facts["failed"] = run.facts.get("failed", 0) + loop.failed


def leaf_grad_norms_from_nu(params: torch.nn.Module, nu: torch.Tensor) -> dict[str, float]:
    """Each leaf's norm of the gradient as AdamW's second moment holds it
    after its first update (nu = (1 - b2) g², flat over the leaves in
    order)."""
    out, at = {}, 0
    with torch.no_grad():
        for n, p in params.named_parameters():
            k = p.numel()
            out[n] = math.sqrt(float(nu[at:at + k].double().sum()) / (1 - ref.B2))
            at += k
    if at != nu.numel():
        raise ValueError(f"the optimizer's state holds {nu.numel()} values, the "
                         f"parameters {at}: a frozen group is not handled here")
    return out


def host_params(params: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True) for n, p in params.named_parameters()}


def deltas(after: dict, specs, seed: int, device) -> dict[str, float]:
    """Each leaf's norm of (after - the seed's initial value)."""
    w0 = draw(specs, seed, device)
    return {n: float(torch.linalg.vector_norm((after[n].to(device) - w0[n]).double()))
            for n in w0}


def gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def leaf_gap(got: dict, want: dict, keep=None, median: bool = False) -> tuple[float, str]:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and the median leaf's → (gap, leaf); with
    ``median``, the median leaf's gap."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    gaps = {n: gap(got[n], want[n], med) for n in names}
    if median:
        return float(np.median(list(gaps.values()))), "median"
    worst = max(names, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(ref_grads: dict) -> set[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others (a key's bias under softmax, rows of a table no token
    reads) move under Adam by roundoff alone."""
    med = float(np.median(list(ref_grads.values())))
    return {n for n, g in ref_grads.items() if g >= 1e-3 * med}


def training_numbers(prog: dict, refr: dict) -> dict[str, tuple[float, str]]:
    """The numbers compared for a training cell: the worst step's relative
    loss gap, the worst leaf's first-gradient gap, the worst moved leaf's
    gap in its change over the check steps."""
    loss = max(gap(p, r, 0.0) for p, r in zip(prog["loss"], refr["loss"]))
    keep = moved_leaves(refr["grad"])
    return {"loss_rel": (loss, f"losses {prog['loss']} vs {refr['loss']}"),
            "grad_leaf": leaf_gap(prog["grad"], refr["grad"]),
            "update_leaf": leaf_gap(prog["delta"], refr["delta"], keep),
            "grad_median": leaf_gap(prog["grad"], refr["grad"], median=True),
            "update_median": leaf_gap(prog["delta"], refr["delta"], keep, median=True)}


def training_check(run, st, specs, reference_run, control: str | None) -> None:
    """Compare a training cell's check steps (``st.prog``: the losses, the
    first gradient's leaf norms, the parameters after the check steps) with
    the f32 reference's, ``reference_run(run, st, precision, half=...)``.
    With ``control`` (a lower precision, or ``half``: half of each batch's
    rows), the control's steps take the program's place in the comparison
    and the program's numbers are kept as readings only."""
    prog = dict(st.prog)
    prog["delta"] = deltas(prog.pop("after"), specs, run.seed, run.device)
    refr = reference_run(run, st, ref.Precision("f32"))
    judged = training_numbers(prog, refr)
    run.facts["readings"] = {n: v for n, (v, _) in judged.items()}
    run.facts["check_detail"] = {n: where for n, (_, where) in judged.items()}
    if control:
        ctl = (reference_run(run, st, ref.Precision("f32"), half=True) if control == "half"
               else reference_run(run, st, ref.Precision(control)))
        judged = training_numbers(ctl, refr)
        run.facts["control"] = {control: {n: v for n, (v, _) in judged.items()}}
    limits = run.workload["limits"]
    for name, (value, _) in judged.items():
        if name in limits:  # a number without a limit is read, not compared
            run.check(name, value, limits[name])
