"""Entry ``predict``: offline summarisation of whole test batches, as
``cli.run_predict`` does for one: ``rag_encode`` (query encode, the search
of the store ``cli.build_store`` built, the memory re-encode, the LED
encoder) then ``generate`` (beam search over the cached decoder), under
``torch.no_grad()``, time-bounded. Set-up warms every shape of the window
on one batch: its encode and the first steps of its beam search (every
later step has the same shapes), stopped there.

``generate`` is given the decoder step it would build itself
(``decode_step``), which also copies the log-probs it returns for the beams
of ``check_rows`` requests of each batch, drawn from the seed before the
batch, into a buffer on the card: one gather a step. A batch counts when
its ids are on the host. The window keeps those requests' states; the check
takes ``check_rows`` of them, the longest summary among them, and holds
against the reference: the query embedding, the rows the search returned
(against an exact search of the program's own query over the store's rows),
a sample of the store's rows, the LED encoder's and the memory encoder's
states, and the decoder: the beam search replayed over the log-probs the
program's step returned must serve the program's ids (`judge.replay_beam`),
and the log-prob rows on the served path must match the reference's,
teacher-forced on the same tokens (`judge.row_rel`; the widest gap of a
served token's log-prob is read, not compared).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import work
from ..reference import judge
from ..reference import model as ref
from . import common

STORE_SAMPLE = 16  # corpus rows re-encoded to check the store's embeddings


@dataclasses.dataclass
class State:
    cfg: object = None
    traffic: dict = None
    program: dict = None
    rng: np.random.Generator = None
    kept: list = dataclasses.field(default_factory=list)  # per request kept on the card
    longest: int = 0  # the longest summary the window served
    payload: dict = None  # the store's rows as the search reads them (host)
    profiled: list = dataclasses.field(default_factory=list)  # (batch, rows)


class _Enough(Exception):
    """Stops the warm-up's beam search."""


def setup(run) -> State:
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.index.ivf import ivf_route
    from retrieval_augmented_mds_tpu_torch.models.generate import (
        copy_head_kv,
        decode_step,
        generate,
    )
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import RAG, rag_encode

    cfg = common.port_config(run)
    st = State(cfg=cfg, rng=np.random.default_rng([run.seed, 1]))
    st.traffic = common.make_traffic(run, cfg, ("corpus", "test"))
    rc = ref.resolve(common.experiment(run))
    params = common.program_module(lambda: RAG(cfg.model), ref.rag_specs(rc), run.seed,
                                   run.device)
    dm = common.data_module(st.traffic["test"])
    dm.store_arrays = st.traffic["corpus"]
    t0 = time.perf_counter()
    store = cli.build_store(params, cfg, dm, run.device)
    run.sync()
    run.facts["store_build_s"] = time.perf_counter() - t0
    b = cfg.data.batch_size
    route = ivf_route(store.index, b, cfg.model.mips_topk, store.nprobe,
                      st.traffic["test"]["mips_ignore"].shape[1])
    if route != "flat":
        raise ValueError(f"the check emulates the flat route; a batch of {b} takes {route!r}")
    flat = store.index.flat
    st.payload = {"codes": flat.embeddings[:flat.n].cpu(), "scale": flat.row_scale[:flat.n].cpu()}
    st.program = dict(cli=cli, params=params, store=store, rag_encode=rag_encode,
                      generate=generate, decode_step=decode_step, copy_head_kv=copy_head_kv,
                      dtype=cli.compute_dtype(cfg), feed=common.epochs(dm, b, run.seed))
    # every shape of the window once: the steps up to min_length and past it
    try:
        _batch(run, st, keep=False, stop_after=cfg.generation.min_length + 2)
    except _Enough:
        pass
    return st


def _recording(step, rows: torch.Tensor, beams: int, steps: int,
               stop_after: int | None = None):
    """``step`` (the program's cached decoder step), which also copies the
    log-probs [B·beams, V] it returns for the beams of ``rows`` into
    ``buf[0][t]`` ([steps, len(rows)·beams, V]) at its t-th call → (the
    step, buf); with ``stop_after``, it raises `_Enough` after that many
    calls."""
    idx = (rows[:, None] * beams + torch.arange(beams, device=rows.device)).reshape(-1)
    buf: list = []
    t = 0

    def wrapped(enc_out, tok, caches, pos):
        nonlocal t
        if t == stop_after:
            raise _Enough
        logp, caches = step(enc_out, tok, caches, pos)
        if not buf:
            buf.append(logp.new_empty((steps, len(idx), logp.shape[-1])))
        torch.index_select(logp, 0, idx, out=buf[0][t])
        t += 1
        return logp, caches

    return wrapped, buf


def _batch(run, st: State, keep: bool = True, sync_between: bool = False,
           stop_after: int | None = None):
    p, cfg = st.program, st.cfg
    gen = cfg.generation
    with run.span("data"):
        host = next(p["feed"])
        batch = p["cli"].device_batch(host, cfg, run.device)
    b = cfg.data.batch_size
    picked = np.sort(st.rng.choice(b, int(run.workload["check_rows"]), replace=False))
    t0 = time.perf_counter()
    with torch.no_grad():
        with run.span("encode"):
            enc = p["rag_encode"](p["params"], cfg.model, p["store"], batch, dtype=p["dtype"])
            if sync_between:
                run.sync()
        t1 = time.perf_counter()
        with run.span("generate"):
            step, buf = _recording(
                p["decode_step"](p["params"], cfg.model, p["dtype"],
                                 p["copy_head_kv"](p["params"], cfg.model, enc, p["dtype"])),
                torch.as_tensor(picked, device=run.device), gen.num_beams,
                gen.max_new_tokens, stop_after)
            ids = p["generate"](p["params"], cfg.model, enc, gen, dtype=p["dtype"],
                                step=step).cpu()  # the batch is done
    t2 = time.perf_counter()
    if keep:
        run.facts.setdefault("batch_s", []).append(t2 - t0)
    if sync_between:
        run.facts.setdefault("encode_s", []).append(t1 - t0)
        run.facts.setdefault("generate_s", []).append(t2 - t1)
    rows = enc.retrieved_idx.cpu()
    if keep:
        _keep(st, host, enc, ids, rows, picked, buf[0], gen.num_beams)
    return host, rows, ids


def _keep(st: State, host, enc, ids, rows, picked, logp, beams: int) -> None:
    """The recorded requests: their inputs, ids, rows found, states, and the
    log-probs their beams' decoder steps returned, kept on the card."""
    pad = st.cfg.model.led.pad_id
    lengths = (ids != pad).sum(1)
    st.longest = max(st.longest, int(lengths.max()))
    for j, r in enumerate(picked.tolist()):
        st.kept.append({
            "host": {k: np.asarray(v)[r] for k, v in host.items()},
            "ids": ids[r].tolist(), "length": int(lengths[r]), "rows": rows[r],
            "query": enc.query_cls[r].detach().clone(),
            "enc": enc.enc_hidden[r].detach().clone(),
            "memory": enc.memory[r].detach().clone(),
            "logp": logp[:, j * beams:(j + 1) * beams],
        })


def window(run, st: State, seconds: float) -> None:
    b = st.cfg.data.batch_size
    if not run.trace:
        def one():
            _batch(run, st)
            return None, True

        common.record_loop(run, common.measured(seconds, one, b))
        return
    from ..layer_counters import launches

    before = launches()
    done: list = []

    def one():
        host, rows, _ = _batch(run, st, sync_between=True)
        done.append((host, rows))
        return None, True

    with run.profiled():
        loop = common.measured(seconds, one, b)
    run.facts["launches"] = {k: v - before[k] for k, v in launches().items()}
    run.facts["decode_steps"] = loop.steps * st.cfg.generation.max_new_tokens
    st.profiled = done
    common.record_loop(run, loop)


def release(st: State) -> None:
    st.program = None


def _sample(run, st: State) -> list[dict]:
    n = int(run.workload["check_rows"])
    longest = max(range(len(st.kept)), key=lambda i: st.kept[i]["length"])
    rng = np.random.default_rng([run.seed, 2])
    rest = [i for i in range(len(st.kept)) if i != longest]
    pick = [longest] + rng.choice(rest, min(n - 1, len(rest)), replace=False).tolist()
    return [st.kept[i] for i in pick]


def _scores(payload: dict, q: torch.Tensor, ignore, levels: int | None = None):
    """The exact inner products of ``q`` with every row of the store's payload
    (``levels``: with the rows first re-quantised to that many levels a side,
    7 for int4), excluded rows at NEG."""
    rows = payload["codes"].to(q.device).float() * payload["scale"].to(q.device)[:, None]
    if levels is not None:
        rows = judge.quantize_rows(rows, levels)
    s = rows @ torch.nn.functional.pad(q.float(), (0, rows.shape[1] - q.shape[0]))
    ignore = torch.as_tensor(ignore).long()
    return s.index_fill(0, ignore[ignore >= 0].to(q.device), judge.NEG)


def reference_numbers(run, st: State, sample, prec: ref.Precision) -> dict:
    """The program against the f32 reference → {"program": {name: value},
    "control": the same numbers of the control, or None}. The control (at
    ``prec`` below f32) is the reference at that precision on the same
    requests and served tokens, and, for the store and the search, the same
    rows in int4."""
    exp = common.experiment(run)
    rc = ref.resolve(exp)
    gen = exp["generation"]
    start = gen.get("decoder_start_id", 2)
    dev = run.device
    led = rc["led"]
    k = rc["mips_topk"]
    w = {n: t for n, t in common.reference_weights(ref.rag_specs(rc), run.seed, dev).items()}
    for t in w.values():
        t.requires_grad_(False)
    f32 = ref.Net(w, rc, ref.Precision("f32"))
    low = ref.Net(w, rc, prec) if prec.name != "f32" else None
    corpus = st.traffic["corpus"]
    nums = {n: 0.0 for n in ("query_rel", "retrieval_gap", "store_rel", "enc_rel",
                             "memory_rel", "beam_replay", "logp_rel", "logp_gap")}
    ctl = {n: 0.0 for n in nums if n != "beam_replay"}
    with torch.no_grad():
        # the store: a sample of its rows, re-encoded
        pick = np.random.default_rng([run.seed, 3]).choice(len(corpus["token_ids"]),
                                                           STORE_SAMPLE, replace=False)
        pick = np.unique(np.concatenate([pick] + [s["rows"].clamp(min=0).numpy()
                                                  for s in sample]))
        ids = torch.as_tensor(corpus["token_ids"][pick]).to(dev)
        mask = torch.as_tensor(corpus["token_mask"][pick]).to(dev)
        with f32.prec.active():
            emb = f32.longformer("mips_encoder", rc["mips_enc"], ids, mask)[:, 0]
        stored = (st.payload["codes"][pick].float()
                  * st.payload["scale"][pick][:, None])[:, :emb.shape[1]].to(dev)
        nums["store_rel"] = max(judge.rel(stored[i], emb[i]) for i in range(len(pick)))
        if low is not None:
            # the control of a store of int8 rows: the same rows in int4
            q4 = judge.quantize_rows(emb, 7)
            ctl["store_rel"] = max(judge.rel(q4[i], emb[i]) for i in range(len(pick)))
        for s in sample:
            h = {key: torch.as_tensor(v)[None].to(dev) for key, v in s["host"].items()}
            rows = s["rows"].clamp(min=0).numpy()
            mem_ids = torch.as_tensor(corpus["token_ids"][rows])[None].to(dev)
            mem_mask = torch.as_tensor(corpus["token_mask"][rows])[None].to(dev)
            replayed, path, slot = judge.replay_beam(s["logp"], gen, start, led["pad_id"],
                                                     led["eos_id"])
            nums["beam_replay"] += sum(a != b for a, b in zip(replayed, s["ids"]))
            chosen = judge.served_tokens(s["ids"], led["pad_id"], led["eos_id"])
            dec = torch.tensor([[start] + chosen[:-1]], device=dev)
            outs = {}
            for tag, net in (("f32", f32), ("low", low)):
                if net is None:
                    continue
                with net.prec.active():
                    logp, mid = net.rag_logprobs(h, mem_ids, mem_mask, dec)
                outs[tag] = (logp[0], mid)
            ref_rows, mid = outs["f32"]
            want = judge.served_logp(ref_rows, chosen, gen, start, led["eos_id"])
            real = h["attention_mask"][0] > 0
            m_real = mem_mask.reshape(-1) > 0
            nums["query_rel"] = max(nums["query_rel"], judge.rel(s["query"], mid["query"][0]))
            nums["enc_rel"] = max(nums["enc_rel"], judge.rel(s["enc"][real].float(),
                                                             mid["enc"][0][real]))
            nums["memory_rel"] = max(nums["memory_rel"], judge.rel(
                s["memory"][m_real].float(), mid["memory"]["hidden"][0][m_real]))
            n = min(len(path), len(chosen))
            rows_served = s["logp"][torch.arange(n), torch.tensor(slot[:n])]
            nums["logp_rel"] = max(nums["logp_rel"], judge.row_rel(rows_served,
                                                                   ref_rows[:n]))
            nums["logp_gap"] = max(nums["logp_gap"], judge.widest(
                torch.tensor(path[:n]), want[:n]))
            ign = s["host"]["mips_ignore"]
            nums["retrieval_gap"] = max(nums["retrieval_gap"], judge.search_gap(
                _scores(st.payload, s["query"].to(dev), ign), s["rows"].to(dev), k))
            if low is not None:
                low_rows, lmid = outs["low"]
                ctl["query_rel"] = max(ctl["query_rel"], judge.rel(lmid["query"][0],
                                                                   mid["query"][0]))
                ctl["enc_rel"] = max(ctl["enc_rel"], judge.rel(lmid["enc"][0][real],
                                                               mid["enc"][0][real]))
                ctl["memory_rel"] = max(ctl["memory_rel"], judge.rel(
                    lmid["memory"]["hidden"][0][m_real], mid["memory"]["hidden"][0][m_real]))
                ctl["logp_rel"] = max(ctl["logp_rel"], judge.row_rel(low_rows, ref_rows))
                ctl["logp_gap"] = max(ctl["logp_gap"], judge.widest(judge.served_logp(
                    low_rows, chosen, gen, start, led["eos_id"]), want))
                # the control of a search over int8 rows: the same search over int4 rows
                exact = _scores(st.payload, s["query"].to(dev), ign)
                got = torch.topk(_scores(st.payload, s["query"].to(dev), ign, 7), k).indices
                ctl["retrieval_gap"] = max(ctl["retrieval_gap"], judge.search_gap(exact, got, k))
    return {"program": nums, "control": ctl if low is not None else None}


def check(run, st: State, control: str | None) -> None:
    if run.trace:
        rc = ref.resolve(common.experiment(run))
        gen = common.experiment(run)["generation"]
        total = work.Work()
        corpus = st.traffic["corpus"]
        for host, rows in st.profiled:
            idx = rows.clamp(min=0).numpy()
            total.add(work.rag_predict_batch(host, corpus["token_ids"][idx],
                                             corpus["token_mask"][idx], rc, gen,
                                             run.cfg_file["experiment"]["precision"]))
        run.facts["work"] = total
    if control == "half":
        raise ValueError("the predict cell's control is a lower precision (fp8)")
    sample = _sample(run, st)
    st.kept = None
    run.facts["served_lengths"] = {"longest": st.longest,
                                   "sample": [s["length"] for s in sample]}
    got = reference_numbers(run, st, sample, ref.Precision(control or "f32"))
    run.facts["readings"] = got["program"]
    judged = got["program"]
    if got["control"] is not None:  # the control takes the program's place
        run.facts["control"] = {control: got["control"]}
        judged = got["control"]
    limits = run.workload["limits"]
    for name, value in judged.items():
        if name in limits:
            run.check(name, value, limits[name])
