"""Judging a served request against the reference: plain functions of the
program's outputs and the reference's.

* `rel`: the relative gap of two states, ‖a - b‖ / ‖b‖, over real rows.
* `replay_beam`: the beam search replayed over the log-probs the
  program's decoder step returned for one request's beams at each step:
  the ids it serves and the log-prob of each served token on its path.
* `served_logp`, `widest`: the reference's log-probs of the served tokens
  (after the same no-repeat-n-gram and min-length rules), and the widest
  gap, in nats, between two such rows.
* `row_rel`: the relative gap of two blocks of whole log-prob rows.
* `search_gap`: the rows an exact inner-product search returned, against
  the exact top-k of the same query over the same rows: the worst slot's
  shortfall over the spread of the scores (the best less the median).
"""

from __future__ import annotations

import torch

NEG = -1.0e9


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def quantize_rows(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Each row rounded to integers in [-levels, levels] at the scale of its
    largest magnitude, and back (127: SQ8; 7: int4)."""
    scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-12) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def banned_ngrams(prefix: list[int], n: int) -> set[int]:
    """Tokens that would complete an n-gram already in ``prefix``."""
    if n <= 0 or len(prefix) < n - 1:
        return set()
    tail = prefix[len(prefix) - (n - 1):]
    return {prefix[i + n - 1] for i in range(len(prefix) - n + 1)
            if prefix[i:i + n - 1] == tail}


def processed(logp: torch.Tensor, served: list[int], gen: dict, start: int, eos: int
              ) -> torch.Tensor:
    """The log-probs [T, V] of teacher-forced positions after the rules the
    search applies: position t follows the prefix [start] + served[:t]."""
    out = logp.clone()
    seq = [start]
    for t in range(out.shape[0]):
        for tok in banned_ngrams(seq, int(gen.get("no_repeat_ngram_size", 0))):
            out[t, tok] = NEG
        if t + 1 < int(gen.get("min_length", 1)):
            out[t, eos] = NEG
        if t < len(served):
            seq.append(served[t])
    return out


def served_tokens(ids: list[int], pad: int, eos: int) -> list[int]:
    """The tokens a finished sequence chose: its tokens up to the first pad,
    where it chose ``eos`` (the search writes a pad in its place)."""
    out = []
    for tok in ids:
        if tok == pad:
            return out + [eos]
        out.append(tok)
    return out


def served_logp(logp: torch.Tensor, served: list[int], gen: dict, start: int, eos: int
                ) -> torch.Tensor:
    """The log-prob [len(served)] of each served token under ``logp`` [T, V]
    (teacher-forced on the served prefix), after the search's rules, f64."""
    proc = processed(logp[: len(served)], served, gen, start, eos)
    return proc[torch.arange(len(served)), torch.tensor(served, dtype=torch.long)].double()


def widest(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap between two rows of log-probs, in nats."""
    return float((a.double().cpu() - b.double().cpu()).abs().max()) if len(b) else 0.0


def row_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The relative gap of two blocks of log-prob rows [T, V]:
    ‖a - b‖ / ‖b less each row's mean‖ (the spread of the log-probs, not
    their level, sets the scale)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b - b.mean(-1, keepdim=True)).clamp(min=1e-30))


def _topk(x: torch.Tensor, k: int):
    """Top-k, ties to the lowest index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _length_penalty(cur_len: int, alpha: float) -> torch.Tensor:
    return (torch.tensor(5.0 + cur_len, dtype=torch.float32) / 6.0) ** alpha


def replay_beam(logp: torch.Tensor, gen: dict, start: int, pad: int, eos: int
                ) -> tuple[list[int], list[float], list[int]]:
    """Beam search for one request, replayed over ``logp`` [T, beams, V]: at
    step t, the log-probs that the decoder step returned for each of the
    request's beams (in the search's beam order). The bookkeeping is the
    beam search of HF and of the port (the 2·beams best continuations of
    all beams; those ending in ``eos``, length-penalised, compete for the
    finished set; the best ``beams`` others go on; ties to the lowest
    index) → (the ids it serves [T], pad after eos; the processed log-prob
    of each token on the served hypothesis's path, eos included; the beam
    whose row chose each of those tokens)."""
    if float(gen.get("repetition_penalty", 1.0)) != 1.0:
        raise NotImplementedError("a repetition penalty")
    steps, beams, v = logp.shape
    dev = logp.device
    n = int(gen.get("no_repeat_ngram_size", 0))
    min_len = int(gen.get("min_length", 1))
    alpha = float(gen.get("length_penalty", 1.0))
    early = bool(gen.get("early_stopping", False))
    seqs = [[start] for _ in range(beams)]
    paths: list[list[float]] = [[] for _ in range(beams)]
    slots: list[list[int]] = [[] for _ in range(beams)]
    scores = torch.tensor([0.0] + [NEG] * (beams - 1), dtype=torch.float32, device=dev)
    fin_seqs = [[start] for _ in range(beams)]
    fin_paths: list[list[float]] = [[] for _ in range(beams)]
    fin_slots: list[list[int]] = [[] for _ in range(beams)]
    fin_scores = torch.full((beams,), NEG, dtype=torch.float32, device=dev)
    for t in range(steps):
        proc = logp[t].float().clone()
        for j in range(beams):
            for tok in banned_ngrams(seqs[j], n):
                proc[j, tok] = NEG
        if t + 1 < min_len:
            proc[:, eos] = NEG
        total = (scores[:, None] + proc).reshape(-1)
        top_scores, top_idx = _topk(total, 2 * beams)
        chosen = proc.reshape(-1)[top_idx].tolist()
        src = (top_idx // v).tolist()
        tok = (top_idx % v).tolist()
        is_eos = torch.tensor([x == eos for x in tok], device=dev)
        lp = _length_penalty(t + 1, alpha).to(dev)
        cand_fin = torch.where(is_eos, top_scores / lp, torch.full_like(top_scores, NEG))
        cand_seqs = [seqs[src[i]] + [pad if tok[i] == eos else tok[i]]
                     for i in range(2 * beams)]
        cand_paths = [paths[src[i]] + [chosen[i]] for i in range(2 * beams)]
        cand_slots = [slots[src[i]] + [src[i]] for i in range(2 * beams)]
        fin_top, fin_pos = _topk(torch.cat([fin_scores, cand_fin]), beams)
        if not (early and bool((fin_scores > NEG / 2).all())):
            pool = list(zip(fin_seqs + cand_seqs, fin_paths + cand_paths,
                            fin_slots + cand_slots))
            fin_seqs, fin_paths, fin_slots = (list(x) for x in zip(
                *[pool[i] for i in fin_pos.tolist()]))
            fin_scores = fin_top
        alive = torch.where(is_eos, torch.full_like(top_scores, NEG), top_scores)
        scores, alive_pos = _topk(alive, beams)
        alive_pos = alive_pos.tolist()
        seqs = [seqs[src[i]] + [tok[i]] for i in alive_pos]
        paths = [paths[src[i]] + [chosen[i]] for i in alive_pos]
        slots = [slots[src[i]] + [src[i]] for i in alive_pos]
    lp = _length_penalty(steps, alpha).to(dev)
    use_fin = bool(fin_scores[0] > scores[0] / lp)
    if early:
        use_fin = use_fin or bool((fin_scores > NEG / 2).all())
    best, path, slot = ((fin_seqs[0], fin_paths[0], fin_slots[0]) if use_fin
                        else (seqs[0], paths[0], slots[0]))
    best = best[1:]
    return best + [pad] * (steps - len(best)), path, slot


def search_gap(scores: torch.Tensor, got: torch.Tensor, k: int) -> float:
    """``scores`` [N] of one query over every row (excluded rows at NEG);
    ``got`` the k rows returned. The worst slot j's shortfall, (the j-th
    best score - the score of the j-th row returned), over (best - median)."""
    top = torch.topk(scores, k).values
    spread = float(top[0] - scores[scores > NEG / 2].median())
    short = (top - scores[got.long().clamp(min=0)]).clamp(min=0)
    short = torch.where(got >= 0, short, top - NEG)
    return float(short.max()) / max(spread, 1e-30)
