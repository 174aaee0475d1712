"""Autoregressive generation (greedy and beam) over the KV cache.

Counterpart of ``retrieval_augmented_mds_tpu/models/generate.py``. The
decode loop is a Python loop; caches are updated in place and reordered
by one gather per beam step; beams are a folded batch axis that attends
un-expanded encoder and memory K/V. Supports eos stopping, min length,
length penalty, ``early_stopping``, repetition penalty and no-repeat
n-gram banning. Ties in every top-k go to the lowest index, as with
``jax.lax.top_k`` (a stable descending sort, not ``torch.topk``).

Not ported yet: sampling (``do_sample``) and ``copy_trace``.
"""

from __future__ import annotations

import dataclasses

import torch

from .copy_decoder import precompute_copy_kv
from .led import init_decode_caches
from .retriever_generator import RAGConfig, RAGEncoderOutput, rag_decode

NEG = -1.0e9


@dataclasses.dataclass(frozen=True)
class GenerationOptions:
    """The generation knobs of the YAML schema (same fields as the JAX
    package's GenerationOptions)."""

    max_new_tokens: int = 64
    num_beams: int = 1
    min_length: int = 1
    no_repeat_ngram_size: int = 0
    length_penalty: float = 1.0
    decoder_start_id: int = 2
    output_copy_probs: bool = False
    early_stopping: bool = False
    repetition_penalty: float = 1.0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ban_repeated_ngrams(seqs: torch.Tensor, cur_len: int, logp: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Mask tokens that would complete an n-gram already in ``seqs``."""
    if n <= 0:
        return logp
    b, tmax = seqs.shape
    dev = seqs.device
    pos = torch.arange(tmax, device=dev)
    idx = torch.clamp(pos[:, None] + torch.arange(n - 1, device=dev)[None, :],
                      max=tmax - 1)
    windows = seqs[:, idx]  # [B, T, n-1]
    suffix_idx = cur_len - (n - 1) + torch.arange(n - 1, device=dev)
    suffix = seqs[:, suffix_idx.clamp(min=0)]  # [B, n-1]
    match = (windows == suffix[:, None, :]).all(dim=-1)
    match = match & (pos[None, :] + n - 1 < cur_len) & (cur_len >= n - 1)
    cont = seqs[:, torch.clamp(pos + n - 1, max=tmax - 1)]  # [B, T]
    banned = torch.zeros(logp.shape, dtype=torch.int32, device=dev)
    banned = banned.scatter_add_(1, cont.long(), match.to(torch.int32)) > 0
    return logp.masked_fill(banned, NEG)


def _apply_repetition_penalty(seqs: torch.Tensor, cur_len: int,
                              logp: torch.Tensor, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: scores of tokens already in the
    sequence are divided by ``penalty`` when positive, multiplied when
    negative."""
    if penalty == 1.0:
        return logp
    seen = (torch.arange(seqs.shape[1], device=seqs.device) < cur_len)[None, :]
    present = torch.zeros(logp.shape, dtype=torch.int32, device=logp.device)
    present = present.scatter_add_(
        1, seqs.long(), seen.expand(seqs.shape).to(torch.int32)
    ) > 0
    penalized = torch.where(logp > 0, logp / penalty, logp * penalty)
    return torch.where(present, penalized, logp)


def _min_length_mask(logp: torch.Tensor, cur_len: int, opts, eos: int):
    if cur_len < opts.min_length:
        logp = logp.clone()
        logp[:, eos] = NEG
    return logp


def generate(params, cfg: RAGConfig, enc_out: RAGEncoderOutput,
             opts: GenerationOptions, *, dtype=torch.float32) -> torch.Tensor:
    """Generated ids [B, max_new_tokens] (pad after eos). Retrieval happened
    once, in `rag_encode`; the memory stays fixed for every step."""
    if opts.do_sample:
        raise NotImplementedError(
            "do_sample is not ported yet (ROADMAP queue 1: sampling)"
        )
    with torch.no_grad():
        if opts.num_beams <= 1:
            return _greedy(params, cfg, enc_out, opts, dtype)
        return _beam(params, cfg, enc_out, opts, dtype)


def _step_fn(params, cfg, dtype, copy_kv=None):
    def step(enc_out, tok, caches, pos):
        out, _, caches = rag_decode(
            params, cfg, enc_out, tok[:, None], caches=caches, pos_offset=pos,
            dtype=dtype, copy_kv=copy_kv,
        )
        out = out[:, 0]
        if cfg.mips_disabled or enc_out.memory is None:
            return torch.log_softmax(out, dim=-1), caches
        return out, caches  # already log-probs of the copy mixture

    return step


def _init_caches(params, cfg, b, t_max, dtype, enc_hidden):
    return init_decode_caches(params.led, cfg.led, b, t_max, dtype,
                              enc_hidden=enc_hidden)


def _copy_kv(params, cfg, enc_out, dtype):
    if cfg.mips_disabled or enc_out.memory is None or not cfg.use_own_decoder:
        return None
    return precompute_copy_kv(params.copy_head, enc_out.memory.to(dtype),
                              cfg.copy_heads or cfg.led.n_heads)


def _scores_after_step(seqs, t, logp, opts, eos):
    logp = _apply_repetition_penalty(seqs, t + 1, logp, opts.repetition_penalty)
    logp = _ban_repeated_ngrams(seqs, t + 1, logp, opts.no_repeat_ngram_size)
    return _min_length_mask(logp, t + 1, opts, eos)


def _greedy(params, cfg, enc_out, opts: GenerationOptions, dtype):
    b = enc_out.enc_hidden.shape[0]
    dev = enc_out.enc_hidden.device
    t_max = opts.max_new_tokens
    pad, eos = cfg.led.pad_id, cfg.led.eos_id
    step = _step_fn(params, cfg, dtype, _copy_kv(params, cfg, enc_out, dtype))
    caches = _init_caches(params, cfg, b, t_max + 1, dtype, enc_out.enc_hidden)
    seqs = torch.full((b, t_max + 1), pad, dtype=torch.int32, device=dev)
    seqs[:, 0] = opts.decoder_start_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(t_max):
        logp, caches = step(enc_out, seqs[:, t], caches, t)
        logp = _scores_after_step(seqs, t, logp, opts, eos)
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        seqs[:, t + 1] = nxt
        done = done | (nxt == eos)
    return seqs[:, 1:]


def _length_penalty(cur_len: int, alpha: float) -> torch.Tensor:
    base = torch.tensor(5.0 + cur_len, dtype=torch.float32) / 6.0
    return base ** alpha


def _beam(params, cfg, enc_out, opts: GenerationOptions, dtype):
    b = enc_out.enc_hidden.shape[0]
    dev = enc_out.enc_hidden.device
    beams = opts.num_beams
    bb = b * beams
    t_max = opts.max_new_tokens
    pad, eos = cfg.led.pad_id, cfg.led.eos_id

    # encoder outputs and memory stay un-expanded: attention folds the beam
    # axis into the query axis (core._fold_groups)
    step = _step_fn(params, cfg, dtype, _copy_kv(params, cfg, enc_out, dtype))
    caches = _init_caches(params, cfg, bb, t_max + 1, dtype, enc_out.enc_hidden)

    seqs = torch.full((bb, t_max + 1), pad, dtype=torch.int32, device=dev)
    seqs[:, 0] = opts.decoder_start_id
    scores = torch.tensor([0.0] + [NEG] * (beams - 1), dtype=torch.float32,
                          device=dev).repeat(b, 1)  # beam 0 live, others dead
    fin_seqs = torch.full((b, beams, t_max + 1), pad, dtype=torch.int32, device=dev)
    fin_scores = torch.full((b, beams), NEG, dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)[:, None] * beams

    for t in range(t_max):
        logp, caches = step(enc_out, seqs[:, t], caches, t)  # [bb, V]
        v = logp.shape[-1]
        logp = _scores_after_step(seqs, t, logp, opts, eos)
        total = (scores.reshape(bb, 1) + logp).reshape(b, beams * v)
        top_scores, top_idx = _topk(total, 2 * beams)
        src_beam = top_idx // v
        tok_id = (top_idx % v).to(torch.int32)
        is_eos = tok_id == eos

        # finished candidates (length-penalised) compete for the final set
        lp = _length_penalty(t + 1, opts.length_penalty).to(dev)
        cand_fin = torch.where(is_eos, top_scores / lp,
                               torch.full_like(top_scores, NEG))
        cand_seqs = seqs[(rows + src_beam).reshape(-1)].reshape(b, 2 * beams, -1)
        cand_seqs[:, :, t + 1] = torch.where(is_eos, torch.full_like(tok_id, pad),
                                             tok_id)
        all_fin_scores = torch.cat([fin_scores, cand_fin], dim=1)
        all_fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        fin_top, fin_pos = _topk(all_fin_scores, beams)
        new_fin_seqs = torch.gather(
            all_fin_seqs, 1, fin_pos[:, :, None].expand(b, beams, t_max + 1)
        )
        if opts.early_stopping:
            # once `beams` hypotheses finished, the finished set is frozen
            was_done = (fin_scores > NEG / 2).all(dim=1)
            fin_seqs = torch.where(was_done[:, None, None], fin_seqs, new_fin_seqs)
            fin_scores = torch.where(was_done[:, None], fin_scores, fin_top)
        else:
            fin_seqs, fin_scores = new_fin_seqs, fin_top

        # alive candidates: the best `beams` that did not emit eos
        alive_scores = torch.where(is_eos, torch.full_like(top_scores, NEG),
                                   top_scores)
        scores, alive_pos = _topk(alive_scores, beams)
        alive_beam = torch.gather(src_beam, 1, alive_pos)
        alive_tok = torch.gather(tok_id, 1, alive_pos)
        gather = (rows + alive_beam).reshape(-1)
        seqs = seqs[gather]
        seqs[:, t + 1] = alive_tok.reshape(-1)
        # reorder every beam-laid-out cache entry; cross K/V are per item
        for layer in caches:
            for name in ("k", "v"):
                layer[name] = layer[name][gather]

    lp = _length_penalty(t_max, opts.length_penalty).to(dev)
    use_fin = fin_scores[:, 0] > scores[:, 0] / lp
    if opts.early_stopping:
        use_fin = use_fin | (fin_scores > NEG / 2).all(dim=1)
    best_alive = seqs.reshape(b, beams, t_max + 1)[:, 0]
    best = torch.where(use_fin[:, None], fin_seqs[:, 0], best_alive)
    return best[:, 1:]


def copy_trace(*args, **kwargs):
    """Per-token copy traces (``generation.output_copy_probs``): not ported
    yet."""
    raise NotImplementedError(
        "copy_trace is not ported yet (ROADMAP queue 1: copy_trace)"
    )
