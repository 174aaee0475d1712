"""Baseline seq2seq fine-tuning (BART / T5).

Counterpart of ``retrieval_augmented_mds_tpu/train/baseline.py``: the
reference baselines' training surface (sotasum/bart_lightning.py:94-124:
shift right → forward → label-smoothed CE; sotasum/t5_lightning.py:93-124
with `_shift_right`, the "summarize: " prompt living in the data module)
and their greedy decoding, over the port's model families. As in the
reference's step, the update is the optimizer of `train.optimizer`
(``build_optimizer``), and the parameters are updated in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.bart import bart_decode, bart_encode, bart_lm_logits
from ..models.config import Seq2SeqConfig
from ..models.led import init_decode_caches, shift_tokens_right
from ..models.t5 import init_t5_caches, t5_decode, t5_encode, t5_lm_logits, t5_shift_right
from .loss import summarization_loss
from .optimizer import AdamW
from .trainer import TrainState, _backward_grads


def _family(name: str, cfg: Seq2SeqConfig):
    """(encode, decode, lm_logits, shift, init_caches) of a family."""
    if name == "bart":
        return (bart_encode, bart_decode, bart_lm_logits,
                lambda ids: shift_tokens_right(ids, cfg.pad_id, cfg.eos_id), init_decode_caches)
    if name == "t5":
        return (t5_encode, t5_decode, lambda p, h: t5_lm_logits(p, h, cfg),
                lambda ids: t5_shift_right(ids, cfg.pad_id, 0), init_t5_caches)
    raise ValueError(name)


def make_seq2seq_train_step(family: str, cfg: Seq2SeqConfig, tx: AdamW,
                            label_smoothing_eps: float = 0.1) -> Callable:
    """Returns ``step(state, batch) → (state, {"loss"})``: the forward in
    f32 (as `run_fit_baseline` of the JAX package calls its step), the
    label-smoothed loss, the gradients and one ``tx`` update."""
    encode, decode, lm_logits, shift, _ = _family(family, cfg)

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = state.params
        enc = encode(params, cfg, batch["input_ids"], batch["attention_mask"])
        hid, _ = decode(params, cfg, shift(batch["labels"]), enc, batch["attention_mask"])
        logp = torch.log_softmax(lm_logits(params, hid), dim=-1)
        loss = summarization_loss(logp, batch["labels"], label_smoothing_eps, cfg.pad_id)
        tx.update(params, _backward_grads(params, loss), state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


@torch.no_grad()
def seq2seq_greedy(family: str, params, cfg: Seq2SeqConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy generation for the baselines (the validation ROUGE loop,
    reference bart_lightning.py:126-196) → ids [B, max_new_tokens] int32,
    from the family's decoder start (BART ``eos``, T5 0). It takes exactly ``max_new_tokens`` steps, as the JAX package's scan
    does; a row that has emitted ``eos`` gets ``pad`` from then on. Step t
    embeds its token at decoder position t. (The JAX package's BART greedy
    passes no position, so every step there embeds position 0, where the
    teacher-forced decoder that it was trained with has position t: a
    fault of the reference that the port does not copy. T5 has no absolute
    positions, and its ids are the JAX package's.)"""
    encode, decode, lm_logits, _, init_caches = _family(family, cfg)
    b = input_ids.shape[0]
    enc = encode(params, cfg, input_ids, attention_mask)
    caches = init_caches(params, cfg, b, max_new_tokens + 1, enc.dtype, enc_hidden=enc)
    seqs = torch.full((b, max_new_tokens + 1), cfg.pad_id, dtype=torch.int32,
                      device=input_ids.device)
    seqs[:, 0] = cfg.eos_id if family == "bart" else 0
    done = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    for t in range(max_new_tokens):
        hid, caches = decode(params, cfg, seqs[:, t:t + 1], enc, attention_mask,
                             caches=caches, pos_offset=t)
        nxt = lm_logits(params, hid)[:, 0].argmax(-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_id), nxt)
        seqs[:, t + 1] = nxt
        done = done | (nxt == cfg.eos_id)
    return seqs[:, 1:]
