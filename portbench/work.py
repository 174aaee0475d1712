"""The work a step or a batch needs, from its masks: model FLOPs and the
bounds of each attention-kernel launch.

Model FLOPs count the products on real (non-padded) tokens: the weight
GEMMs at 2 operations a multiply-add, the attention at 4 x d_model a
visible (query, key) pair (the window's, the globals', the causal and the
padding masks'), training as 3 x the forward for the trained parts, no
recomputation, and nothing for the search, norms or elementwise work.
Where the program computes a projection for every token that only some
tokens need (the global-query projection), only those tokens count.

`Work` sums a run's FLOPs and collects, per kernel wrapper, the bound in
seconds of each launch it expects (`roofline`), so a reader can hold the
count to the wrapper's ``.launches`` counter.
"""

from __future__ import annotations

import dataclasses

import torch

from . import roofline


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bounds: dict = dataclasses.field(default_factory=dict)  # wrapper → [seconds]

    def launch(self, wrapper: str, seconds: float) -> None:
        self.bounds.setdefault(wrapper, []).append(seconds)

    def add(self, other: "Work") -> None:
        self.flops += other.flops
        for k, v in other.bounds.items():
            self.bounds.setdefault(k, []).extend(v)


def _real(mask) -> torch.Tensor:
    return torch.as_tensor(mask) > 0


def encoder_gemm(n_tokens: float, n_qg: float, c: dict) -> float:
    """One sliding-attention layer's weight GEMMs: q, k, v, o and the
    global k, v on ``n_tokens`` tokens, the global q on ``n_qg``, the FFN."""
    d, f = c["d_model"], c["d_ffn"]
    return 2 * (n_tokens * (6 * d * d + 2 * d * f) + n_qg * d * d)


def decoder_gemm(n_tgt: float, n_src: float, c: dict) -> float:
    """One decoder layer's weight GEMMs: self q, k, v, o, cross q, o and
    the FFN on ``n_tgt`` positions, cross k, v on ``n_src`` source tokens."""
    d, f = c["d_model"], c["d_ffn"]
    return 2 * (n_tgt * (6 * d * d + 2 * d * f) + n_src * 2 * d * d)


def sliding_encoder(pad, global_mask, c: dict, precision: str, train: bool,
                    kernels: bool = True) -> Work:
    """A Longformer-style encoder of ``c`` (d_model, n_heads, n_layers or
    enc_layers, d_ffn, window, max_globals) over [N, T] masks."""
    pad = torch.as_tensor(pad).long()
    gm = torch.as_tensor(global_mask).long()
    d, nh, w = c["d_model"], c["n_heads"], c["window"]
    layers = c.get("n_layers", c.get("enc_layers"))
    dh = d // nh
    key_bias, g_bias, valid_g = roofline.sliding_masks(pad, gm, c["max_globals"])
    real = pad > 0
    n_real, n_glob = float(real.sum()), float(valid_g.sum())
    local = real & ~valid_g
    glob_pairs = float((valid_g.sum(1) * real.sum(1)).sum())
    pairs = roofline.sliding_pairs(key_bias, g_bias, w, 1, local) + glob_pairs
    per_layer = encoder_gemm(n_real, n_glob, c) + 4 * d * pairs
    out = Work(flops=layers * per_layer * (3 if train else 1))
    if kernels:
        k2 = roofline.k2_bound(key_bias, g_bias, w, nh, dh, precision)
        k3 = roofline.k3_bound(key_bias, g_bias, w, nh, dh, local, precision) if train else 0
        for _ in range(layers):
            out.launch("flash_sliding_attention", k2)
            if train:
                out.launch("flash_sliding_backward", k3)
    return out


def led_global_mask(ids, pad, doc_sep_id: int) -> torch.Tensor:
    """The LED source's global tokens: the first and every ``<DOC_SEP>``."""
    ids = torch.as_tensor(ids)
    g = (ids == doc_sep_id).long()
    g[:, 0] = 1
    return g * torch.as_tensor(pad).long()


def cls_global_mask(pad) -> torch.Tensor:
    g = torch.zeros_like(torch.as_tensor(pad)).long()
    g[:, 0] = 1
    return g * torch.as_tensor(pad).long()


def decoder_train(tgt_ok, src_ok, c: dict, precision: str) -> Work:
    """The teacher-forced decoder over real targets [B, T] against real
    sources [B, S]: self-attention (causal, K4/K5 over every key of the
    target width), cross-attention (K4/K5 over the source's keys), FFN."""
    tgt_ok, src_ok = _real(tgt_ok), _real(src_ok)
    d, nh = c["d_model"], c["n_heads"]
    dh = d // nh
    n_t, n_s = float(tgt_ok.sum()), float(src_ok.sum())
    t = tgt_ok.shape[1]
    # real targets are a prefix of each row: their causal pairs
    lens = tgt_ok.sum(1).double()
    self_pairs = float((lens * (lens + 1) / 2).sum())
    cross_pairs = float((tgt_ok.sum(1) * src_ok.sum(1)).sum())
    per_layer = decoder_gemm(n_t, n_s, c) + 4 * d * (self_pairs + cross_pairs)
    out = Work(flops=3 * c["dec_layers"] * per_layer)
    self_ok = torch.ones_like(tgt_ok)  # the self-attention's keys are never masked
    b4 = [roofline.k4_bound(self_ok, t, nh, dh, True, precision),
          roofline.k4_bound(src_ok, t, nh, dh, False, precision)]
    b5 = [roofline.k5_bound(self_ok, t, nh, dh, True, precision),
          roofline.k5_bound(src_ok, t, nh, dh, False, precision)]
    for _ in range(c["dec_layers"]):
        for x in b4:
            out.launch("flash_dense_attention", x)
        for x in b5:
            out.launch("flash_dense_backward", x)
    return out


def copy_head(n_tgt: float, pairs: float, n_mem: float, cfg: dict, steps: float = 1) -> float:
    """Forward FLOPs of the copy head and the LM head: ``n_tgt`` decoder
    positions, ``n_mem`` real memory tokens (their K/V), ``pairs`` visible
    (position, memory token) pairs."""
    d, f, v = cfg["led"]["d_model"], cfg["led"]["d_ffn"], cfg["led"]["vocab_size"]
    layers = cfg["copy_decoder_layers"]
    per_tok = layers * (2 * d * d + 2 * d * f) + 2 * d * 2 + d * v
    return 2 * (n_tgt * per_tok + steps * layers * n_mem * 2 * d * d) + 4 * d * layers * pairs


def rag_train_step(batch: dict, mem_ids, mem_mask, cfg: dict, precision: str) -> Work:
    """One train step of the retrieval-augmented model on a host batch and
    its retrieved rows [B, k, L]."""
    led = cfg["led"]
    out = Work()
    q_pad = batch["query_attention_mask"]
    out.add(sliding_encoder(q_pad, cls_global_mask(q_pad), cfg["query_enc"], precision, True))
    b, k, L = mem_ids.shape
    m_pad = torch.as_tensor(mem_mask).reshape(b * k, L)
    encoders = ["mips_enc"] + ([] if cfg["memory_model_fixed"] else ["memory_enc"])
    for key in encoders:
        out.add(sliding_encoder(m_pad, cls_global_mask(m_pad), cfg[key], precision, True))
    src = batch["attention_mask"]
    out.add(sliding_encoder(src, led_global_mask(batch["input_ids"], src, led["doc_sep_id"]),
                            led, precision, True))
    tgt_ok = torch.as_tensor(batch["labels"]) != led["pad_id"]
    out.add(decoder_train(tgt_ok, src, led, precision))
    enc = cfg["memory_enc"]
    ids = torch.as_tensor(mem_ids).reshape(b, k * L)
    mem_ok = ((ids != enc["bos_id"]) & (ids != enc["eos_id"])
              & (torch.as_tensor(mem_mask).reshape(b, k * L) > 0))
    pairs = float((tgt_ok.sum(1) * mem_ok.sum(1)).sum())
    out.flops += 3 * copy_head(float(tgt_ok.sum()), pairs, float(mem_ok.sum()), cfg)
    return out


def rag_predict_batch(batch: dict, mem_ids, mem_mask, cfg: dict, gen: dict,
                      precision: str) -> Work:
    """`rag_encode` and the beam search of one batch: every hypothesis of
    every row runs every step (the loop does not stop early)."""
    led = cfg["led"]
    out = Work()
    q_pad = batch["query_attention_mask"]
    out.add(sliding_encoder(q_pad, cls_global_mask(q_pad), cfg["query_enc"], precision, False))
    b, k, L = mem_ids.shape
    m_pad = torch.as_tensor(mem_mask).reshape(b * k, L)
    for key in ["mips_enc"] + ([] if cfg["memory_model_fixed"] else ["memory_enc"]):
        out.add(sliding_encoder(m_pad, cls_global_mask(m_pad), cfg[key], precision, False))
    src = _real(batch["attention_mask"])
    out.add(sliding_encoder(src.long(), led_global_mask(batch["input_ids"], src.long(),
                                                        led["doc_sep_id"]),
                            led, precision, False))
    d = led["d_model"]
    beams, steps = gen["num_beams"], gen["max_new_tokens"]
    hyps = b * beams
    n_src = float(src.sum())
    # cross K/V once a batch; each step: self q,k,v,o, cross q,o, FFN
    out.flops += led["dec_layers"] * decoder_gemm(hyps * steps, n_src, led)
    self_pairs = hyps * steps * (steps + 1) / 2
    cross_pairs = beams * steps * n_src
    out.flops += 4 * d * led["dec_layers"] * (self_pairs + cross_pairs)
    enc = cfg["memory_enc"]
    ids = torch.as_tensor(mem_ids).reshape(b, k * L)
    mem_ok = ((ids != enc["bos_id"]) & (ids != enc["eos_id"])
              & (torch.as_tensor(mem_mask).reshape(b, k * L) > 0))
    out.flops += copy_head(hyps * steps, beams * steps * float(mem_ok.sum()),
                           float(mem_ok.sum()), cfg)
    return out


def retriever_step(batch: dict, cfg: dict, precision: str) -> Work:
    out = Work()
    for ids_key, enc in (("query_attention_mask", "query_enc"),
                         ("mips_attention_mask", "mips_enc")):
        pad = batch[ids_key]
        out.add(sliding_encoder(pad, cls_global_mask(pad), cfg[enc], precision, True))
    b = torch.as_tensor(batch["query_attention_mask"]).shape[0]
    out.flops += 3 * 2 * b * b * cfg["query_enc"]["d_model"]
    return out
