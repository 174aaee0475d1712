"""The plain reference: the retrieval-augmented LED, the Longformer
encoders, the dual-encoder retriever, their losses and the optimizer, in
plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the configuration (a dict), the weights it drew from
the seed (`weights.draw`), the token arrays of the traffic and, where a
stage is judged on its own, the program's output of the stage before (the
rows a search returned). Every attention is one masked softmax over an
explicit [T, T] mask, the form of the published description; each
departure from the program's arrangement of the work changes only the
order of roundoff.

Precision: ``prec`` is a `Precision`: f32 with TF32 off (the reference),
or a lower one (the control): every product as fp8 training computes it
(operands in e4m3, gradients in e5m2, per-tensor scales), or f32 products
on TF32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9
COPY_EPS = 1e-7
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8

# the published widths of the presets the configurations name, frozen here
ENC_BASE = dict(vocab_size=50265, d_model=768, n_heads=12, n_layers=12, d_ffn=3072,
                max_len=4096, window=256, max_globals=64, pad_id=1, bos_id=0, eos_id=2,
                pos_offset=2)
LED_BASE = dict(vocab_size=50266, d_model=768, n_heads=12, enc_layers=6, dec_layers=6,
                d_ffn=3072, max_src_len=16384, max_tgt_len=1024, window=512,
                max_globals=64, pad_id=1, bos_id=0, eos_id=2, doc_sep_id=50265)
ENC_TINY = dict(ENC_BASE, vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ffn=128,
                max_len=512, window=64, max_globals=8)
LED_TINY = dict(LED_BASE, vocab_size=512, d_model=64, n_heads=2, enc_layers=2,
                dec_layers=2, d_ffn=128, max_src_len=512, max_tgt_len=64, window=64,
                max_globals=8, doc_sep_id=511)
PRESETS = {"led_base": (LED_BASE, ENC_BASE), "tiny": (LED_TINY, ENC_TINY)}
MODEL_DEFAULTS = dict(mips_topk=4, memory_len=128, use_own_decoder=True, gates_mode="both",
                      skip_residual=False, copy_decoder_layers=1, copy_heads=0,
                      memory_model_fixed=True, memory_forcing="no_forcing")


def resolve(experiment: dict) -> dict:
    """The model sizes a configuration's ``experiment`` states."""
    m = dict(experiment.get("model", {}))
    led, enc = PRESETS[m.pop("preset", "tiny")]
    out = dict(MODEL_DEFAULTS)
    out["led"] = dict(led, **m.pop("led", {}))
    for key in ("query_enc", "mips_enc", "memory_enc"):
        out[key] = dict(enc, **m.pop(key, {}))
    out.update({k: v for k, v in m.items() if k in MODEL_DEFAULTS})
    if out["memory_forcing"] != "no_forcing" or not out["use_own_decoder"]:
        raise ValueError("the reference holds the configurations the benchmark runs: "
                         "memory_forcing no_forcing and the cross-attention copy head")
    return out


# ---------------------------------------------------------------------------
# parameters: names and shapes as the program names them
# ---------------------------------------------------------------------------

def _dense(p, d_in, d_out):
    return [(f"{p}.kernel", (d_in, d_out)), (f"{p}.bias", (d_out,))]


def _ln(p, d):
    return [(f"{p}.scale", (d,)), (f"{p}.bias", (d,))]


def _ffn(p, d, f):
    return _dense(f"{p}.w1", d, f) + _dense(f"{p}.w2", f, d)


def _encoder_specs(p, c):
    d = c["d_model"]
    out = [(f"{p}.tok_emb.table", (c["vocab_size"], d)),
           (f"{p}.pos_emb.table", (c["max_len"] + c["pos_offset"], d))] + _ln(f"{p}.emb_ln", d)
    for i in range(c["n_layers"]):
        lp = f"{p}.layers.{i}"
        for n in ("q", "k", "v", "qg", "kg", "vg", "o"):
            out += _dense(f"{lp}.attn.{n}", d, d)
        out += _ln(f"{lp}.attn_ln", d) + _ffn(f"{lp}.ffn", d, c["d_ffn"]) + _ln(f"{lp}.ffn_ln", d)
    return out


def _led_specs(c):
    d = c["d_model"]
    out = [("led.shared_emb.table", (c["vocab_size"], d)),
           ("led.enc_pos.table", (c["max_src_len"], d)),
           ("led.dec_pos.table", (c["max_tgt_len"], d))]
    out += _ln("led.enc_emb_ln", d) + _ln("led.dec_emb_ln", d)
    for i in range(c["enc_layers"]):
        lp = f"led.encoder.{i}"
        for n in ("q", "k", "v", "qg", "kg", "vg", "o"):
            out += _dense(f"{lp}.attn.{n}", d, d)
        out += _ln(f"{lp}.attn_ln", d) + _ffn(f"{lp}.ffn", d, c["d_ffn"]) + _ln(f"{lp}.ffn_ln", d)
    for i in range(c["dec_layers"]):
        lp = f"led.decoder.{i}"
        for a in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                out += _dense(f"{lp}.{a}.{n}", d, d)
            out += _ln(f"{lp}.{a.split('_')[0]}_ln", d)
        out += _ffn(f"{lp}.ffn", d, c["d_ffn"]) + _ln(f"{lp}.ffn_ln", d)
    return out + [("led.final_logits_bias", (c["vocab_size"],))]


def rag_specs(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter of the retrieval-augmented model."""
    d, f = cfg["led"]["d_model"], cfg["led"]["d_ffn"]
    out = _led_specs(cfg["led"]) + _encoder_specs("query_encoder", cfg["query_enc"])
    out += _encoder_specs("mips_encoder", cfg["mips_enc"])
    if not cfg["memory_model_fixed"]:
        out += _encoder_specs("memory_encoder", cfg["memory_enc"])
    for i in range(cfg["copy_decoder_layers"]):
        lp = f"copy_head.layers.{i}"
        for n in ("q", "k", "v", "o"):
            out += _dense(f"{lp}.cross_attn.{n}", d, d)
        out += [(f"{lp}.beta", ()), (f"{lp}.beta_bias", ())]
        out += _ln(f"{lp}.cross_ln", d) + _ffn(f"{lp}.ffn", d, f) + _ln(f"{lp}.ffn_ln", d)
    out += _ln("copy_head.align_ln", d)
    out += _dense("copy_head.diverter", d if cfg["gates_mode"] == "onlycopy" else 2 * d, 2)
    return out


def retriever_specs(cfg: dict) -> list[tuple[str, tuple]]:
    return (_encoder_specs("query_encoder", cfg["query_enc"])
            + _encoder_specs("mips_encoder", cfg["mips_enc"]))


def init_kind(name: str) -> str:
    """How the seed fills a leaf: "normal" (x 0.02), "zero" or "one"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("kernel", "table"):
        return "normal"
    if leaf.endswith("bias"):
        return "zero"
    return "one"  # LayerNorm scale, copy-head beta


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to an fp8 type at a per-tensor scale (its largest
    magnitude at the type's largest value), and back to f32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    """A product as fp8 training computes it: the operands in e4m3, the
    incoming gradient in e5m2, each at a per-tensor scale, f32 sums."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round8(a, torch.float8_e4m3fn), _round8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a, b = qa.detach().requires_grad_(), qb.detach().requires_grad_()
            return torch.autograd.grad(torch.matmul(a, b), (a, b),
                                       _round8(g, torch.float8_e5m2))


class Precision:
    """``"f32"``: f32 products, TF32 off. ``"tf32"``: f32 products on TF32.
    ``"fp8"``: products as fp8 training computes them (`_Fp8MatMul`)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(name)
        self.name = name

    def mm(self, a, b):
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self):
        m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
            self.name == "tf32")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Net:
    """The forward functions over a dict of named f32 weights."""

    def __init__(self, w: dict, cfg: dict, prec: Precision):
        self.w, self.cfg, self.prec = w, cfg, prec

    def dense(self, p, x):
        return self.prec.mm(x, self.w[f"{p}.kernel"]) + self.w[f"{p}.bias"]

    def ln(self, p, x, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * self.w[f"{p}.scale"] + self.w[f"{p}.bias"]

    def ffn(self, p, x):
        return self.dense(f"{p}.w2", F.gelu(self.dense(f"{p}.w1", x), approximate="tanh"))

    def heads(self, x, nh):
        b, t, h = x.shape
        return x.reshape(b, t, nh, h // nh).transpose(1, 2)

    def merge(self, x):
        b, nh, t, dh = x.shape
        return x.transpose(1, 2).reshape(b, t, nh * dh)

    def attend(self, q, k, v, allowed, bias=None):
        """softmax(q kᵀ / sqrt(dh) + bias, masked to ``allowed``) v →
        (out, probabilities)."""
        dh = q.shape[-1]
        logits = self.prec.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        if bias is not None:
            logits = logits + bias
        logits = logits.masked_fill(~allowed, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return self.prec.mm(p, v), p

    def sliding(self, p, x, nh, w, global_mask, pad, max_globals):
        """Longformer attention: a token attends the real, non-global tokens
        within w of it and the first ``max_globals`` global tokens; a global
        token (of those) attends every real token with the global
        projections; padded rows are zero."""
        b, t, _ = x.shape
        q, k, v = (self.heads(self.dense(f"{p}.{n}", x), nh) for n in ("q", "k", "v"))
        real = pad > 0
        is_g = global_mask > 0
        rank = torch.cumsum(is_g.long(), 1)
        g_key = is_g & (rank <= max_globals)
        i = torch.arange(t, device=x.device)
        band = (i[None, :] - i[:, None]).abs() <= w
        allowed = (band[None] & (real & ~is_g)[:, None, :]) | g_key[:, None, :]
        out, _ = self.attend(q, k, v, allowed[:, None])
        # the global rows, gathered (at most max_globals a row)
        g = min(max_globals, t)
        rows = torch.argsort((~g_key).to(torch.int8), dim=1, stable=True)[:, :g]
        valid = torch.gather(g_key, 1, rows)
        take = rows[:, None, :, None].expand(b, nh, g, q.shape[-1])
        qg = torch.gather(self.heads(self.dense(f"{p}.qg", x), nh), 2, take)
        kg, vg = (self.heads(self.dense(f"{p}.{n}", x), nh) for n in ("kg", "vg"))
        out_g, _ = self.attend(qg, kg, vg, real[:, None, None, :].expand(b, 1, g, t))
        out_g = torch.where(valid[:, None, :, None], out_g, torch.gather(out, 2, take))
        out = out.scatter(2, take, out_g)
        out = out * real[:, None, :, None]
        return self.dense(f"{p}.o", self.merge(out))

    def longformer(self, p, c, ids, mask):
        """A Longformer encoder's hidden states [B, T, H] (global attention on
        the first token)."""
        b, t = ids.shape
        g = torch.zeros_like(mask)
        g[:, 0] = 1
        g = g * mask
        pos = torch.arange(t, device=ids.device) + c["pos_offset"]
        x = self.w[f"{p}.tok_emb.table"][ids.long()] + self.w[f"{p}.pos_emb.table"][pos]
        x = self.ln(f"{p}.emb_ln", x)
        for i in range(c["n_layers"]):
            lp = f"{p}.layers.{i}"
            a = self.sliding(f"{lp}.attn", x, c["n_heads"], c["window"], g, mask,
                             c["max_globals"])
            x = self.ln(f"{lp}.attn_ln", x + a)
            x = self.ln(f"{lp}.ffn_ln", x + self.ffn(f"{lp}.ffn", x))
        return x

    def led_encode(self, ids, mask):
        c = self.cfg["led"]
        b, s = ids.shape
        g = torch.zeros_like(mask)
        g[:, 0] = 1
        g = torch.where(ids == c["doc_sep_id"], torch.ones_like(g), g) * mask
        x = self.w["led.shared_emb.table"][ids.long()] + self.w["led.enc_pos.table"][:s]
        x = self.ln("led.enc_emb_ln", x)
        for i in range(c["enc_layers"]):
            lp = f"led.encoder.{i}"
            a = self.sliding(f"{lp}.attn", x, c["n_heads"], c["window"], g, mask,
                             c["max_globals"])
            x = self.ln(f"{lp}.attn_ln", x + a)
            x = self.ln(f"{lp}.ffn_ln", x + self.ffn(f"{lp}.ffn", x))
        return x

    def mha(self, p, xq, xkv, nh, allowed):
        q, k, v = (self.heads(self.dense(f"{p}.{n}", t), nh)
                   for n, t in (("q", xq), ("k", xkv), ("v", xkv)))
        out, _ = self.attend(q, k, v, allowed)
        return self.dense(f"{p}.o", self.merge(out))

    def led_decode(self, dec_ids, enc, enc_mask):
        """Teacher-forced decoder hidden states [B, T, H]."""
        c = self.cfg["led"]
        t = dec_ids.shape[1]
        x = self.w["led.shared_emb.table"][dec_ids.long()] + self.w["led.dec_pos.table"][:t]
        x = self.ln("led.dec_emb_ln", x)
        i = torch.arange(t, device=x.device)
        causal = (i[None, :] <= i[:, None])[None, None]
        cross = (enc_mask > 0)[:, None, None, :]
        for li in range(c["dec_layers"]):
            lp = f"led.decoder.{li}"
            x = self.ln(f"{lp}.self_ln", x + self.mha(f"{lp}.self_attn", x, x, c["n_heads"],
                                                      causal))
            x = self.ln(f"{lp}.cross_ln", x + self.mha(f"{lp}.cross_attn", x, enc,
                                                       c["n_heads"], cross))
            x = self.ln(f"{lp}.ffn_ln", x + self.ffn(f"{lp}.ffn", x))
        return x

    def copy_mixture(self, hid, mem):
        """The copy head and the gated mixture → log-probs [B, T, V]."""
        cfg, c = self.cfg, self.cfg["led"]
        nh = cfg["copy_heads"] or c["n_heads"]
        x, allowed = hid, (mem["mask"] > 0)[:, None, None, :]
        attn = align = None
        for li in range(cfg["copy_decoder_layers"]):
            lp = f"copy_head.layers.{li}"
            bias = (self.w[f"{lp}.beta"] * mem["bias"] + self.w[f"{lp}.beta_bias"])
            q = self.heads(self.dense(f"{lp}.cross_attn.q", x), nh)
            k = self.heads(self.dense(f"{lp}.cross_attn.k", mem["hidden"]), nh)
            v = self.heads(self.dense(f"{lp}.cross_attn.v", mem["hidden"]), nh)
            out, p = self.attend(q, k, v, allowed, bias[:, None, None, :])
            attn = self.dense(f"{lp}.cross_attn.o", self.merge(out))
            align = p.mean(1)
            x = self.ln(f"{lp}.cross_ln", x + attn)
            f = self.ffn(f"{lp}.ffn", x)
            x = self.ln(f"{lp}.ffn_ln", f if cfg["skip_residual"] else x + f)
        mode = cfg["gates_mode"]
        gates_in = (torch.cat([x, self.ln("copy_head.align_ln", attn)], -1) if mode == "nmt"
                    else x if mode == "onlycopy" else torch.cat([x, hid], -1))
        gates = torch.softmax(self.dense("copy_head.diverter", gates_in), -1)
        gen, copy = gates[..., :1], gates[..., 1:]
        lm = self.prec.mm(hid, self.w["led.shared_emb.table"].T) + self.w["led.final_logits_bias"]
        probs = gen * torch.softmax(lm, -1)
        b, t, m = align.shape
        probs = probs.scatter_add(2, mem["seq"].long()[:, None, :].expand(b, t, m),
                                  copy * align)
        return torch.log(probs + COPY_EPS)

    def memory(self, q_cls, mem_ids, mem_mask):
        """The retrieved rows [B, k, L] re-encoded: the cosine scores of the
        mips encoder's CLS against the query's (norms held constant), and the
        memory encoder's states → the copy memory."""
        cfg = self.cfg
        b, k, L = mem_ids.shape
        flat_ids, flat_mask = mem_ids.reshape(b * k, L), mem_mask.reshape(b * k, L)
        mips = self.longformer("mips_encoder", cfg["mips_enc"], flat_ids, flat_mask)
        m_cls = mips[:, 0].reshape(b, k, -1)
        raw = torch.einsum("bh,bkh->bk", q_cls, m_cls)
        qn = torch.linalg.norm(q_cls, dim=-1, keepdim=True).detach()
        mn = torch.linalg.norm(m_cls, dim=-1).detach()
        scores = raw / torch.clamp(qn * mn, min=1e-12)
        if cfg["memory_model_fixed"]:
            hid = mips
        else:
            hid = self.longformer("memory_encoder", cfg["memory_enc"], flat_ids, flat_mask)
        enc = cfg["memory_enc"]
        ok = (mem_ids != enc["bos_id"]) & (mem_ids != enc["eos_id"]) & (mem_mask > 0)
        return {"hidden": hid.reshape(b, k * L, -1), "mask": ok.reshape(b, k * L),
                "bias": scores[:, :, None].expand(b, k, L).reshape(b, k * L),
                "seq": mem_ids.reshape(b, k * L), "scores": scores}

    def query(self, ids, mask):
        return self.longformer("query_encoder", self.cfg["query_enc"], ids, mask)[:, 0]

    def rag_logprobs(self, batch, mem_ids, mem_mask, dec_in):
        """Teacher-forced log-probs [B, T, V], with the intermediate states."""
        q_cls = self.query(batch["query_input_ids"], batch["query_attention_mask"])
        mem = self.memory(q_cls, mem_ids, mem_mask)
        enc = self.led_encode(batch["input_ids"], batch["attention_mask"])
        hid = self.led_decode(dec_in, enc, batch["attention_mask"])
        return self.copy_mixture(hid, mem), {"query": q_cls, "enc": enc, "memory": mem}


def shift_right(labels: torch.Tensor, pad: int, start: int) -> torch.Tensor:
    out = torch.roll(labels, 1, dims=-1)
    out[:, 0] = start
    return torch.where(out == -100, torch.full_like(out, pad), out)


def smoothed_loss_sums(logp, labels, eps, pad):
    """Label-smoothed NLL over the non-pad labels → (the sum of each
    token's loss, the number of tokens); the loss of a batch is the first
    over the second."""
    keep = labels != pad
    nll = -torch.gather(logp, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    smooth = -logp.sum(-1) / logp.shape[-1]
    per = (1.0 - eps) * nll + eps * smooth
    return (per * keep).sum(), keep.sum()


# ---------------------------------------------------------------------------
# optimizer: AdamW with a bf16 first moment, global-norm clipping, and the
# linear warmup of the configuration
# ---------------------------------------------------------------------------

def schedule(lr, warmup, total, step):
    warmup = max(1, warmup)
    if step < warmup:
        return lr * step / warmup
    return lr * max(0.0, (total - step) / max(1, total - warmup))


class AdamW:
    def __init__(self, params: dict, train: dict):
        self.t = train
        self.mu_dtype = getattr(torch, train.get("adam_mu_dtype") or "float32")
        # b1 as the first moment's type holds it
        self.b1 = float(torch.tensor(B1, dtype=self.mu_dtype))
        self.mu = {n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """One update in place → each leaf's gradient as the moments take it
        (after the clip)."""
        clip = self.t.get("grad_clip")
        if clip:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            if norm >= clip:
                grads = {n: g / norm * clip for n, g in grads.items()}
        lr = schedule(self.t["lr"], self.t["warmup_steps"], self.t["total_steps"], self.count)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for n, p in params.items():
            g = grads[n]
            mu = g * (1 - B1) + self.mu[n].float() * self.b1
            nu = g * g * (1 - B2) + self.nu[n] * B2
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if self.t.get("weight_decay"):
                u = u + self.t["weight_decay"] * p
            p.add_(u * -lr)
            self.mu[n], self.nu[n] = mu.to(self.mu_dtype), nu
        return grads


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}
