"""Retrieval-augmented generator: the flagship model.

Counterpart of ``retrieval_augmented_mds_tpu/models/retriever_generator.py``.
`rag_encode` embeds the query, searches the device-resident index (a flat
index through the MIPS kernel K1, an IVF index through `ivf_search`,
whose per-query route is the probe kernel K8) with the query's gradient
stopped, gathers the retrieved rows of the pre-tokenized corpus,
re-encodes them with the mips encoder (a differentiable cosine rescoring
+ the copy memory) and runs the LED encoder; `rag_decode` runs the
decoder (teacher-forced, or cached for generation) and the copy head;
`rag_forward` chains them for training. Gradients flow wherever the
reference's do; callers that serve run them under ``torch.no_grad()``.

Memory modes (``memory_forcing``), with ``memory_model_fixed`` true or
false: ``no_forcing`` (k retrieved slots); ``retrieved_forcing`` (the
same, without self-exclusion); ``target_only`` (one slot, the gold target,
no search); ``target_in`` (the target slot first, then the k retrieved
ones; its mask is zeroed when the copy-forcing flag is off); and dual
memory, when the batch carries ``input_memory_ids`` (the first input
documents take the first slots, retrieved rows the rest).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..index.flat import FlatIndex
from ..index.flat import search as flat_search
from ..index.ivf import IVFIndex, ivf_search, ivf_search_sharded
from ..obs.profiling import span
from .config import EncoderConfig, Seq2SeqConfig
from .copy_decoder import (
    CopyDecoder,
    CopyTokenDecoder,
    copy_decoder_forward,
    copy_token_decoder_forward,
    mix_copy_probs,
)
from .core import build_module
from .led import LED, led_decode, led_encode, led_lm_logits
from .longformer import Longformer, longformer_encode


@dataclasses.dataclass(frozen=True)
class RAGConfig:
    """Model-level knobs; same fields, defaults and checks as the JAX
    package's RAGConfig, so one YAML drives both."""

    led: Seq2SeqConfig
    query_enc: EncoderConfig
    mips_enc: EncoderConfig
    memory_enc: EncoderConfig
    mips_topk: int = 4
    memory_len: int = 128
    mips_disabled: bool = False
    use_own_decoder: bool = True
    gates_mode: str = "both"
    skip_residual: bool = False
    copy_decoder_layers: int = 1
    copy_heads: int = 0  # 0 = the LED decoder's head count
    memory_forcing: str = "no_forcing"
    copy_forcing: float = 0.0
    memory_model_fixed: bool = True
    mips_freezed: bool = False
    mips_encoder_freezed: bool = False
    query_encoder_freezed: bool = False
    led_weights: str | None = None
    query_encoder_weights: str | None = None
    mips_encoder_weights: str | None = None
    memory_encoder_weights: str | None = None
    adapter_name: str | None = None
    encoder_state_path: str | None = None
    sequence_shard: bool = False

    def __post_init__(self):
        modes = ("no_forcing", "target_only", "target_in", "retrieved_forcing")
        if self.memory_forcing not in modes:
            raise ValueError(
                f"memory_forcing={self.memory_forcing!r}; choices={modes}"
            )
        if self.memory_model_fixed:
            if self.mips_enc != self.memory_enc:
                raise ValueError(
                    "memory_model_fixed=True shares the mips encoder for "
                    "the memory re-encode, so mips_enc and memory_enc "
                    "configs must match; set memory_model_fixed=False for "
                    "a distinct memory encoder"
                )
            if self.memory_encoder_weights is not None:
                raise ValueError(
                    "memory_encoder_weights is unused when "
                    "memory_model_fixed=True (the shared mips encoder "
                    "encodes memory); set memory_model_fixed=False"
                )

    def frozen_groups(self) -> tuple[str, ...]:
        """Freeze policy → top-level param groups: ``mips_freezed`` freezes
        the whole retrieval stack, ``mips_encoder_freezed`` only the index
        encoder."""
        groups = []
        if self.mips_freezed:
            groups += ["query_encoder", "mips_encoder"]
            if not self.memory_model_fixed:
                groups += ["memory_encoder"]
        if self.mips_encoder_freezed:
            groups += ["mips_encoder"]
        if self.query_encoder_freezed:
            groups += ["query_encoder"]
        return tuple(dict.fromkeys(groups))

    @property
    def memory_slots(self) -> int:
        return self.mips_topk + (1 if self.memory_forcing == "target_in" else 0)

    @staticmethod
    def tiny(**kw) -> "RAGConfig":
        enc = EncoderConfig.tiny()
        d = dict(
            led=Seq2SeqConfig.tiny(), query_enc=enc, mips_enc=enc,
            memory_enc=enc, mips_topk=2, memory_len=64,
        )
        d.update(kw)
        return RAGConfig(**d)


@dataclasses.dataclass
class MemoryStore:
    """Device-resident memory: the index plus the pre-tokenized corpus."""

    index: FlatIndex | IVFIndex
    token_ids: torch.Tensor  # [N, L_mem] int32
    token_mask: torch.Tensor  # [N, L_mem] int32
    row_aids: torch.Tensor | None = None  # [N, A] int32
    nprobe: int = 8  # IVF probe width (mips_nprobe)


@dataclasses.dataclass
class RAGEncoderOutput:
    enc_hidden: torch.Tensor  # [B, S, H]
    enc_mask: torch.Tensor  # [B, S]
    memory: torch.Tensor | None  # [B, M, H]
    memory_mask: torch.Tensor | None  # [B, M]
    memory_bias: torch.Tensor | None  # [B, M]
    copy_seq: torch.Tensor | None  # [B, M]
    mips_scores: torch.Tensor | None  # [B, slots]
    retrieved_idx: torch.Tensor | None  # [B, k]
    faiss_scores: torch.Tensor | None = None  # [B, k] raw index scores
    query_cls: torch.Tensor | None = None  # [B, H]


def encoder_output_leaves(enc: RAGEncoderOutput) -> tuple[tuple[str, ...],
                                                          tuple[torch.Tensor, ...]]:
    """``enc`` as (the names of its fields that hold a tensor, those
    tensors), the form an exported program takes and returns it in."""
    names = tuple(f.name for f in dataclasses.fields(enc) if getattr(enc, f.name) is not None)
    return names, tuple(getattr(enc, n) for n in names)


def encoder_output_from_leaves(names, leaves) -> RAGEncoderOutput:
    """Inverse of `encoder_output_leaves`: every other field is None."""
    kw = dict.fromkeys(f.name for f in dataclasses.fields(RAGEncoderOutput))
    kw.update(zip(names, leaves))
    return RAGEncoderOutput(**kw)


def copy_kv_leaves(copy_kv) -> tuple[torch.Tensor, ...]:
    """The copy head's per-layer (k, v) heads as one flat tuple (empty for
    None)."""
    return () if copy_kv is None else tuple(t for kv in copy_kv for t in kv)


def copy_kv_from_leaves(leaves):
    """Inverse of `copy_kv_leaves`: [(k, v), ...] per layer, or None."""
    leaves = tuple(leaves)
    return [leaves[i:i + 2] for i in range(0, len(leaves), 2)] or None


class RAG(nn.Module):
    """Parameter tree of the whole model; paths mirror `init_rag`'s tree."""

    def __init__(self, cfg: RAGConfig):
        super().__init__()
        self.led = LED(cfg.led)
        self.query_encoder = Longformer(cfg.query_enc)
        self.mips_encoder = Longformer(cfg.mips_enc)
        if not cfg.memory_model_fixed:
            self.memory_encoder = Longformer(cfg.memory_enc)
        if cfg.use_own_decoder:
            self.copy_head = CopyDecoder(
                cfg.led.d_model, cfg.copy_decoder_layers, cfg.led.d_ffn,
                cfg.gates_mode,
            )
        else:
            self.copy_head = CopyTokenDecoder(cfg.led.d_model, cfg.led.d_ffn)


def init_rag(cfg: RAGConfig, generator: torch.Generator, device=None) -> RAG:
    """Random init with the reference's shapes and distributions (normal ×
    0.02 kernels and tables, zero biases, LayerNorm 1/0, beta 1,
    beta_bias 0), drawn from ``generator`` on its device (or ``device``)."""
    return build_module(lambda: RAG(cfg), generator, device)


_WEIGHT_FIELDS = ("led_weights", "query_encoder_weights", "mips_encoder_weights",
                  "memory_encoder_weights", "encoder_state_path")


def init_rag_pretrained(cfg: RAGConfig, generator: torch.Generator, device=None) -> RAG:
    """`init_rag`, then the pretrained weights the config names, under the
    load policy of `hf_import.load_pretrained_rag`."""
    params = init_rag(cfg, generator, device)
    if any(getattr(cfg, f) for f in _WEIGHT_FIELDS):
        from .hf_import import load_pretrained_rag

        params = load_pretrained_rag(params, cfg)
    return params


def _encode_memory_rows(enc_params, enc_cfg, ids, mask, *, dtype, remat=False):
    """[B, slots, L] → hidden [B, slots, L, H] via the shared encoder."""
    b, s, l = ids.shape
    hid = longformer_encode(
        enc_params, enc_cfg, ids.reshape(b * s, l), mask.reshape(b * s, l),
        dtype=dtype, remat=remat,
    )
    return hid.reshape(b, s, l, -1)


def _retrieve(cfg: RAGConfig, store: MemoryStore, batch, query_cls, mesh=None,
              data_sharded: bool = False):
    """The search with the query's gradient stopped, then the gather of the
    retrieved corpus rows → (ids, mask [B, k, L], scores, row ids [B, k]).
    Over a ``mesh``: a flat store searches its rows of the ``shard`` axis;
    an IVF store its clusters when it is sharded, and the whole index on
    every rank when it is not (a cluster count the shards do not divide)."""
    # retrieved_forcing disables self-exclusion
    ignore = (None if cfg.memory_forcing == "retrieved_forcing"
              else batch.get("mips_ignore"))
    q = query_cls.detach()
    if isinstance(store.index, FlatIndex):
        scores, idx = flat_search(store.index, q, k=cfg.mips_topk, ignore=ignore, mesh=mesh)
    elif store.index.shards > 1:
        scores, idx = ivf_search_sharded(store.index, q, mesh, k=cfg.mips_topk,
                                         nprobe=store.nprobe, ignore=ignore,
                                         data_sharded=data_sharded)
    else:
        scores, idx = ivf_search(store.index, q, k=cfg.mips_topk, nprobe=store.nprobe,
                                 ignore=ignore, mesh=mesh, data_sharded=data_sharded)
    safe_idx = idx.clamp(min=0).long()
    return store.token_ids[safe_idx], store.token_mask[safe_idx], scores, idx


def _dual_slots(batch, ret_ids, ret_mask):
    """Dual memory: slot j holds input document min(j, D-1) where j <
    input_memory_count, else retrieved row max(j - count, 0) → (ids, mask
    [B, k, L])."""
    b, k = ret_ids.shape[:2]
    d_in = batch["input_memory_ids"].shape[1]
    count = batch["input_memory_count"][:, None].long()  # [B, 1]
    slot = torch.arange(k, device=count.device)[None, :]
    from_input = (slot < count)[..., None]
    rows = torch.arange(b, device=count.device)[:, None]
    in_slot = slot.clamp(max=d_in - 1).expand(b, k)
    ret_slot = (slot - count).clamp(min=0)
    ids = torch.where(from_input, batch["input_memory_ids"][rows, in_slot],
                      ret_ids[rows, ret_slot])
    mask = torch.where(from_input, batch["input_memory_mask"][rows, in_slot],
                       ret_mask[rows, ret_slot])
    return ids, mask


def rag_encode(
    params: RAG,
    cfg: RAGConfig,
    store: MemoryStore | None,
    batch: dict[str, Any],
    *,
    dtype=torch.float32,
    remat: bool | str = False,
    copy_force=None,
    mesh=None,
    data_sharded: bool = False,
) -> RAGEncoderOutput:
    """Retrieval + the main document encoder. batch keys: input_ids/
    attention_mask [B, S]; query_input_ids/query_attention_mask [B, Lq];
    optional mips_ignore [B, I] (self-exclusion corpus ids);
    target_memory_ids/mask [B, L_mem] (``target_only``, ``target_in``);
    input_memory_ids/mask [B, D, L_mem] and input_memory_count [B] (dual
    memory). ``copy_force`` (a bool, or a 0-d tensor) is the train step's
    copy-forcing flag of ``target_in``; None reads ``cfg.copy_forcing >
    0``. ``remat`` checkpoints every layer of every encoder.

    Over a ``mesh`` (`parallel.mesh`): the store's index is searched as it
    was placed (`_retrieve`), and with ``cfg.sequence_shard`` the LED
    encoder runs sequence-sharded over the ``shard`` axis. ``data_sharded``:
    the batch is this rank's rows of a batch split over ``data`` (an IVF
    search then decides its route and its probe union by the whole
    batch). The call is the program span ``encode`` (`obs.profiling.span`)."""
    with span("encode"):
        return _encode(params, cfg, store, batch, dtype, remat, copy_force, mesh,
                       data_sharded)


def _encode(params, cfg, store, batch, dtype, remat, copy_force, mesh, data_sharded):
    input_ids = batch["input_ids"]
    enc_mask = batch["attention_mask"]

    memory = memory_mask = memory_bias = copy_seq = None
    mips_scores = idx = faiss_scores = query_cls = None

    if not cfg.mips_disabled and store is not None:
        q_hidden = longformer_encode(
            params.query_encoder, cfg.query_enc, batch["query_input_ids"],
            batch["query_attention_mask"], dtype=dtype, remat=remat,
        )
        query_cls = q_hidden[:, 0].float()
        b = query_cls.shape[0]
        if cfg.memory_forcing == "target_only":
            # the gold target is the one memory slot; no search
            mem_ids = batch["target_memory_ids"][:, None]  # [B, 1, L]
            mem_mask = batch["target_memory_mask"][:, None]
        else:
            mem_ids, mem_mask, faiss_scores, idx = _retrieve(cfg, store, batch, query_cls,
                                                             mesh, data_sharded)
            if cfg.memory_forcing == "target_in":
                # the target slot comes first, masked off when the flag is off
                force = cfg.copy_forcing > 0.0 if copy_force is None else copy_force
                t_mask = batch["target_memory_mask"][:, None]
                t_mask = t_mask * torch.as_tensor(force, device=t_mask.device).to(t_mask.dtype)
                mem_ids = torch.cat([batch["target_memory_ids"][:, None], mem_ids], dim=1)
                mem_mask = torch.cat([t_mask, mem_mask], dim=1)
            elif "input_memory_ids" in batch:
                mem_ids, mem_mask = _dual_slots(batch, mem_ids, mem_mask)
        slots = mem_ids.shape[1]

        # cosine rescoring of the memory rows, with the norms' gradient
        # stopped (as the reference's)
        mips_hid = _encode_memory_rows(
            params.mips_encoder, cfg.mips_enc, mem_ids, mem_mask, dtype=dtype,
            remat=remat,
        )
        mips_cls = mips_hid[:, :, 0].float()  # [B, slots, H]
        raw = torch.einsum("bh,bsh->bs", query_cls, mips_cls)
        qn = torch.linalg.norm(query_cls, dim=-1, keepdim=True).detach()
        mn = torch.linalg.norm(mips_cls, dim=-1).detach()
        mips_scores = raw / torch.clamp(qn * mn, min=1e-12)

        if cfg.memory_model_fixed:
            mem_hid = mips_hid  # one shared re-encode serves both roles
        else:
            mem_hid = _encode_memory_rows(
                params.memory_encoder, cfg.memory_enc, mem_ids, mem_mask,
                dtype=dtype, remat=remat,
            )
        h = mem_hid.shape[-1]
        L = mem_ids.shape[-1]
        memory = mem_hid.reshape(b, slots * L, h)
        # bos/eos masked out of the copyable positions
        copy_ok = ((mem_ids != cfg.memory_enc.bos_id)
                   & (mem_ids != cfg.memory_enc.eos_id) & (mem_mask > 0))
        memory_mask = copy_ok.reshape(b, slots * L).to(torch.int32)
        memory_bias = mips_scores[:, :, None].expand(b, slots, L).reshape(b, slots * L)
        copy_seq = mem_ids.reshape(b, slots * L)

    # main document encoder: global attention on <s> and <DOC_SEP>
    global_mask = torch.zeros_like(input_ids)
    global_mask[:, 0] = 1
    global_mask = torch.where(input_ids == cfg.led.doc_sep_id,
                              torch.ones_like(global_mask), global_mask)
    enc_hidden = led_encode(params.led, cfg.led, input_ids, enc_mask, global_mask,
                            dtype=dtype, remat=remat,
                            seq_mesh=mesh if cfg.sequence_shard and mesh is not None
                            else None)
    return RAGEncoderOutput(
        enc_hidden=enc_hidden, enc_mask=enc_mask, memory=memory,
        memory_mask=memory_mask, memory_bias=memory_bias, copy_seq=copy_seq,
        mips_scores=mips_scores, retrieved_idx=idx, faiss_scores=faiss_scores,
        query_cls=query_cls,
    )


def rag_decode(
    params: RAG,
    cfg: RAGConfig,
    enc_out: RAGEncoderOutput,
    decoder_input_ids: torch.Tensor,  # [B, T]
    *,
    caches=None,
    pos_offset: int | torch.Tensor = 0,
    dtype=torch.float32,
    remat: bool | str = False,
    copy_kv=None,
):
    """Decoder + copy head → (log-probs or logits [B, T, V], aux, caches).
    With memory the output is the LOG-PROBS of the gated mixture; without,
    raw LM logits. Without ``caches`` the decoder runs teacher-forced."""
    hid, caches = led_decode(
        params.led, cfg.led, decoder_input_ids, enc_out.enc_hidden,
        enc_out.enc_mask, caches=caches, pos_offset=pos_offset, dtype=dtype,
        remat=remat,
    )
    aux: dict[str, Any] = {}
    if cfg.mips_disabled or enc_out.memory is None:
        return led_lm_logits(params.led, hid), aux, caches
    memory = enc_out.memory.to(hid.dtype)
    if cfg.use_own_decoder:
        gen_gate, copy_gate, copy_probs = copy_decoder_forward(
            params.copy_head, hid, memory, enc_out.memory_mask,
            enc_out.memory_bias, n_heads=cfg.copy_heads or cfg.led.n_heads,
            gates_mode=cfg.gates_mode, skip_residual=cfg.skip_residual,
            copy_kv=copy_kv,
        )
        lm_logits = led_lm_logits(params.led, hid)
        out = mix_copy_probs(lm_logits, gen_gate, copy_probs, enc_out.copy_seq)
        return out, {"copy_gate": copy_gate, "copy_probs": copy_probs}, caches
    out = copy_token_decoder_forward(
        params.copy_head, hid, memory, enc_out.memory_mask, enc_out.memory_bias,
        enc_out.copy_seq, params.led.shared_emb.table,
    )
    return out, aux, caches


def rag_forward(params: RAG, cfg: RAGConfig, store: MemoryStore | None,
                batch: dict[str, Any], *, dtype=torch.float32,
                remat: bool | str = False, copy_force=None, mesh=None,
                data_sharded: bool = False):
    """The full teacher-forced forward, with gradients → (out, aux,
    enc_out); ``mesh`` and ``data_sharded`` as in `rag_encode`."""
    enc_out = rag_encode(params, cfg, store, batch, dtype=dtype, remat=remat,
                         copy_force=copy_force, mesh=mesh, data_sharded=data_sharded)
    out, aux, _ = rag_decode(params, cfg, enc_out, batch["decoder_input_ids"],
                             dtype=dtype, remat=remat)
    return out, aux, enc_out
