"""The serving step as two `torch.export` programs: export, save, load, serve.

Counterpart of the JAX package's ``cli.run_export``, which exports one
function, ``serve(params, store_leaves, batch) → ids``, whose ``lax`` loops
keep the whole beam search inside the artifact. ``torch.export`` unrolls a
Python loop instead (at led_base, 256 steps of ~800 nodes each), so the
port's artifact holds two programs. As in the JAX package, the weights and
the index are inputs, so a checkpoint or an index refresh does not
re-export:

* ``serve_encode.pt2``: (param leaves, store leaves, batch) → the leaves of
  `RAGEncoderOutput`: query encode → MIPS → memory re-encode → rescore →
  LED encode. On the card it runs kernel K2, and K1 and K8 on an IVF store,
  each through its custom op (``ramds::*``);
* ``serve_decode_step.pt2``: (param leaves, encoder-output leaves, copy-KV
  leaves, cache leaves, token ids [B·beams], pos) → (log-probs
  [B·beams, V], the caches' new k/v). ``pos`` is a 0-d int64 tensor, so
  the one program serves every position. On the card its decoder layers'
  self- and cross-attention run the cached step's kernel through
  ``ramds::flash_decode``;
* ``serve_step.json``: the manifest (the JAX package's keys, as far as they
  apply), and ``serve_config.yaml``: the resolved config, which the decode
  loop reads.

`serve` runs the encode program, then the greedy, beam or sampled loop of
`models.generate` with the loaded step in place of
`generate.decode_step`; its ids equal ``generate(rag_encode(...))``. Shapes
are fixed to the config's serving shapes, as in the JAX package. Params and
store go in as tensor leaves (the params through
``torch.func.functional_call``); the store's ints (cluster count, sizes,
metric, probe width) stay static, as the JAX treedef keeps them, and
`serve` refuses a store whose static part differs from the exported one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import torch

from .cli import compute_dtype
from .index.flat import FlatIndex
from .index.ivf import IVFIndex
from .models.retriever_generator import MemoryStore

ENCODE = "serve_encode.pt2"
DECODE_STEP = "serve_decode_step.pt2"
MANIFEST = "serve_step.json"
CONFIG = "serve_config.yaml"
# each decoder layer's cache in a program's leaves: self-attention k, v;
# the cross-attention heads ck, cv
CACHE_KEYS = ("k", "v", "ck", "cv")
_STORE_TYPES = {c.__name__: c for c in (MemoryStore, FlatIndex, IVFIndex)}


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def store_leaves(store: MemoryStore | None) -> tuple[Any, tuple[torch.Tensor, ...]]:
    """The store as (its static part, a JSON-able tree; its tensors in field
    order). None → (None, ())."""
    leaves: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return "tensor"
        if dataclasses.is_dataclass(x):
            return {"type": type(x).__name__,
                    "fields": {f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)}}
        return {"const": x}

    return (None if store is None else walk(store)), tuple(leaves)


def store_from_leaves(spec, leaves) -> MemoryStore | None:
    """Inverse of `store_leaves`."""
    it = iter(leaves)

    def build(s):
        if s == "tensor":
            return next(it)
        if "const" in s:
            return s["const"]
        return _STORE_TYPES[s["type"]](**{k: build(v) for k, v in s["fields"].items()})

    return None if spec is None else build(spec)


def signature_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The batch as the programs take it: without ``labels`` (train only),
    keys sorted (a program's input spec holds the keys' order)."""
    return {k: batch[k] for k in sorted(batch) if k != "labels"}


def param_leaves(params: torch.nn.Module) -> tuple[torch.Tensor, ...]:
    """The parameters in ``named_parameters`` order, detached."""
    return tuple(p.detach() for p in params.parameters())


def cache_leaves(caches: list[dict]) -> tuple[torch.Tensor, ...]:
    return tuple(c[key] for c in caches for key in CACHE_KEYS)


class _Program(torch.nn.Module):
    """A function as a module with no parameters of its own, the form
    `torch.export.export` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _with_param_leaves(params: torch.nn.Module, fn: Callable) -> Callable:
    """``fn(params, *args)`` as ``g(param leaves, *args)``: the leaves stand
    in for the parameters (``functional_call``), so that they are inputs of
    an exported program and not constants in it."""
    bound = _Program(lambda *args: fn(params, *args))
    bound.params = params
    names = [f"params.{n}" for n, _ in params.named_parameters()]

    def g(leaves, *args):
        return torch.func.functional_call(bound, dict(zip(names, leaves)), args)

    return g


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def export_serving(params, cfg, store: MemoryStore | None, batch: dict[str, torch.Tensor],
                   out_dir: str) -> dict[str, Any]:
    """Export the two programs at ``batch``'s shapes (its ``labels`` left
    out), save them with the manifest and the config under ``out_dir`` →
    the manifest. Runs the encode program once, for the decode step's
    example inputs."""
    from .models.generate import copy_head_kv, decode_step, init_caches
    from .models.retriever_generator import (
        copy_kv_from_leaves,
        copy_kv_leaves,
        encoder_output_from_leaves,
        encoder_output_leaves,
        rag_encode,
    )
    from .utils.config import save_config

    model, gen, dtype = cfg.model, cfg.generation, compute_dtype(cfg)
    batch = signature_batch(batch)
    spec, s_leaves = store_leaves(store)
    p_leaves = param_leaves(params)
    fields: list[str] = []

    def encode(params, s_leaves, batch):
        enc = rag_encode(params, model, store_from_leaves(spec, s_leaves), batch, dtype=dtype)
        names, leaves = encoder_output_leaves(enc)
        fields[:] = names
        return leaves

    def step(params, e_leaves, kv_leaves, c_leaves, tok, pos):
        enc = encoder_output_from_leaves(fields, e_leaves)
        caches = [dict(zip(CACHE_KEYS, c_leaves[i:i + len(CACHE_KEYS)]), pos=pos)
                  for i in range(0, len(c_leaves), len(CACHE_KEYS))]
        fn = decode_step(params, model, dtype, copy_kv_from_leaves(kv_leaves))
        logp, caches = fn(enc, tok, caches, pos)
        return logp, tuple(t for c in caches for t in (c["k"], c["v"]))

    with torch.no_grad():
        enc_ep = torch.export.export(_Program(_with_param_leaves(params, encode)),
                                     (p_leaves, s_leaves, batch))
        enc = encoder_output_from_leaves(fields, enc_ep.module()(p_leaves, s_leaves, batch))
        dev = enc.enc_hidden.device
        rows = enc.enc_hidden.shape[0] * max(1, gen.num_beams)
        caches = init_caches(params, model, rows, gen.max_new_tokens + 1, dtype,
                             enc.enc_hidden)
        tok = torch.full((rows,), gen.decoder_start_id, dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        step_args = (p_leaves, encoder_output_leaves(enc)[1],
                     copy_kv_leaves(copy_head_kv(params, model, enc, dtype)),
                     cache_leaves(caches), tok, pos)
        step_ep = torch.export.export(_Program(_with_param_leaves(params, step)), step_args)

    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, ENCODE), os.path.join(out_dir, DECODE_STEP)]
    for ep, path in zip((enc_ep, step_ep), paths):
        ep.example_inputs = None  # the weights and the store: not part of the artifact
        torch.export.save(ep, path)
    save_config(cfg, os.path.join(out_dir, CONFIG))
    manifest = {
        "artifact": paths,
        "bytes": sum(os.path.getsize(p) for p in paths),
        "platforms": [dev.type],
        "args": {
            "encode": "(param leaves, store leaves, batch) -> encoder-output leaves",
            "decode_step": "(param leaves, encoder-output leaves, copy-KV leaves, cache "
                           f"leaves {'/'.join(CACHE_KEYS)} per decoder layer, token ids "
                           "[B*beams], pos 0-d int64) -> (log-probs [B*beams, V], "
                           "cache k/v per decoder layer)",
        },
        "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
        "compute_dtype": cfg.precision,
        "num_beams": gen.num_beams,
        "max_new_tokens": gen.max_new_tokens,
        "config": os.path.join(out_dir, CONFIG),
        "store": spec,
        "encoder_output": list(fields),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# load and serve
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingArtifact:
    """A loaded artifact: its manifest, its config, its two programs (each
    ``ExportedProgram.module()``, which checks every input against the
    exported shapes and types before it runs), and the decode-step
    program's graph alone (``step_graph``: flat inputs in, flat outputs
    out, no checks)."""

    manifest: dict[str, Any]
    cfg: Any  # utils.config.ExperimentConfig
    encode: Callable
    step: Callable
    step_graph: Callable


def load_serving(out_dir: str) -> ServingArtifact:
    """Load an artifact that `export_serving` wrote. Imports the modules
    that register the kernels' custom ops first."""
    from .index import ivf_serving  # noqa: F401  (ramds::ivf_probe_topk)
    from .ops import flash_decode, flash_sliding, mips_topk  # noqa: F401  (ramds::flash_decode,
    # ::flash_sliding_fwd, ::mips_topk)
    from .utils.config import load_config

    from torch.export.graph_signature import InputKind, OutputKind

    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    step = torch.export.load(os.path.join(out_dir, DECODE_STEP))
    sig = step.graph_signature
    # the graph alone takes the user inputs and nothing lifted (no weights,
    # buffers or constants) and returns the user outputs, flat
    if ({s.kind for s in sig.input_specs} != {InputKind.USER_INPUT}
            or {s.kind for s in sig.output_specs} != {OutputKind.USER_OUTPUT}):
        raise ValueError(f"{DECODE_STEP} lifts more than user inputs and outputs: {sig}")
    return ServingArtifact(
        manifest=manifest, cfg=load_config(os.path.join(out_dir, CONFIG)),
        encode=torch.export.load(os.path.join(out_dir, ENCODE)).module(),
        step=step.module(), step_graph=step.graph_module)


def serve_encode(art: ServingArtifact, params, store: MemoryStore | None,
                 batch: dict[str, torch.Tensor]):
    """The encode program on these params, store and batch → a
    `RAGEncoderOutput`. Raises when the store's static part is not the
    exported one."""
    from .models.retriever_generator import encoder_output_from_leaves

    spec, s_leaves = store_leaves(store)
    if spec != art.manifest["store"]:
        raise ValueError(f"the store {spec} is not the one the artifact was exported "
                         f"with: {art.manifest['store']}")
    with torch.no_grad():
        leaves = art.encode(param_leaves(params), s_leaves, signature_batch(batch))
    return encoder_output_from_leaves(art.manifest["encoder_output"], leaves)


def loaded_step(art: ServingArtifact, params, copy_kv) -> Callable:
    """The decode-step program as `generate`'s ``step``: the caches' k/v are
    replaced by the program's and their ``pos`` advanced. The first call
    goes through the checked module; the later ones call the graph alone,
    since their inputs keep the shapes and types that check accepted (the
    same params, encoder output and copy K/V, the caches the program
    returned, a token per row, a 0-d position). The check walks every one
    of the ~1,100 parameter leaves at led_base, a cost the size of the
    step's own host work."""
    from .models.retriever_generator import copy_kv_leaves, encoder_output_leaves

    p_leaves, kv = param_leaves(params), copy_kv_leaves(copy_kv)
    checked = []

    def step(enc_out, tok, caches, pos):
        e_leaves, c_leaves = encoder_output_leaves(enc_out)[1], cache_leaves(caches)
        if checked:
            logp, *new = art.step_graph(*p_leaves, *e_leaves, *kv, *c_leaves, tok, pos)
        else:
            logp, new = art.step(p_leaves, e_leaves, kv, c_leaves, tok, pos)
            checked.append(True)
        for c, k, v in zip(caches, new[0::2], new[1::2]):
            c["k"], c["v"], c["pos"] = k, v, pos + 1
        return logp, caches

    return step


def serve(art: ServingArtifact, params, store: MemoryStore | None,
          batch: dict[str, torch.Tensor], *,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """Generated ids [B, max_new_tokens] from a loaded artifact: the encode
    program, then `generate`'s loop (greedy, beam or sampled, as the
    config's ``generation`` says) over the decode-step program."""
    from .models.generate import copy_head_kv, generate

    cfg = art.cfg
    dtype = compute_dtype(cfg)
    enc = serve_encode(art, params, store, batch)
    with torch.no_grad():
        step = loaded_step(art, params, copy_head_kv(params, cfg.model, enc, dtype))
    return generate(params, cfg.model, enc, cfg.generation, dtype=dtype,
                    generator=generator, step=step)
