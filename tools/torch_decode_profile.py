#!/usr/bin/env python3
"""One beam step of the port's `generate` at the rag_predict cell's shapes,
profiled with the operators' input shapes recorded, on any tree of the port.

    python3 tools/torch_decode_profile.py [--tree DIR] [--step 128] [--json FILE]

The led_base RAG (seeded random weights, bf16 compute, as the cell runs it)
decodes B = 256 papers with 4 beams for 256 tokens (min length 16, no
repeated 3-grams) from made-up encoder outputs of the cell's shapes:
sources of 2048 positions with lengths drawn like the cell's traffic
(`chip_smoke._source_lengths`), a memory of 2 x 512 rows (145 real in
each). `torch.profiler` records step
``--step`` (its decoder step and its search). Printed: the step's wall and
device time; the device time of each operator by input shapes (the kernels
it launched itself), largest first; and that time by class: operators over
the attention's K/V ([B, nh, S, dh], the cache [B', nh, Tmax, dh], their
logits), operators over the vocabulary ([*, V], [B, beams x V]), the
cached-attention kernel, matrix products, the rest. ``--tree`` puts that
tree's port first on ``sys.path`` (a parent checkout, say), so two trees
compare on one card. Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, BEAMS, SRC, NH, MEM_SLOT, MEM_REAL = 256, 4, 2048, 12, 512, 145


def shape_class(name: str, shapes, vocab: int, t_max: int) -> str:
    if "flash_decode" in name:
        return "decode kernel"
    dims = [tuple(s) for s in shapes if s]
    if any(len(s) >= 3 and s[1] == NH and (SRC in s or t_max in s) for s in dims):
        return "attention K/V and logits"
    if any(vocab in s or BEAMS * vocab in s for s in dims):
        return "vocabulary"
    if name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul", "aten::linear"):
        return "products"
    return "rest"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--step", type=int, default=128)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    # the traffic's source lengths, drawn by the chip_smoke.py beside this tool
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import retrieval_augmented_mds_tpu_torch as port
    from retrieval_augmented_mds_tpu_torch import cli
    from retrieval_augmented_mds_tpu_torch.models.generate import (
        copy_head_kv,
        decode_step,
        generate,
    )
    from retrieval_augmented_mds_tpu_torch.models.retriever_generator import (
        RAGEncoderOutput,
        init_rag,
    )
    from retrieval_augmented_mds_tpu_torch.utils.config import config_from_dict

    if not torch.cuda.is_available():
        sys.exit("torch_decode_profile: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    cfg = config_from_dict({
        "model": {"preset": "led_base", "mips_topk": 2, "memory_len": MEM_SLOT},
        "data": {"source": "synthetic", "max_length": SRC, "decoder_max_length": 256,
                 "memory_len": MEM_SLOT, "batch_size": B},
        "precision": "bfloat16",
        "generation": {"max_new_tokens": 256, "min_length": 16, "num_beams": BEAMS,
                       "no_repeat_ngram_size": 3, "early_stopping": False,
                       "repetition_penalty": 1.0, "length_penalty": 1.0},
    })
    dtype, dev = cli.compute_dtype(cfg), torch.device("cuda")
    gen = cfg.generation
    t_max = gen.max_new_tokens + 1
    params = init_rag(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    lengths = smoke._source_lengths(rng, B, SRC)
    g = torch.Generator(device=dev).manual_seed(1)
    h = cfg.model.led.d_model
    m = cfg.model.mips_topk * MEM_SLOT
    slot = torch.arange(m, device=dev) % MEM_SLOT
    enc = RAGEncoderOutput(
        enc_hidden=torch.randn((B, SRC, h), generator=g, device=dev).to(dtype),
        enc_mask=(torch.arange(SRC, device=dev)[None, :]
                  < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32),
        memory=torch.randn((B, m, h), generator=g, device=dev).to(dtype),
        memory_mask=(slot < MEM_REAL).to(torch.int32)[None, :].expand(B, m).contiguous(),
        memory_bias=torch.rand((B, m), generator=g, device=dev),
        copy_seq=torch.randint(4, 50000, (B, m), generator=g, device=dev, dtype=torch.int32),
        mips_scores=None, retrieved_idx=None)
    inner = decode_step(params, cfg.model, dtype, copy_head_kv(params, cfg.model, enc, dtype))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    clock = {}
    calls, armed = [0], [False]

    def step(*a):
        t = calls[0]
        calls[0] += 1
        if armed[0] and t in (args.step, args.step + 1):
            torch.cuda.synchronize()
            clock[t] = time.perf_counter()
            (prof.start if t == args.step else prof.stop)()
        return inner(*a)

    generate(params, cfg.model, enc, gen, dtype=dtype, step=step)  # warms every shape
    calls[0], armed[0] = 0, True
    t0 = time.perf_counter()
    generate(params, cfg.model, enc, gen, dtype=dtype, step=step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    wall = (clock[args.step + 1] - clock[args.step]) * 1e3
    vocab = cfg.model.led.vocab_size
    rows, by_class = [], {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        cls = shape_class(e.key, e.input_shapes, vocab, t_max)
        rows.append((ms, e.key, e.count, str(e.input_shapes)[:150], cls))
        by_class[cls] = by_class.get(cls, 0.0) + ms
    kernels = sorted(((e.self_device_time_total / 1e3, e.key[:90], e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and not e.is_user_annotation),  # the program's spans are ranges
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(f"[decode_profile] tree {args.tree} (port {os.path.dirname(port.__file__)}); "
          f"{smi.strip()}")
    print(f"[decode_profile] B={B} beams={BEAMS} S={SRC} (source lengths mean "
          f"{np.mean(lengths):.1f}) memory {m} vocab {vocab}: generate {total:.3f} s for "
          f"{gen.max_new_tokens} steps ({total / gen.max_new_tokens * 1e3:.2f} ms a step); "
          f"step {args.step} profiled: wall {wall:.2f} ms, device {busy:.2f} ms")
    print("[decode_profile] device ms by class: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))
    print("[decode_profile] kernels (ms, count): " + "; ".join(
        f"{name} {ms:.3f} x{n}" for ms, name, n in kernels[:12]))
    for ms, name, n, shapes, cls in sorted(rows, reverse=True)[:40]:
        print(f"[decode_profile]   {ms:8.3f} ms  x{n:<4d} {name:28s} [{cls}] {shapes}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tree": args.tree, "wall_ms": wall, "device_ms": busy,
                       "step_ms": total / gen.max_new_tokens * 1e3, "by_class": by_class,
                       "rows": rows, "kernels": kernels}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
