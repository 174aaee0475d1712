"""retrieval_augmented_mds_tpu_torch — the PyTorch/CUDA port.

The JAX package ``retrieval_augmented_mds_tpu`` is the reference; this
package mirrors its module paths, so every module's counterpart has the
same name. Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
PyTorch version that CPU tensors take.

Layout:
  ops/       CUDA kernel wrappers (MIPS top-k, sliding-window and dense
             attention, the 8-bit AdamW update)
  csrc/      the CUDA C++ sources, built with nvcc at first use
  index/     the flat and IVF MIPS indexes (the IVF probe kernel's wrapper
             in index/ivf_serving.py), their files and the factory
  models/    Longformer, LED, copy heads, the RAG model, generation
  train/     loss, optimizers (AdamW, 8-bit AdamW), train step, corpus
             embedding and store build
  data/      corpus, tokenizer and batch pipeline (pandas)
  eval/      ROUGE
  obs/       the JSONL metrics logger
  utils/     the YAML config system, checkpoints
  bridge.py  JAX param trees and indexes → the port's modules and indexes
  cli.py     fit, validate, test, predict, build-index, bench-index
"""
