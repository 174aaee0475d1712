"""retrieval_augmented_mds_tpu_torch — the PyTorch/CUDA port.

The JAX package ``retrieval_augmented_mds_tpu`` is the reference; this
package mirrors its module paths, so every module's counterpart has the
same name. Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
PyTorch version that CPU tensors take.

Layout:
  ops/       CUDA kernel wrappers (MIPS top-k, sliding-window attention)
  csrc/      the CUDA C++ sources, built with nvcc at first use
  index/     the flat MIPS index and its persistence
  models/    Longformer, LED, copy heads, the RAG model, generation
  train/     corpus embedding and memory-store build
  utils/     the YAML config system
  bridge.py  JAX param trees → the port's modules
  cli.py     `predict`
"""
