"""genefuserust_tpu_torch — the gene-fusion scan on PyTorch and CUDA.

A port of `genefuserust_tpu` (JAX on a TPU) to one NVIDIA H100. The
package stands alone: it keeps its own copies of the host modules (config,
core, io, models, report, utils, native with native/gfnative.cpp, and the
numpy table placement of ops/hashtable.py), under the reference's module
names. Beside them it holds the device path: the index tables as tensors
(ops/index.py), the two-pass scan with its plain PyTorch versions and CUDA
kernel wrappers (ops/map_read.py, ops/fused.py, csrc/), the batch engine
(parallel/engine.py), and the driver and CLI.

It imports torch and numpy, never jax, and nothing of `genefuserust_tpu`.
"""
