"""genefuserust_tpu_torch — the gene-fusion scan on PyTorch and CUDA.

A port of `genefuserust_tpu` (JAX on a TPU) to one NVIDIA H100. The host
modules that use no JAX (config, core, io, models, report, native,
utils/synthetic, the numpy index builders) are imported from
`genefuserust_tpu`; this package holds the device path: the index tables
as tensors (ops/index.py), the two-pass scan with its plain PyTorch
versions and CUDA kernel wrappers (ops/map_read.py, ops/fused.py, csrc/),
the batch engine (parallel/engine.py), and the driver and CLI.

It imports torch and never jax.
"""
