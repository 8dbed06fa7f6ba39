"""The benchmark of the PyTorch and CUDA port (`genefuserust_tpu_torch`).

One command runs one cell of BENCHMARK.json once:

    python3 -m gfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

See README.md beside this file.
"""
