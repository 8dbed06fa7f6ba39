"""Device lists for the multi-device paths: the port's counterpart of a mesh.

`genefuserust_tpu/parallel/mesh.py::make_mesh` builds a 1-D JAX `Mesh`; the
port's multi-device code takes a plain list of torch devices instead: one
per shard (`ShardedIndexEngine`) or one per data-parallel entry
(`TorchEngine(devices=...)`, whole batches in turn). A list may name one
device more than once: S shard tables, or n entries with their own
streams, then sit on that one device, which is how the tests and
`chip_smoke.py` run several shards or entries on one card.

`resolve_mesh` is the CLI's `--mesh` resolution of the JAX driver
(`genefuserust_tpu/driver.py::_resolve_mesh`): 'auto' gives one entry per
available device, '' and '1' one entry, 'N' the first N devices, and N
above the device count exits with the JAX driver's message.
"""

from __future__ import annotations

from typing import List

import torch


def resolve_mesh(spec: str, device="cuda") -> List[torch.device]:
    """--mesh value -> the devices, one per shard or entry, of `device`'s
    type: the CUDA devices, or the one CPU."""
    kind = torch.device(device).type
    available = torch.cuda.device_count() if kind == "cuda" else 1
    if spec in ("", "1"):
        n = 1
    elif spec == "auto":
        n = available
    else:
        n = int(spec)
        if n > available:
            print(f"ERROR: --mesh {n} requested but only {available} "
                  "devices are available, quit now")
            raise SystemExit(-1)
    n = max(1, n)
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device(kind, i) for i in range(n)]
