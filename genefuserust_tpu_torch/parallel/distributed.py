"""Multi-process helpers on torch.distributed: the port's counterpart of
`genefuserust_tpu/parallel/distributed.py`.

The reference is a single-process tool; its scale-out analog (SURVEY §5,
"distributed communication backend") is, in the port:

  - DATA parallelism inside a process: `TorchEngine(devices=[...])` gives
    whole read batches to its devices in turn and needs no collective
    (parallel/engine.py). Across processes, each process feeds its own
    devices from its own FASTQ partition; the deterministic (read_break
    desc, len asc, name desc) sort of the match records makes the merged
    result independent of partition boundaries.
  - INDEX sharding: whole-genome panels split by contig over the 'shard'
    axis (parallel/sharded_index.py, `ShardedIndexEngine`).
  - 2D: both axes, a (data, shard) grid of the global devices.

Usage, one process per host (or per card):

    from genefuserust_tpu_torch.parallel import distributed
    distributed.init()                       # init_process_group, env:// defaults
    mesh = distributed.make_mesh(data_axis=..., shard_axis=...)

`init` is a no-op for one process, as `jax.distributed.initialize` is
skipped there. The backend is NCCL for CUDA devices and gloo for the CPU
unless given; a backend that was asked for is never swapped for another.
Held by a real two-process gloo run in tests/test_torch_distributed.py;
NCCL with two or more ranks needs two cards.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("genefuse")


def init(init_method: Optional[str] = None, world_size: Optional[int] = None,
         rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """torch.distributed.init_process_group with the environment's defaults
    (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) -> whether a
    process group was made. A no-op for one process: no `init_method` and
    a world size of 1 (given, or WORLD_SIZE unset). `backend` None: "nccl"
    when CUDA is available, else "gloo". Under NCCL the rank's card
    (LOCAL_RANK, else rank modulo the card count) becomes the current
    device."""
    env_ws = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and (world_size or env_ws) == 1:
        log.info("distributed init skipped (single process)")
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' requested but torch.cuda.is_available() is False")
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
    )
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    log.info("distributed: rank %d/%d, backend %s, %d local devices", dist.get_rank(),
             dist.get_world_size(), backend, len(local_devices()))
    return True


def local_devices() -> List[torch.device]:
    """This process's devices: every card for a single process, the rank's
    own card under NCCL (one process a card), the CPU otherwise."""
    multi = dist.is_initialized() and dist.get_world_size() > 1
    if not torch.cuda.is_available() or (multi and dist.get_backend() != "nccl"):
        return [torch.device("cpu")]
    if multi:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, shard) grid of the global devices: `ranks[d, s]` is the
    process that holds place (d, s) and `devices[d, s]` its device there
    (a name, as `str(torch.device)`)."""

    ranks: np.ndarray
    devices: np.ndarray
    axis_names: tuple = ("data", "shard")

    @property
    def shape(self):
        return self.ranks.shape


def make_mesh(data_axis: int = 0, shard_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """2D mesh over all global devices: ('data', 'shard'). data_axis=0
    means use all devices for data parallelism (shard dim 1). `devices`:
    this process's devices (default `local_devices()`; one may repeat),
    gathered from every rank in rank order when a process group exists."""
    mine = [str(torch.device(d)) for d in (devices if devices is not None
                                           else local_devices())]
    if dist.is_initialized():
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, mine)
    else:
        per_rank = [mine]
    ranks = np.array([r for r, ds in enumerate(per_rank) for _ in ds])
    devs = np.array([d for ds in per_rank for d in ds], dtype=object)
    n = len(ranks)
    if data_axis <= 0 and shard_axis <= 0:
        data_axis, shard_axis = n, 1
    elif data_axis <= 0:
        data_axis = n // shard_axis
    elif shard_axis <= 0:
        shard_axis = n // data_axis
    assert data_axis * shard_axis == n, (data_axis, shard_axis, n)
    return Mesh(ranks.reshape(data_axis, shard_axis), devs.reshape(data_axis, shard_axis))
