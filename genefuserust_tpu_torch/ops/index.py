"""Panel index tables as torch tensors.

The JAX package builds its device tables on the host with numpy
(`genefuserust_tpu.ops.hashtable`); this module carries those arrays over
unchanged and records the static parameters the probe needs. Two layouts
reach the scan:

  - kv rows (`PackedIndexKV`): `kv_tbl (nb, 2S) int32`, S [key | payload]
    slots per bucket — kv2 (S=1, the product layout), kv4 (S=2), kv8
    (S=4). Dupe rows are 8 packed payloads.
  - split (`PackedIndex`): `keys_tbl (nb, 8)` + `vals_tbl (nb*8, 2)`,
    used when a panel exceeds the packed-payload bit budget. Dupe rows are
    `(D, 2)` [contig, pos] pairs.

The single-probe A/B layouts (kvs, kv16) are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TorchIndex:
    """Device tables plus the static parameters of one packed panel index.

    `D` is the candidate width after dupe expansion: 1 when the panel has
    no dupe table to expand (the JAX `max_dupe <= 1` branch), else
    `max_dupe` (kv) or the dupe row width (split)."""

    split: bool
    table: torch.Tensor  # kv: (nb, 2S) rows; split: (nb, 8) keys
    vals: torch.Tensor  # split: (nb*8, 2) [contig, pos]; kv: (0, 2)
    dupes: torch.Tensor  # kv: (nd, 8) payloads; split: (nd, D, 2)
    shift: int
    max_dupe: int
    cbits: int
    pos_bias: int
    S: int  # slots per table row
    D: int


def index_to_torch(packed, device) -> TorchIndex:
    """`PackedIndex` / `PackedIndexKV` -> `TorchIndex` on `device`."""
    device = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    if hasattr(packed, "kv_tbl"):
        if getattr(packed, "single_probe", False) or packed.kv_tbl.shape[1] == 16:
            raise NotImplementedError(
                "the kvs and kv16 single-probe table layouts are not ported; "
                "use kv2, kv4, kv8 or split"
            )
        S = packed.kv_tbl.shape[1] // 2
        nd = packed.dupes.shape[0]
        D = 1 if packed.max_dupe <= 1 or nd == 0 else packed.max_dupe
        return TorchIndex(
            split=False, table=put(packed.kv_tbl),
            vals=torch.zeros((0, 2), dtype=torch.int32, device=device),
            dupes=put(packed.dupes), shift=packed.shift,
            max_dupe=packed.max_dupe, cbits=packed.cbits,
            pos_bias=packed.pos_bias, S=S, D=D,
        )
    nd = packed.dupes.shape[0]
    D = 1 if packed.max_dupe <= 1 or nd == 0 else packed.dupes.shape[1]
    return TorchIndex(
        split=True, table=put(packed.keys_tbl), vals=put(packed.vals_tbl),
        dupes=put(packed.dupes), shift=packed.shift, max_dupe=packed.max_dupe,
        cbits=0, pos_bias=0, S=packed.keys_tbl.shape[1], D=D,
    )
