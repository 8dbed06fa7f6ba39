"""2-bit code rows -> per-base codes (port of `ops/pack.py::unpack_seq2_jnp`)."""

from __future__ import annotations

import torch


def unpack_seq2(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/4)) uint8 of 2-bit codes (LSB first) -> (B, L) uint8 codes
    0..3. Non-ACGT positions travel separately as [row, col] exception
    lists and are set to 255 by the caller."""
    parts = [(packed >> s) & 3 for s in (0, 2, 4, 6)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[0], -1)[:, :L]
