"""Host-side read checks and the device-side unpack of 2-bit code rows
(port of `ops/pack.py`: `has_exotic` and `unpack_seq2_jnp`)."""

from __future__ import annotations

import numpy as np
import torch

OK_BYTES = frozenset(b"ACGTNacgtn")


def has_exotic(seq_rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(B,) bool: any byte outside ACGTNacgtn within the read span."""
    B, L = seq_rows.shape
    lut = np.ones(256, bool)
    for ch in OK_BYTES:
        lut[ch] = False
    bad = lut[seq_rows]
    idx = np.arange(L)[None, :] < lens[:, None]
    return (bad & idx).any(axis=1)


def unpack_seq2(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/4)) uint8 of 2-bit codes (LSB first) -> (B, L) uint8 codes
    0..3. Non-ACGT positions travel separately as [row, col] exception
    lists and are set to 255 by the caller."""
    parts = [(packed >> s) & 3 for s in (0, 2, 4, 6)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[0], 4 * packed.shape[1])[:, :L]
