"""Compact host->device encodings and their device-side unpacks (port of
`ops/pack.py`).

Per base the device merge needs (a) a 4-bit sequence code that preserves
byte equality over the ACGTNacgtn alphabet (the merge compares raw bytes;
any other byte is code 15, so two such bytes compare equal here) and (b)
a 2-bit quality class {low <= Q15, mid, high >= Q30}, which is all the
merge's accept, diff and pick logic tests. Sequences pack 2 bases a byte,
quality classes 4 a byte. The main path's lanes carry 2-bit map codes
(`unpack_seq2`); the device merge's upload carries the 4-bit codes and the
classes (`pack_seq4`, `pack_q2`; `native.pack_pe_batch` writes the same
layout on the host).
"""

from __future__ import annotations

import numpy as np
import torch

# 4-bit sequence codes: 0..3 = ACGT (match BASE codes A=0,T=1,C=2,G=3),
# 4 = N, 5..8 = acgt, 9 = n, 15 = other
SEQ4_LUT = np.full(256, 15, np.uint8)
for i, ch in enumerate(b"ATCG"):
    SEQ4_LUT[ch] = i
SEQ4_LUT[ord("N")] = 4
for i, ch in enumerate(b"atcg"):
    SEQ4_LUT[ch] = 5 + i
SEQ4_LUT[ord("n")] = 9

# 4-bit code -> 2-bit map code (uppercase ACGT only, else invalid=255)
MAP_FROM_SEQ4 = np.full(16, 255, np.uint8)
for c in range(4):
    MAP_FROM_SEQ4[c] = c

# 4-bit complement (reference complement table: A<->T, C<->G, case-insensitive
# input, non-ACGT -> 'N'; sequence.rs:52-59). Output is always uppercase.
COMP4 = np.full(16, 4, np.uint8)  # default N
COMP4[0], COMP4[1], COMP4[2], COMP4[3] = 1, 0, 3, 2  # A<->T, C<->G
COMP4[5], COMP4[6], COMP4[7], COMP4[8] = 1, 0, 3, 2  # a,t,c,g likewise

_Q30 = ord("?")
_Q15 = ord("0")

OK_BYTES = frozenset(b"ACGTNacgtn")


def lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a numpy uint8 table, on idx's device."""
    return torch.from_numpy(table).to(idx.device)[idx.long()]


def has_exotic(seq_rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(B,) bool: any byte outside ACGTNacgtn within the read span."""
    B, L = seq_rows.shape
    bad_lut = np.ones(256, bool)
    for ch in OK_BYTES:
        bad_lut[ch] = False
    bad = bad_lut[seq_rows]
    idx = np.arange(L)[None, :] < lens[:, None]
    return (bad & idx).any(axis=1)


def qual_class(q: torch.Tensor) -> torch.Tensor:
    """uint8 quality bytes -> {0=low(<=Q15), 1=mid, 2=high(>=Q30)}."""
    return torch.where(q >= _Q30, 2, torch.where(q <= _Q15, 0, 1)).to(torch.uint8)


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[1]) % mult
    if not pad:
        return x
    return torch.cat([x, torch.zeros((x.shape[0], pad), dtype=x.dtype, device=x.device)], 1)


def pack_seq4(codes4: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 4-bit values -> (B, ceil(L/2)) bytes (low nibble first)."""
    c = _pad_cols(codes4, 2)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def pack_q2(classes: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 2-bit values -> (B, ceil(L/4)) bytes (low bits first)."""
    c = _pad_cols(classes, 4)
    return c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)


def _unpack(packed: torch.Tensor, bits: int, L: int) -> torch.Tensor:
    mask = (1 << bits) - 1
    parts = [(packed >> s) & mask for s in range(0, 8, bits)]
    B, W = packed.shape
    return torch.stack(parts, dim=-1).reshape(B, len(parts) * W)[:, :L]


def unpack_seq2(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/4)) uint8 of 2-bit codes (LSB first) -> (B, L) uint8 codes
    0..3. Non-ACGT positions travel separately as [row, col] exception
    lists and are set to 255 by the caller."""
    return _unpack(packed, 2, L)


def unpack_seq4(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/2)) uint8 -> (B, L) uint8 4-bit codes (`unpack_seq4_jnp`)."""
    return _unpack(packed, 4, L)


def unpack_q2(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/4)) uint8 -> (B, L) uint8 quality classes (`unpack_q2_jnp`)."""
    return _unpack(packed, 2, L)
