"""Sequence primitives: reverse complement, complexity, tokenization.

Reproduces (reference: src/core/sequence.rs:22-60) — complement maps
A/a->T, T/t->A, C/c->G, G/g->C, anything else -> 'N' — and
(reference: src/utils/mod.rs:48-56) `dis_connected_count`.

Also defines the byte<->code tokenization used by the device kernels:
A=0, T=1, C=2, G=3 (reference base map: src/core/indexer.rs:887-904),
everything else = INVALID_CODE.
"""

from __future__ import annotations

import numpy as np

# 2-bit base codes (reference: src/core/indexer.rs:887-904).
BASE_A, BASE_T, BASE_C, BASE_G = 0, 1, 2, 3
INVALID_CODE = 255

_COMPLEMENT_TABLE = bytes.maketrans(
    b"AaTtCcGg" + bytes(ch for ch in range(256) if ch not in b"AaTtCcGg"),
    b"TTAAGGCC" + b"N" * (256 - 8),
)

# byte -> 2-bit code (uppercase only, as in the reference encoders)
BASE_CODE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
BASE_CODE_LUT[ord("A")] = BASE_A
BASE_CODE_LUT[ord("T")] = BASE_T
BASE_CODE_LUT[ord("C")] = BASE_C
BASE_CODE_LUT[ord("G")] = BASE_G

# byte -> complement byte, as uint8 LUT (for array paths)
COMPLEMENT_LUT = np.frombuffer(_COMPLEMENT_TABLE, dtype=np.uint8).copy()


def reverse_complement(seq: str) -> str:
    """Reverse complement of a sequence string.

    reference: src/core/sequence.rs:22-50 (case-insensitive input, uppercase
    output, non-ACGT bases -> 'N').
    """
    return seq.encode("latin-1").translate(_COMPLEMENT_TABLE)[::-1].decode("latin-1")


def reverse_complement_bytes(seq: np.ndarray) -> np.ndarray:
    """Vectorized reverse complement over a uint8 byte array."""
    return COMPLEMENT_LUT[seq][::-1]


def dis_connected_count(s: str) -> int:
    """Count of adjacent differing characters — low-complexity proxy.

    reference: src/utils/mod.rs:48-56. Caller must guarantee len(s) >= 1
    (the reference would panic on an empty string).
    """
    if len(s) == 0:
        raise ValueError("dis_connected_count on empty string (reference panics)")
    b = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
    return int(np.count_nonzero(b[:-1] != b[1:]))


def encode_bases(seq: bytes | str) -> np.ndarray:
    """Raw sequence bytes -> 2-bit codes (INVALID_CODE for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    return BASE_CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
