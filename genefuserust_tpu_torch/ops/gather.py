"""Per-row column gathers and shifts (port of `ops/gather.py`).

The JAX package composes the shifts from log2(L) static-slice shifts,
because per-element gathers were slow on the TPU. Here each is one
`torch.gather`; the results are the same. No path of the port launches
them on the card.
"""

from __future__ import annotations

import torch


def row_take(arr2d: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """(B, L) array, (B, K) column indices -> (B, K) values
    arr2d[b, clip(col_idx[b, k], 0, L-1)]."""
    L = arr2d.shape[1]
    return arr2d.gather(1, col_idx.long().clamp(0, L - 1))


def _shifted(arr2d: torch.Tensor, src: torch.Tensor, fill) -> torch.Tensor:
    L = arr2d.shape[1]
    got = arr2d.gather(1, src.clamp(0, L - 1))
    return torch.where((src >= 0) & (src < L), got, torch.full_like(got, fill))


def row_shift_right(arr2d: torch.Tensor, shift: torch.Tensor, fill) -> torch.Tensor:
    """Per-row right shift: out[b, j] = arr2d[b, j - shift[b]] for
    j >= shift[b], else `fill`. shift in [0, L]."""
    j = torch.arange(arr2d.shape[1], device=arr2d.device)
    return _shifted(arr2d, j[None, :] - shift.long()[:, None], fill)


def row_shift_left(arr2d: torch.Tensor, shift: torch.Tensor, fill) -> torch.Tensor:
    """Per-row left shift: out[b, j] = arr2d[b, j + shift[b]] for
    j + shift[b] < L, else `fill`. shift in [0, L]."""
    j = torch.arange(arr2d.shape[1], device=arr2d.device)
    return _shifted(arr2d, j[None, :] + shift.long()[:, None], fill)
