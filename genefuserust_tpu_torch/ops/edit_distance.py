"""Batched Myers bit-parallel edit distance on torch tensors.

Port of `genefuserust_tpu/ops/edit_distance.py` (itself the device
counterpart of `core/edit_distance.py`, reference edit_distance.rs:12-92).
Patterns are W little-endian 32-bit bit-plane words; sequences are codes
of the 11-symbol alphabet A,C,G,T,N,a,c,g,t,n + "other". Two distinct
"other" bytes would compare equal, so callers route such jobs to the host
(`parallel/ed_batch.py`). Codes must be < ED_ALPHA; larger codes are read
as ED_ALPHA - 1 by both versions below.

`edit_distance_batch` launches the hand-written kernel
(csrc/edit_distance.cu) for CUDA tensors and runs `edit_distance_plain`
for CPU tensors. The plain version carries uint32 words in int64 masked to
32 bits: torch on the CPU does not shift, add or compare uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda

ED_ALPHA = 11
ED_CODE_LUT = np.full(256, ED_ALPHA - 1, np.uint8)
ED_CODE_LUT[np.frombuffer(b"ACGTNacgtn", np.uint8)] = np.arange(10, dtype=np.uint8)
# largest pattern the kernel takes: W <= ED_MAX_WORDS words of 32 bits
ED_MAX_WORDS = 32
M32 = 0xFFFFFFFF


def edit_distance_plain(pat_codes, pat_lens, txt_codes, txt_lens, W: int):
    """(B, Lp) / (B, Lt) uint8 codes and (B,) lengths -> (B,) int32
    Levenshtein distances, step for step as the JAX version: a pattern of
    length 0 gives the text length, then a text of length 0 gives the
    pattern length; steps past a text's length keep its state."""
    dev = pat_codes.device
    B, Lp = pat_codes.shape
    Lt = txt_codes.shape[1]
    m = pat_lens.to(torch.int64)
    n = txt_lens.to(torch.int64)
    # Eq: bit i%32 of word i//32 of symbol pattern[i]'s row; the bits are
    # distinct, so a scatter-add is an OR
    pi = torch.arange(Lp, device=dev)
    sel = (pi[None, :] < m[:, None]) & (pi[None, :] // 32 < W)
    sym = pat_codes.to(torch.int64).clamp(max=ED_ALPHA - 1)
    flat = torch.where(sel, sym * W + pi[None, :] // 32, 0)
    eq = torch.zeros((B, ED_ALPHA * W), dtype=torch.int64, device=dev)
    eq.scatter_add_(1, flat, torch.where(sel, 1 << (pi[None, :] % 32), 0))
    eq = eq.view(B, ED_ALPHA, W)

    nbits = (m[:, None] - 32 * torch.arange(W, device=dev)[None, :]).clamp(0, 32)
    pv = [((1 << nbits[:, w]) - 1) for w in range(W)]
    mv = [torch.zeros(B, dtype=torch.int64, device=dev) for _ in range(W)]
    top = (m - 1).clamp(min=0)
    top_word, top_bit = top // 32, 1 << (top % 32)
    score = m.clone()
    rows = torch.arange(B, device=dev)
    for t in range(Lt):
        active = (t < n) & (m > 0)
        eq_t = eq[rows, txt_codes[:, t].to(torch.int64).clamp(max=ED_ALPHA - 1)]
        hin_p = torch.ones(B, dtype=torch.int64, device=dev)
        hin_m = torch.zeros(B, dtype=torch.int64, device=dev)
        carry = torch.zeros(B, dtype=torch.int64, device=dev)
        hp_top = torch.zeros(B, dtype=torch.int64, device=dev)
        hn_top = torch.zeros(B, dtype=torch.int64, device=dev)
        for w in range(W):
            eqw, pvw, mvw = eq_t[:, w], pv[w], mv[w]
            xv = eqw | mvw
            x = eqw & pvw
            s1 = (x + pvw) & M32
            s2 = (s1 + carry) & M32
            carry = ((s1 < x) | (s2 < s1)).to(torch.int64)
            xh = (s2 ^ pvw) | eqw
            ph = (mvw | ~(xh | pvw)) & M32
            mh = pvw & xh
            at = top_word == w
            hp_top = torch.where(at, ph, hp_top)
            hn_top = torch.where(at, mh, hn_top)
            ph_sh = ((ph << 1) & M32) | hin_p
            mh_sh = ((mh << 1) & M32) | hin_m
            hin_p, hin_m = ph >> 31, mh >> 31
            pv[w] = torch.where(active, (mh_sh | ~(xv | ph_sh)) & M32, pvw)
            mv[w] = torch.where(active, ph_sh & xv, mvw)
        delta = torch.where((hp_top & top_bit) != 0, 1,
                            torch.where((hn_top & top_bit) != 0, -1, 0))
        score = score + torch.where(active, delta, 0)
    score = torch.where(m == 0, n, score)
    score = torch.where(n == 0, m, score)
    return score.to(torch.int32)


def edit_distance_batch(pat_codes, pat_lens, txt_codes, txt_lens, W: int):
    """Kernel 5 (csrc/edit_distance.cu): the JAX signature, (B,) int32
    distances. Lengths must not exceed their rows' widths, and the pattern
    must fit W words (Lp <= 32 * W); on CUDA W <= ED_MAX_WORDS."""
    dev = pat_codes.device
    cuda.check_tensor(pat_codes, "pat_codes", torch.uint8, 2, dev)
    cuda.check_tensor(txt_codes, "txt_codes", torch.uint8, 2, dev)
    cuda.check_tensor(pat_lens, "pat_lens", torch.int32, 1, dev)
    cuda.check_tensor(txt_lens, "txt_lens", torch.int32, 1, dev)
    B, Lp = pat_codes.shape
    if txt_codes.shape[0] != B or pat_lens.shape[0] != B or txt_lens.shape[0] != B:
        raise ValueError("edit_distance_batch: batch sizes differ")
    if W < 1 or Lp > 32 * W:
        raise ValueError(f"edit_distance_batch: a {Lp}-wide pattern needs more than W={W} words")
    if dev.type == "cpu":
        return edit_distance_plain(pat_codes, pat_lens, txt_codes, txt_lens, W)
    if W > ED_MAX_WORDS:
        raise ValueError(f"edit_distance_batch: W={W} exceeds the kernel's {ED_MAX_WORDS} words")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        cuda.launch_edit_distance(pat_codes, pat_lens, txt_codes, txt_lens, W, out)
    return out
