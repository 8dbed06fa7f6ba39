"""ctypes bindings to the native host runtime (native/gfnative.cpp).

Compiled on first use with g++ (cached under build/ of this package). Every entry
point has a pure-numpy fallback; `available()` reports whether the native
path loaded. The native code replaces the reference's rayon-parallelized
index build (README.md:24-26 of the reference) on the host side.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("genefuse")

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "native", "gfnative.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libgfnative.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    # build under a private name and rename: processes that start together
    # (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread", _SRC, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # pragma: no cover - toolchain issues
        log.warning("native build failed, using numpy fallbacks: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _compile():
        return None
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p = ctypes.POINTER
    lib.gf_rolling_entries.restype = i64
    lib.gf_rolling_entries.argtypes = [
        p(ctypes.c_uint8), i64, i32, i32, i64,
        p(ctypes.c_uint32), p(i32), p(i32),
    ]
    lib.gf_stable_sort_by_kmer.restype = None
    lib.gf_stable_sort_by_kmer.argtypes = [p(ctypes.c_uint32), i64, p(i64)]
    lib.gf_sort_entries_by_kmer.restype = None
    lib.gf_sort_entries_by_kmer.argtypes = [
        p(ctypes.c_uint32), p(i32), p(i32), i64,
        p(ctypes.c_uint32), p(i32), p(i32),
    ]
    lib.gf_group_starts.restype = i64
    lib.gf_group_starts.argtypes = [p(ctypes.c_uint32), i64, p(i64)]
    lib.gf_matcher_scan.restype = i64
    lib.gf_matcher_scan.argtypes = [
        p(ctypes.c_uint8), i64, ctypes.c_uint8,
        p(i32), p(ctypes.c_uint8),
    ]
    lib.gf_pack_table.restype = i64
    lib.gf_pack_table.argtypes = [
        p(ctypes.c_uint32), p(i32), p(i32), i64, p(i32), i64, i32, i32,
    ]
    u8 = ctypes.c_uint8
    lib.gf_pack_pe_batch.restype = None
    lib.gf_pack_pe_batch.argtypes = [
        p(u8), p(u8), p(u8), p(u8), p(i32), p(i32),
        i64, i64, i64, i64, p(u8), p(u8),
    ]
    lib.gf_merge_pack_pe2.restype = None
    lib.gf_merge_pack_pe2.argtypes = [
        p(u8), p(u8), p(u8), p(u8), p(i32), p(i32),
        i64, i64, i64, i64,
        p(u8), p(i32), p(u8), p(u8), p(i32), p(u8),
        p(i32), i64, p(i32), i64, p(i64),
    ]
    lib.gf_fastq_dims.restype = None
    lib.gf_fastq_dims.argtypes = [p(u8), i64, i64, p(i64)]
    lib.gf_fastq_fill.restype = None
    lib.gf_fastq_fill.argtypes = [
        p(u8), i64, i64, i64, p(i64), p(i64), p(u8), p(u8), p(i32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rolling_entries(
    codes: np.ndarray, contig: int, start_offset: int, exclude_last: bool
):
    """-> (kmers u32, contigs i32, poss i32) arrays of valid entries, or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(codes)
    cap = max(0, n - 16 + 1)
    out_k = np.empty(cap, np.uint32)
    out_c = np.empty(cap, np.int32)
    out_p = np.empty(cap, np.int32)
    codes = np.ascontiguousarray(codes, np.uint8)
    m = lib.gf_rolling_entries(
        _ptr(codes, ctypes.c_uint8),
        n,
        contig,
        start_offset,
        1 if exclude_last else 0,
        _ptr(out_k, ctypes.c_uint32),
        _ptr(out_c, ctypes.c_int32),
        _ptr(out_p, ctypes.c_int32),
    )
    return out_k[:m], out_c[:m], out_p[:m]


def stable_argsort_kmers(kmers: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, np.uint32)
    order = np.empty(len(kmers), np.int64)
    lib.gf_stable_sort_by_kmer(
        _ptr(kmers, ctypes.c_uint32), len(kmers), _ptr(order, ctypes.c_int64)
    )
    return order


def sort_entries_by_kmer(kmers: np.ndarray, ctgs: np.ndarray, poss: np.ndarray):
    """Stable radix sort of (kmer, contig, pos) entries by kmer, returning
    the permuted columns — streaming passes only (no random gathers), ~3x
    faster than argsort+3-column fancy-indexing on latency-bound hosts.
    -> (kmers, ctgs, poss) sorted, or None if the native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    n = len(kmers)
    kmers = np.ascontiguousarray(kmers, np.uint32)
    ctgs = np.ascontiguousarray(ctgs, np.int32)
    poss = np.ascontiguousarray(poss, np.int32)
    k_out = np.empty(n, np.uint32)
    c_out = np.empty(n, np.int32)
    p_out = np.empty(n, np.int32)
    lib.gf_sort_entries_by_kmer(
        _ptr(kmers, ctypes.c_uint32), _ptr(ctgs, ctypes.c_int32),
        _ptr(poss, ctypes.c_int32), n,
        _ptr(k_out, ctypes.c_uint32), _ptr(c_out, ctypes.c_int32),
        _ptr(p_out, ctypes.c_int32),
    )
    return k_out, c_out, p_out


def group_starts(sorted_kmers: np.ndarray):
    """Run-start indices of a kmer-sorted array (parallel native pass).
    -> int64 starts array, or None if the native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    sorted_kmers = np.ascontiguousarray(sorted_kmers, np.uint32)
    out = np.empty(len(sorted_kmers), np.int64)
    m = lib.gf_group_starts(
        _ptr(sorted_kmers, ctypes.c_uint32), len(sorted_kmers),
        _ptr(out, ctypes.c_int64),
    )
    return out[:m]


def matcher_scan(codes: np.ndarray, bloom_bits) -> Optional[tuple]:
    """Quirk-faithful Matcher contig scan (see gf_matcher_scan / the
    core/matcher.py module docstring). codes: uint8 2-bit codes with 255
    invalid; bloom_bits: iterable of key values 0..3 present in the bloom.
    -> (positions i32, keys u8) ascending, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    mask = 0
    for b in bloom_bits:
        if 0 <= int(b) <= 3:
            mask |= 1 << int(b)
    cap = max(0, n - 16)
    out_pos = np.empty(cap, np.int32)
    out_key = np.empty(cap, np.uint8)
    m = lib.gf_matcher_scan(
        _ptr(codes, ctypes.c_uint8), n, mask,
        _ptr(out_pos, ctypes.c_int32), _ptr(out_key, ctypes.c_uint8),
    )
    return out_pos[:m], out_key[:m]


def pack_table(
    keys: np.ndarray, contigs: np.ndarray, poss: np.ndarray, nb: int,
    shift: int, slots: int, empty_sentinel: int
):
    """-> (nb, slots, 3) int32 table or None (native unavailable / overflow)."""
    lib = _load()
    if lib is None:
        return None
    table = np.zeros((nb, slots, 3), np.int32)
    table[:, :, 1] = empty_sentinel
    keys = np.ascontiguousarray(keys, np.uint32)
    contigs = np.ascontiguousarray(contigs, np.int32)
    poss = np.ascontiguousarray(poss, np.int32)
    failed = lib.gf_pack_table(
        _ptr(keys, ctypes.c_uint32),
        _ptr(contigs, ctypes.c_int32),
        _ptr(poss, ctypes.c_int32),
        len(keys),
        _ptr(table, ctypes.c_int32),
        nb,
        shift,
        slots,
    )
    if failed:
        return None
    return table


def merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L: int):
    """Host merge + compact + 2-BIT pack of a PE batch (one native pass;
    bit-exact with core.read fast_merge — see gf_merge_pack_pe2).

    Returns None when the native library is unavailable, else a dict:
      m_flag (B,) bool, m_len (B,) int32, exotic (B,) bool,
      mbuf (n_m, mw4) uint8 — compacted merged rows, 2-bit codes at
        stride (2*Lin+3)//4,
      rwork (n_u, 3) int32 — [pair_row, lane, len] per live unmerged lane,
      ubuf (n_u, w4) uint8 — unmerged rows at read width L, 2-bit codes,
      m_exc / u_exc (n, 2) int32 — [row, col] of non-ACGT bases in the
        mbuf / ubuf row spaces (device scatters invalid markers there).
    """
    lib = _load()
    if lib is None:
        return None
    B, Lin = b1.shape
    mw4 = (2 * Lin + 3) // 4
    w4 = (L + 3) // 4
    m_flag = np.zeros(B, np.uint8)
    m_len = np.zeros(B, np.int32)
    exotic = np.zeros(B, np.uint8)
    mbuf = np.empty((B, mw4), np.uint8)
    rwork = np.empty((2 * B, 3), np.int32)
    ubuf = np.empty((2 * B, w4), np.uint8)
    # generous exception capacity: ~3% of all bases; overflow (pathological
    # all-N batches) rolls the affected pairs over to the host oracle
    me_cap = max(4096, (B * 2 * Lin) // 32)
    ue_cap = me_cap
    m_exc = np.empty((me_cap, 2), np.int32)
    u_exc = np.empty((ue_cap, 2), np.int32)
    counts = np.zeros(4, np.int64)
    u8 = ctypes.c_uint8
    i32 = ctypes.c_int32
    i64 = ctypes.c_int64
    args = [np.ascontiguousarray(x, np.uint8) for x in (b1, q1, b2, q2)]
    l1c = np.ascontiguousarray(l1, np.int32)
    l2c = np.ascontiguousarray(l2, np.int32)
    lib.gf_merge_pack_pe2(
        _ptr(args[0], u8), _ptr(args[1], u8), _ptr(args[2], u8),
        _ptr(args[3], u8), _ptr(l1c, i32), _ptr(l2c, i32),
        B, Lin, mw4, w4,
        _ptr(m_flag, u8), _ptr(m_len, i32), _ptr(exotic, u8),
        _ptr(mbuf, u8), _ptr(rwork, i32), _ptr(ubuf, u8),
        _ptr(m_exc, i32), me_cap, _ptr(u_exc, i32), ue_cap,
        _ptr(counts, i64),
    )
    n_m, n_u, n_me, n_ue = (int(x) for x in counts)
    return dict(
        m_flag=m_flag.astype(bool),
        m_len=m_len,
        exotic=exotic.astype(bool),
        mbuf=mbuf[:n_m],
        rwork=rwork[:n_u],
        ubuf=ubuf[:n_u],
        m_exc=m_exc[:n_me],
        u_exc=u_exc[:n_ue],
    )


def merge_pack_pe_fallback(b1, q1, b2, q2, l1, l2, L: int):
    """Pure-Python merge_pack_pe_batch (oracle fast_merge per row; slow —
    only used when the native library cannot build). Output-identical to
    gf_merge_pack_pe2 by construction: the merge IS the oracle."""
    from .core.read import SequenceRead, SequenceReadPair
    from .core.sequence import BASE_CODE_LUT
    from .ops.pack import has_exotic

    B, Lin = b1.shape
    mw4 = (2 * Lin + 3) // 4
    w4 = (L + 3) // 4

    def pack_row2(codes, n, w, row, exc):
        c = np.zeros(4 * w, np.uint8)
        c[: min(n, len(codes))] = codes[: min(n, 4 * w)]
        bad = np.nonzero(c[:n] == 255)[0]
        for j in bad.tolist():
            exc.append((row, j))
        c[c == 255] = 0
        return c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)

    exotic = has_exotic(b1, l1) | has_exotic(b2, l2)
    m_flag = np.zeros(B, bool)
    m_len = np.zeros(B, np.int32)
    mrows, urows, rw = [], [], []
    m_exc, u_exc = [], []
    for r in range(B):
        n1, n2 = int(l1[r]), int(l2[r])
        if (n1 == 0 and n2 == 0) or exotic[r]:
            continue
        s1 = b1[r, :n1].tobytes().decode("latin-1")
        s2 = b2[r, :n2].tobytes().decode("latin-1")
        pair = SequenceReadPair(
            SequenceRead("r", s1, "+", q1[r, :n1].tobytes().decode("latin-1")),
            SequenceRead("r", s2, "+", q2[r, :n2].tobytes().decode("latin-1")),
        )
        m = pair.fast_merge()
        if m is not None:
            m_flag[r] = True
            m_len[r] = len(m.seq)
            codes = BASE_CODE_LUT[np.frombuffer(m.seq.encode("latin-1"), np.uint8)]
            mrows.append(pack_row2(codes, len(m.seq), mw4, len(mrows), m_exc))
        else:
            if n1 > 0:
                rw.append((r, 1, n1))
                urows.append(
                    pack_row2(BASE_CODE_LUT[b1[r]], n1, w4, len(urows), u_exc)
                )
            if n2 > 0:
                rw.append((r, 2, n2))
                urows.append(
                    pack_row2(BASE_CODE_LUT[b2[r]], n2, w4, len(urows), u_exc)
                )
    return dict(
        m_flag=m_flag,
        m_len=m_len,
        exotic=exotic,
        mbuf=(np.stack(mrows) if mrows else np.zeros((0, mw4), np.uint8)),
        rwork=(np.asarray(rw, np.int32).reshape(-1, 3)),
        ubuf=(np.stack(urows) if urows else np.zeros((0, w4), np.uint8)),
        m_exc=np.asarray(m_exc, np.int32).reshape(-1, 2),
        u_exc=np.asarray(u_exc, np.int32).reshape(-1, 2),
    )


def parse_fastq_block(data: bytes, line_limit: int):
    """Two-pass native FASTQ block parse (GIL released for the whole
    buffer scan — the numpy parser's fancy indexing holds it and starves
    the scan pipeline when parsing runs in a prefetch thread).

    -> (n, name_spans (n,2) i64, strand_spans (n,2) i64, seq (n,L) u8,
        qual (n,L) u8, lens (n,) i32, bad_line) or None when the native
    library is unavailable. bad_line >= 0 flags the first line whose
    content meets `line_limit` (caller raises, matching the reference
    LimitedBufReader panic); the other outputs are then meaningless."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    u8 = ctypes.c_uint8
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    dims = np.zeros(3, np.int64)
    lib.gf_fastq_dims(_ptr(buf, u8), len(buf), line_limit, _ptr(dims, i64))
    n, max_seq, bad = int(dims[0]), int(dims[1]), int(dims[2])
    if bad >= 0:
        return n, None, None, None, None, None, bad
    L = max(1, max_seq)
    name_spans = np.empty((n, 2), np.int64)
    strand_spans = np.empty((n, 2), np.int64)
    seq = np.empty((n, L), np.uint8)
    qual = np.empty((n, L), np.uint8)
    lens = np.empty(n, np.int32)
    if n:
        lib.gf_fastq_fill(
            _ptr(buf, u8), len(buf), n, L,
            _ptr(name_spans, i64), _ptr(strand_spans, i64),
            _ptr(seq, u8), _ptr(qual, u8), _ptr(lens, i32),
        )
    return n, name_spans, strand_spans, seq, qual, lens, -1


def pack_pe_batch(b1, q1, b2, q2, l1, l2, L: int, out_rows: int):
    """Pack a PE batch into the upload layout (ops/pack.py formats) in one
    native pass. -> (buf (out_rows, W) uint8, exotic (B,) bool) or None."""
    lib = _load()
    if lib is None:
        return None
    B, Lin = b1.shape
    w2 = (L + 1) // 2
    w4 = (L + 3) // 4
    W = 2 * w2 + 2 * w4
    out = np.empty((out_rows, W), np.uint8)
    exotic = np.zeros(B, np.uint8)
    u8 = ctypes.c_uint8
    i32 = ctypes.c_int32
    args = [np.ascontiguousarray(x, np.uint8) for x in (b1, q1, b2, q2)]
    l1c = np.ascontiguousarray(l1, np.int32)
    l2c = np.ascontiguousarray(l2, np.int32)
    lib.gf_pack_pe_batch(
        _ptr(args[0], u8), _ptr(args[1], u8), _ptr(args[2], u8),
        _ptr(args[3], u8), _ptr(l1c, i32), _ptr(l2c, i32),
        B, Lin, L, out_rows, _ptr(out, u8), _ptr(exotic, u8),
    )
    return out, exotic.astype(bool)
