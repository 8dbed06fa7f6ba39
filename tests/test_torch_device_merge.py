"""The port's device-side pair merge against the JAX package's, bit for bit:
the pack helpers (`ops/pack.py`), the row gathers (`ops/gather.py`),
`merge_batch` (`ops/merge.py`) and the merge front and row passes of
`ops/fused.py` (`_merge_codes`, `fused_merge_chunked`, `fused_pass1`,
`fused_pass1_chunked`, `pass1_rows_merged`, `pass1_rows_packed`,
`fused_pass2_combined`, `fused_scan_codes`) on a small panel's kv2 table
with reads planted from it; Python mirrors of csrc/merge.cu's kernels
(the warp's overlap scan with its early stop, the merged row, the row
gather) held to JAX and to the plain versions; the kernels against their
plain versions on the card (`cuda`, skipped without one).

Pairs are (R1, its qualities, R2 as sequenced, its qualities): the byte
merge takes RC(R2) and R2's reversed qualities, the 4-bit upload R2 as
sequenced (the device takes its reverse complement)."""

import os
import re

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import MIN_OVERLAP, Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
from genefuserust_tpu.core.sequence import COMPLEMENT_LUT, reverse_complement
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops import pack as jp
from genefuserust_tpu.ops.hashtable import pack_index_kv
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch import native
from genefuserust_tpu_torch.ops import fused as tf
from genefuserust_tpu_torch.ops import gather as tg
from genefuserust_tpu_torch.ops import merge as tmg
from genefuserust_tpu_torch.ops import pack as tp
from genefuserust_tpu_torch.ops.index import index_to_torch
from genefuserust_tpu_torch.profiling.bounds import HBM_BYTES_PER_S, INT32_OPS_PER_S, bound

from test_torch_fused import _pack_lane
from test_torch_map_read import _jax_tables

L_MERGE = 96  # merge_batch's rows
L = 64  # the fused functions' reads (JAX unrolls a slice per overlap length)
B = 128
CHUNK = 32
HIGH, LOW = ord("I"), ord("#")
# the positions of an overlap a lane tests alone (MERGE_PREFIX of
# csrc/merge.cu, read from the source the kernels are built from)
_MERGE_CU = os.path.join(os.path.dirname(tf.__file__), os.pardir, "csrc", "merge.cu")
with open(_MERGE_CU) as _f:
    PREFIX = int(re.search(r"constexpr int MERGE_PREFIX = (\d+);", _f.read()).group(1))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable contiguous copy


def _rand(rng, n, alphabet=b"ACGT"):
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), n).tolist())


def _quals(rng, n):
    return bytes(rng.integers(33, 75, n).astype(np.uint8).tolist())


def _pair(r1, q1, frag2, q2=None):
    """A pair whose R2 reads `frag2` backwards (R2 as sequenced = RC(frag2));
    q2: R2's qualities as sequenced."""
    return (r1, q1, reverse_complement(frag2.decode("latin-1")).encode("latin-1"),
            q2 if q2 is not None else bytes([HIGH]) * len(frag2))


def _low_mismatch_pair(rng, n_low, Lr):
    """R1 = s[0:Lr], R2 reads s[30:30 + Lr] (overlap Lr - 30), `n_low`
    bases of R1 in the overlap changed, each high against R2's low."""
    s = bytearray(_rand(rng, Lr + 30))
    r1 = bytearray(s[:Lr])
    frag = bytes(s[30 : 30 + Lr])
    q2 = bytearray([HIGH]) * Lr
    for k in rng.choice(Lr - 30, n_low, replace=False):
        k = int(k)
        r1[30 + k] = ord("A") if r1[30 + k] != ord("A") else ord("C")
        q2[Lr - 1 - k] = LOW  # R2's base k of the fragment is its base Lr-1-k
    return _pair(bytes(r1), bytes([HIGH]) * Lr, frag, bytes(q2))


def _edge_pairs(rng, Lr):
    """Short reads, no overlap, exactly 2 and 3 low-quality mismatches, an
    overlap at min(l1, l2), lowercase, N and other bytes, empty reads."""
    s = _rand(rng, 3 * Lr)
    q = lambda n: bytes([HIGH]) * n
    out = [
        _pair(s[:20], q(20), s[5:25]),  # both shorter than MIN_OVERLAP
        _pair(s[:Lr], q(Lr), s[Lr - 29 : Lr + 20]),  # overlap 29 < MIN_OVERLAP
        _pair(s[:Lr], q(Lr), s[Lr - 30 : 2 * Lr - 30]),  # overlap exactly 30
        _pair(s[:Lr], q(Lr), _rand(rng, Lr)),  # no acceptable overlap
        _pair(s[:Lr], q(Lr), s[:Lr]),  # overlap at min(l1, l2) = L
        _pair(s[:Lr - 6], q(Lr - 6), s[10 : Lr - 6]),  # at min(l1, l2) = l2
        _pair(s[: Lr // 2], q(Lr // 2), s[: Lr - 3]),  # at min(l1, l2) = l1
        _pair(b"", b"", s[:Lr]),  # empty R1
        _pair(s[:Lr], q(Lr), b""),  # empty R2
        _low_mismatch_pair(rng, 2, Lr - 10),  # merges, diff 2
        _low_mismatch_pair(rng, 3, Lr - 10),  # the overlap refused
        _low_mismatch_pair(rng, 1, Lr - 20),
    ]
    for alphabet in (b"ACGTN", b"ACGTacgtn", b"ACGTX.\x80"):
        t = _rand(rng, 2 * Lr, alphabet)
        out.append(_pair(t[:Lr], _quals(rng, Lr), t[Lr - 50 : 2 * Lr - 50], _quals(rng, Lr)))
    # an N against N, a lowercase base against its uppercase
    t = bytearray(s[:Lr])
    t[40], t[50] = ord("N"), ord("a") if t[50] != ord("a") else ord("c")
    out.append(_pair(bytes(t), q(Lr), s[10 : Lr + 10]))
    return out


def _engineered_pairs(rng, n, Lr):
    """tests/test_engine_equality.py's pairs: overlaps of every quality
    over ACGTN, at read lengths 20..Lr."""
    out = []
    for _ in range(n):
        n1, n2 = int(rng.integers(20, Lr + 1)), int(rng.integers(20, Lr + 1))
        base = _rand(rng, 4 * Lr, b"ACGTN")
        off = int(rng.integers(0, Lr))
        r1 = base[off : off + n1]
        start2 = off + int(rng.integers(-10, n1))
        frag = base[max(0, start2) : max(0, start2) + n2]
        out.append(_pair(r1, _quals(rng, len(r1)), frag, _quals(rng, len(frag))))
    return out


def _panel_pairs(panel, rng, n_junction, n_merged, n_apart, Lr):
    """Junction pairs that merge into ~98-base reads across GENE1|GENE2
    (the merged lane's vote gates), gene pairs that merge with low-quality
    errors, and gene pairs that do not merge (the R1/R2 lanes hit)."""
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    g1, g2 = panel.contigs[c1].encode(), panel.contigs[c2].encode()
    out = []
    for k in range(n_junction):
        a = 58 + k % 5
        fused = g1[s1 + 4000 - a : s1 + 4000] + g2[s2 + 6000 : s2 + 6000 + 98 - a]
        out.append(_pair(fused[:Lr], bytes([HIGH]) * Lr, fused[98 - Lr : 98]))
    for k in range(n_merged):
        g = (g1, g2)[k % 2]
        x = int(rng.integers(5000, 14000))
        d = int(rng.integers(0, Lr - MIN_OVERLAP + 1))
        r1 = bytearray(g[x : x + Lr])
        q1 = bytearray([HIGH]) * Lr
        for p in rng.integers(0, Lr, 2):  # low-quality N calls
            if rng.random() < 0.5:
                r1[int(p)], q1[int(p)] = ord("N"), LOW
        out.append(_pair(bytes(r1), bytes(q1), g[x + d : x + d + Lr]))
    for k in range(n_apart):
        g = (g1, g2)[k % 2]
        x = int(rng.integers(5000, 14000))
        n1 = int(rng.integers(40, Lr + 1))
        out.append(_pair(g[x : x + n1], _quals(rng, n1), g[x + 3000 : x + 3000 + Lr]))
    return out


def _byte_rows(pairs, Lr):
    """-> b1, q1, l1, RC(R2) bytes, R2's reversed qualities, l2 (numpy)."""
    n = len(pairs)
    b1, q1, b2, q2 = (np.zeros((n, Lr), np.uint8) for _ in range(4))
    l1, l2 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for i, (r1, qa, r2, qb) in enumerate(pairs):
        b1[i, : len(r1)] = np.frombuffer(r1, np.uint8)
        q1[i, : len(r1)] = np.frombuffer(qa, np.uint8)
        b2[i, : len(r2)] = COMPLEMENT_LUT[np.frombuffer(r2, np.uint8)][::-1]
        q2[i, : len(r2)] = np.frombuffer(qb, np.uint8)[::-1]
        l1[i], l2[i] = len(r1), len(r2)
    return b1, q1, l1, b2, q2, l2


def _read_rows(pairs, Lr):
    """-> R1 bytes, quals, R2 bytes, quals as sequenced (zero tails), l1, l2."""
    n = len(pairs)
    rows = [np.zeros((n, Lr), np.uint8) for _ in range(4)]
    l1, l2 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for i, p in enumerate(pairs):
        for r, x in zip(rows, p):
            r[i, : len(x)] = np.frombuffer(x, np.uint8)
        l1[i], l2[i] = len(p[0]), len(p[2])
    return (*rows, l1, l2)


def _upload(pairs, Lr):
    """The JAX package's upload rows [s1p | q1p | s2p | q2p] and lens2."""
    s1, q1, s2, q2, l1, l2 = _read_rows(pairs, Lr)
    buf = np.concatenate([jp.pack_seq4(jp.SEQ4_LUT[s1]), jp.pack_q2(jp.qual_class(q1)),
                          jp.pack_seq4(jp.SEQ4_LUT[s2]), jp.pack_q2(jp.qual_class(q2))], 1)
    return buf, np.stack([l1, l2], 1).astype(np.int32)


# ---------------- the pack helpers ----------------


def test_pack_constants_match_jax():
    assert (tp.SEQ4_LUT == jp.SEQ4_LUT).all() and tp.SEQ4_LUT.dtype == jp.SEQ4_LUT.dtype
    assert (tp.MAP_FROM_SEQ4 == jp.MAP_FROM_SEQ4).all()
    assert (tp.COMP4 == jp.COMP4).all()
    assert tp.OK_BYTES == jp.OK_BYTES


@pytest.mark.parametrize("Lr", [1, 2, 3, 5, 77, 150])
def test_pack_and_unpack_match_jax(Lr):
    import jax.numpy as jnp

    rng = np.random.default_rng(Lr)
    raw = rng.integers(0, 256, (9, Lr)).astype(np.uint8)
    codes = jp.SEQ4_LUT[raw]
    assert (tp.qual_class(_t(raw)).numpy() == jp.qual_class(raw)).all()
    s4 = tp.pack_seq4(_t(codes))
    q2 = tp.pack_q2(tp.qual_class(_t(raw)))
    assert (s4.numpy() == jp.pack_seq4(codes)).all() and s4.dtype == torch.uint8
    assert (q2.numpy() == jp.pack_q2(jp.qual_class(raw))).all() and q2.dtype == torch.uint8
    assert (tp.unpack_seq4(s4, Lr).numpy() == np.asarray(jp.unpack_seq4_jnp(
        jnp.asarray(s4.numpy()), Lr))).all()
    assert (tp.unpack_q2(q2, Lr).numpy() == np.asarray(jp.unpack_q2_jnp(
        jnp.asarray(q2.numpy()), Lr))).all()
    assert (tp.unpack_seq4(s4, Lr).numpy() == codes).all()
    for fn, w in ((tp.unpack_seq4, (Lr + 1) // 2), (tp.unpack_q2, (Lr + 3) // 4),
                  (tp.unpack_seq2, (Lr + 3) // 4)):  # no rows
        assert fn(torch.zeros((0, w), dtype=torch.uint8), Lr).shape == (0, Lr)


@pytest.mark.parametrize("Lr", [77, 96])
def test_native_pack_pe_batch_matches_pack_helpers(Lr):
    """The port's native packer writes the JAX helpers' upload rows: odd L,
    reads shorter than L with zero tails, pad rows past the pairs."""
    rng = np.random.default_rng(Lr)
    pairs = _engineered_pairs(rng, 40, Lr) + _edge_pairs(rng, Lr)
    s1, q1, s2, q2, l1, l2 = _read_rows(pairs, Lr)
    exp, _ = _upload(pairs, Lr)
    n = len(pairs)
    got, exotic = native.pack_pe_batch(s1, q1, s2, q2, l1, l2, Lr, n + 5)
    # byte for byte but the pad nibble past an odd L: the native packer
    # writes 15 there (no base), pack_seq4 0; unpacking drops it
    w2, w4 = (Lr + 1) // 2, (Lr + 3) // 4
    keep = np.full(2 * w2 + 2 * w4, 0xFF, np.uint8)
    if Lr % 2:
        keep[w2 - 1] = keep[2 * w2 + w4 - 1] = 0x0F
        assert (got[:n, w2 - 1] >> 4 == 15).all()
    assert ((got[:n] & keep) == (exp & keep)).all()
    zero = np.zeros((5, Lr), np.uint8)
    pad = np.concatenate([jp.pack_seq4(jp.SEQ4_LUT[zero]), jp.pack_q2(jp.qual_class(zero))] * 2,
                         1)
    assert ((got[n:] & keep) == (pad & keep)).all()
    assert (exotic == (jp.has_exotic(s1, l1) | jp.has_exotic(s2, l2))).all() and exotic.any()


# ---------------- the row gathers ----------------


def test_row_take_matches_jax():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.gather import row_take

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (13, 40)).astype(np.uint8)
    idx = rng.integers(-5, 46, (13, 17)).astype(np.int32)
    exp = np.asarray(row_take(jnp.asarray(arr), jnp.asarray(idx)))
    assert (tg.row_take(_t(arr), _t(idx)).numpy() == exp).all()


@pytest.mark.parametrize("Lr", [1, 7, 32, 96])
def test_row_shifts_match_jax(Lr):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.gather import row_shift_left, row_shift_right

    rng = np.random.default_rng(Lr)
    arr = rng.integers(0, 256, (Lr + 1, Lr)).astype(np.uint8)
    shift = np.arange(Lr + 1, dtype=np.int32)  # every shift in [0, L]
    for jfn, tfn in ((row_shift_right, tg.row_shift_right), (row_shift_left, tg.row_shift_left)):
        for fill in (0, 15):
            exp = np.asarray(jfn(jnp.asarray(arr), jnp.asarray(shift), fill))
            assert (tfn(_t(arr), _t(shift), fill).numpy() == exp).all()


# ---------------- merge_batch ----------------


@pytest.fixture(scope="module")
def merge_pairs():
    """merge_batch's pairs at L_MERGE and their byte rows."""
    rng = np.random.default_rng(42)
    pairs = _engineered_pairs(rng, 200, 92) + _edge_pairs(rng, L_MERGE)
    return pairs, _byte_rows(pairs, L_MERGE)


@pytest.fixture(scope="module")
def merge_case(merge_pairs):
    """merge_pairs with JAX's results."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops.merge import merge_batch

    pairs, rows = merge_pairs
    return pairs, rows, [np.asarray(x) for x in merge_batch(*(jnp.asarray(x) for x in rows))]


def test_merge_batch_matches_jax(merge_case):
    _, rows, exp = merge_case
    got = tmg.merge_batch(*(_t(x) for x in rows))
    for name, g, e in zip(tmg.MergeResult._fields, got, exp):
        assert g.numpy().dtype == e.dtype, name
        assert (g.numpy() == e).all(), name
    merged = exp[0]
    assert merged.sum() > 20 and (~merged).sum() > 20
    assert {0, 1, 2} <= set(exp[2][merged].tolist())  # diffs of 0, 1 and 2


def test_merge_batch_matches_fast_merge(merge_case):
    pairs, _, exp = merge_case
    merged, _, diff, out_seq, out_qual, out_len = exp
    for i, (r1, q1, r2, q2) in enumerate(pairs):
        ref = SequenceReadPair(SequenceRead("@r", r1.decode("latin-1"), "+", q1.decode("latin-1")),
                               SequenceRead("@r", r2.decode("latin-1"), "+",
                                            q2.decode("latin-1"))).fast_merge()
        assert merged[i] == (ref is not None), i
        if ref is not None:
            n = int(out_len[i])
            assert out_seq[i, :n].tobytes().decode("latin-1") == ref.seq
            assert out_qual[i, :n].tobytes().decode("latin-1") == ref.quality
            assert ref.name.endswith(f"merged_diff_{int(diff[i])}")


def test_merge_batch_edge_pairs(merge_case):
    """The edge pairs do what they were built for."""
    pairs, _, exp = merge_case
    merged, olen, diff = exp[:3]
    e = len(pairs) - len(_edge_pairs(np.random.default_rng(0), L_MERGE))
    assert not merged[e] and not merged[e + 1]  # short; overlap 29
    assert merged[e + 2] and olen[e + 2] == 30
    assert not merged[e + 3]
    assert merged[e + 4] and olen[e + 4] == L_MERGE
    assert merged[e + 5] and olen[e + 5] == L_MERGE - 16
    assert merged[e + 6] and olen[e + 6] == L_MERGE // 2
    assert not merged[e + 7] and not merged[e + 8]
    assert merged[e + 9] and diff[e + 9] == 2 and olen[e + 9] == L_MERGE - 40
    assert not merged[e + 10]
    assert merged[e + 11] and diff[e + 11] == 1


# ---------------- Python mirrors of csrc/merge.cu ----------------


def _overlap_ok(a, qa, b, qb, off, o, low):
    """merge.cu overlap_ok: 32 positions a step; refused at the first step
    holding a mismatch that is not low-quality discordant or bringing the
    low-quality count past 2 -> (accepted, its count)."""
    nlow = 0
    for at in range(0, o, 32):
        hard = False
        for i in range(at, min(at + 32, o)):
            if a[off + i] != b[i]:
                if low(qa[off + i], qb[i]):
                    nlow += 1
                else:
                    hard = True
        if hard or nlow > 2:
            return False, 0
    return True, nlow


def _warp_overlap(a, qa, b, qb, l1, l2, low, prefix=PREFIX):
    """merge.cu warp_overlap -> (olen or 0, diff): the lanes' filter of 32
    overlaps at a time on their first `prefix` positions, then the warp's
    whole scan of those that pass, ascending."""
    n = min(l1, l2)
    for o0 in range(MIN_OVERLAP, n + 1, 32):
        for o in range(o0, min(o0 + 32, n + 1)):
            off, nlow, hard = l1 - o, 0, False
            for i in range(prefix):
                if a[off + i] != b[i]:
                    if low(qa[off + i], qb[i]):
                        nlow += 1
                    else:
                        hard = True
            if hard or nlow > 2:
                continue
            ok, nlow = _overlap_ok(a, qa, b, qb, off, o, low)
            if ok:
                return o, nlow
    return 0, 0


def _low_bytes(x, y):
    return (x >= 63 and y <= 48) or (x <= 48 and y >= 63)


def _low_classes(x, y):
    return (x == 2 and y == 0) or (x == 0 and y == 2)


def _kernel_merge_bytes(rows, prefix=PREFIX):
    """merge_bytes_kernel, a pair at a time -> MergeResult fields (numpy)."""
    b1, q1, l1, b2, q2, l2 = rows
    n, Lr = b1.shape
    res = [np.zeros(n, bool), np.zeros(n, np.int32), np.zeros(n, np.int32),
           np.zeros((n, 2 * Lr), np.uint8), np.zeros((n, 2 * Lr), np.uint8),
           np.zeros(n, np.int32)]
    for r in range(n):
        a, qa, b, qb = (x[r].tolist() for x in (b1, q1, b2, q2))
        n1, n2 = int(l1[r]), int(l2[r])
        o, diff = _warp_overlap(a, qa, b, qb, n1, n2, _low_bytes, prefix)
        if not o:
            continue
        off, out_len = n1 - o, n1 - o + n2
        for j in range(out_len):
            if j < off:
                s, q = a[j], qa[j]
            elif j < n1:
                x, qx, y, qy = a[j], qa[j], b[j - off], qb[j - off]
                if x == y:
                    s, q = y, min(qx + qy - 33, 90) & 0xFF
                elif qx >= 63 and qy <= 48:
                    s, q = x, qx
                else:
                    s, q = y, qy
            else:
                s, q = b[j - off], qb[j - off]
            res[3][r, j], res[4][r, j] = s, q
        res[0][r], res[1][r], res[2][r], res[5][r] = True, o, diff, out_len
    return res


@pytest.mark.parametrize("prefix", sorted({1, 2, PREFIX, 8, 16, MIN_OVERLAP}))
def test_merge_bytes_mirror_matches_jax(merge_case, prefix):
    """At the kernel's filter prefix and at others up to MIN_OVERLAP: the
    filter drops only overlaps that fail, whatever its length."""
    _, rows, exp = merge_case
    for g, e in zip(_kernel_merge_bytes(rows, prefix), exp):
        assert (g == e).all()


def _kernel_merge_codes(buf, lens2, Lr):
    """merge_codes_kernel, a pair at a time: the staging (R1's codes and
    classes; R2's complement read backwards from l2 - 1, 15/0 past l2), the
    warp's scan and the merged row -> msum, m_codes, the map lanes, lens3."""
    n = buf.shape[0]
    w2, w4 = (Lr + 1) // 2, (Lr + 3) // 4
    nib = lambda row, i: (int(row[i >> 1]) >> (4 * (i & 1))) & 15
    cls = lambda row, i: (int(row[i >> 2]) >> (2 * (i & 3))) & 3
    comp = lambda c: c ^ 1 if c < 4 else ((c - 5) ^ 1 if 5 <= c <= 8 else 4)
    mp = lambda c: c if c < 4 else 255
    msum = np.zeros((n, 3), np.int32)
    m_codes = np.full((n, 2 * Lr), 15, np.uint8)
    maps = [np.zeros((n, 2 * Lr), np.uint8), np.zeros((n, Lr), np.uint8),
            np.zeros((n, Lr), np.uint8)]
    lens3 = np.zeros((3, n), np.int32)
    for r in range(n):
        row = buf[r]
        s1p, q1p, s2p, q2p = (row[:w2], row[w2 : w2 + w4], row[w2 + w4 : 2 * w2 + w4],
                              row[2 * w2 + w4 :])
        n1, n2 = int(lens2[r, 0]), int(lens2[r, 1])
        s1 = [nib(s1p, i) for i in range(Lr)]
        c1 = [cls(q1p, i) for i in range(Lr)]
        t2 = [comp(nib(s2p, n2 - 1 - i)) if i < n2 else 15 for i in range(Lr)]
        c2 = [cls(q2p, n2 - 1 - i) if i < n2 else 0 for i in range(Lr)]
        maps[1][r] = [mp(c) for c in s1]
        maps[2][r] = [mp(nib(s2p, i)) for i in range(Lr)]
        o, diff = _warp_overlap(s1, c1, t2, c2, n1, n2, _low_classes)
        off, m_len = n1 - o, (n1 - o + n2 if o else 0)
        for j in range(m_len):
            if j < off:
                m_codes[r, j] = s1[j]
            elif j < n1:
                x, y = s1[j], t2[j - off]
                m_codes[r, j] = x if x != y and c1[j] == 2 and c2[j - off] == 0 else y
            else:
                m_codes[r, j] = t2[j - off]
        maps[0][r] = [mp(c) for c in m_codes[r]]
        msum[r] = (int(o > 0), diff, m_len)
        lens3[:, r] = (m_len, 0 if o else n1, 0 if o else n2)
    return msum, m_codes, maps, lens3


def _kernel_merge_rows(m_codes, buf, idx, lane, W, Lr):
    """merge_rows_kernel, a row at a time."""
    nrows = (m_codes if m_codes is not None else buf).shape[0]
    w2, w4 = (Lr + 1) // 2, (Lr + 3) // 4
    out = np.full((len(idx), W), 255, np.uint8)
    for p, src in enumerate(idx.tolist()):
        which = 0 if lane is None else int(lane[p])
        if not 0 <= src < nrows:
            continue
        for c in range(W):
            if which == 0 and m_codes is not None:
                code = int(m_codes[src, c])
            elif c < Lr:
                part = buf[src, : w2] if which == 1 else buf[src, w2 + w4 : 2 * w2 + w4]
                code = (int(part[c >> 1]) >> (4 * (c & 1))) & 15
            else:
                code = 15
            out[p, c] = code if code < 4 else 255
    return out


# ---------------- the fused functions on a panel ----------------


@pytest.fixture(scope="module")
def panel_data(tmp_path_factory):
    """The small panel's kv2 table (packed, and the port's CPU index), the
    pairs and their upload."""
    panel = make_panel(seed=5)
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    packed = pack_index_kv(ix, target_load=0.5, slots=1)
    assert packed is not None and packed.kv_tbl.shape[1] == 2
    rng = np.random.default_rng(9)
    pairs = (_panel_pairs(panel, rng, 16, 40, 24, L) + _edge_pairs(rng, L)
             + _engineered_pairs(rng, B, L))[:B]
    buf, lens2 = _upload(pairs, L)
    return dict(panel=panel, packed=packed, index=index_to_torch(packed, "cpu"), pairs=pairs,
                buf=buf, lens2=lens2)


@pytest.fixture(scope="module")
def panel_case(panel_data):
    """panel_data with JAX's tables and its fused_pass1_chunked and
    fused_merge_chunked results."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = dict(panel_data)
    packed, buf, lens2 = c["packed"], c["buf"], c["lens2"]
    t1, t2, dupes, kw = _jax_tables(packed)
    tabs = (t1, t2, dupes)
    statics = (packed.shift, packed.max_dupe)
    summary, m_codes = jf.fused_pass1_chunked(jnp.asarray(buf), jnp.asarray(lens2), *tabs, L,
                                              CHUNK, *statics, 40, 20, **kw)
    msum, m_codes2 = jf.fused_merge_chunked(jnp.asarray(buf), jnp.asarray(lens2), L, CHUNK)
    c.update(tabs=tabs, statics=statics, kw=kw, summary=np.asarray(summary),
             m_codes=np.asarray(m_codes), msum=np.asarray(msum), m_codes2=np.asarray(m_codes2))
    return c


def _port_case(panel_data):
    """panel_data with the port's own (CPU) summary and merged codes."""
    c = dict(panel_data)
    summary, m_codes = tf.fused_pass1_chunked(_t(c["buf"]), _t(c["lens2"]), c["index"], L, CHUNK)
    c.update(summary=summary.numpy(), m_codes=m_codes.numpy())
    return c


def test_fused_merge_chunked_matches_jax(panel_case):
    c = panel_case
    msum, m_codes = tf.fused_merge_chunked(_t(c["buf"]), _t(c["lens2"]), L, CHUNK)
    assert (msum.numpy() == c["msum"]).all() and (m_codes.numpy() == c["m_codes2"]).all()
    assert msum.dtype == torch.int32 and m_codes.dtype == torch.uint8
    assert c["msum"][:, 0].sum() >= 50 and (c["msum"][:, 0] == 0).sum() >= 30


@pytest.mark.parametrize("chunk", [B, CHUNK])
def test_fused_pass1_chunked_matches_jax(panel_case, chunk):
    c = panel_case
    summary, m_codes = tf.fused_pass1_chunked(_t(c["buf"]), _t(c["lens2"]), c["index"], L,
                                              chunk)
    assert summary.shape == (B, tf.SUMMARY_COLS) and summary.dtype == torch.int32
    assert (summary.numpy() == c["summary"]).all()
    assert (m_codes.numpy() == c["m_codes"]).all()
    s = c["summary"]
    assert s[:, 3].sum() >= 10  # merged junction reads pass the gate
    assert (s[:, 9] != 0).any() and (s[:, 14] != 0).any()  # R1 and R2 lanes hit
    assert ((s[:, 0] == 1) & (s[:, 8] == 0)).any()  # merged: empty R lanes voted


def test_fused_chunk_must_divide_the_batch(panel_case):
    c = panel_case
    with pytest.raises(ValueError):
        tf.fused_merge_chunked(_t(c["buf"]), _t(c["lens2"]), L, 48)
    with pytest.raises(ValueError):
        tf.fused_pass1_chunked(_t(c["buf"]), _t(c["lens2"]), c["index"], L, 0)


def test_fused_pass1_matches_jax(panel_case):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = panel_case
    w2, w4 = (L + 1) // 2, (L + 3) // 4
    buf, lens2 = c["buf"], c["lens2"]
    parts = (buf[:, :w2], buf[:, w2 : w2 + w4], lens2[:, 0], buf[:, w2 + w4 : 2 * w2 + w4],
             buf[:, 2 * w2 + w4 :], lens2[:, 1])
    exp = jf.fused_pass1(*(jnp.asarray(np.ascontiguousarray(p)) for p in parts), *c["tabs"], L,
                         *c["statics"], 40, 20, **c["kw"])
    got = tf.fused_pass1(*(_t(p) for p in parts), c["index"], L)
    for name, g, e in zip(tf.FusedPass1Result._fields, got, exp):
        e = np.asarray(e)
        assert g.shape == e.shape and (g.numpy() == e).all(), name
        assert g.numpy().dtype == e.dtype, name


def test_merge_codes_matches_jax(panel_case):
    """`merge_codes` on JAX `_merge_codes`'s own inputs (R2 complemented and
    reversed over the full width)."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops.fused import _merge_codes

    c = panel_case
    w2, w4 = (L + 1) // 2, (L + 3) // 4
    buf = c["buf"][:48]
    l1, l2 = c["lens2"][:48, 0], c["lens2"][:48, 1]
    s1 = tp.unpack_seq4(_t(buf[:, :w2]), L).numpy()
    qc1 = tp.unpack_q2(_t(buf[:, w2 : w2 + w4]), L).numpy()
    s2 = tp.unpack_seq4(_t(buf[:, w2 + w4 : 2 * w2 + w4]), L).numpy()
    qc2 = tp.unpack_q2(_t(buf[:, 2 * w2 + w4 :]), L).numpy()
    rc2f, qc2f = jp.COMP4[s2[:, ::-1]], np.ascontiguousarray(qc2[:, ::-1])
    args = (s1, qc1, l1, rc2f, qc2f, l2)
    exp = _merge_codes(*(jnp.asarray(a) for a in args), L)
    got = tf.merge_codes(*(_t(a) for a in args), L)
    for g, e in zip(got, exp):
        assert (g.numpy() == np.asarray(e)).all()
    assert np.asarray(exp[0]).any()


def test_merge_codes_mirror_matches_jax_and_plain(panel_case):
    c = panel_case
    msum, m_codes, maps, lens3 = _kernel_merge_codes(c["buf"], c["lens2"], L)
    assert (msum == c["msum"]).all() and (m_codes == c["m_codes"]).all()
    p_msum, p_codes, p_maps, p_lens3 = tf.merge_codes_plain(_t(c["buf"]), _t(c["lens2"]), L,
                                                            lanes=True)
    assert (p_msum.numpy() == msum).all() and (p_codes.numpy() == m_codes).all()
    for g, e in zip(p_maps, maps):
        assert (g.numpy() == e).all()
    assert (p_lens3.numpy() == lens3).all()
    assert (lens3[0] == msum[:, 2]).all() and ((lens3[1] == 0) | (msum[:, 0] == 0)).all()


def _work_lists(c):
    """From JAX's summary: the merged pairs (idx, lengths), the unmerged
    lanes [pair, lane, length], and pass 2's work [pair, lane, length, gp]
    over every lane that passed its gate."""
    s, lens2 = c["summary"], c["lens2"]
    m = np.nonzero(s[:, 0])[0].astype(np.int32)
    un = np.nonzero(s[:, 0] == 0)[0]
    work = np.array([(r, k, lens2[r, k - 1]) for r in un for k in (1, 2) if lens2[r, k - 1]],
                    np.int32).reshape(-1, 3)
    w7 = []
    for r in range(len(s)):
        for k, col in ((0, 3), (1, 8), (2, 13)):
            if s[r, col]:
                ln = s[r, 2] if k == 0 else lens2[r, k - 1]
                w7.append([r, k, ln, *s[r, col + 1 : col + 5]])
    # a few gated pairs' R1 and R2 rows with the merged lane's keys
    w7 += [[r, k, lens2[r, k - 1], *s[r, 4:8]] for r in m[:4] for k in (1, 2)]
    return m, s[m, 2].astype(np.int32), work, np.array(w7, np.int32)


@pytest.mark.parametrize("width", [0, 80])
def test_pass1_rows_merged_matches_jax(panel_case, width):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = panel_case
    idx, lens, _, _ = _work_lists(c)
    exp = np.asarray(jf.pass1_rows_merged(jnp.asarray(c["m_codes"]), jnp.asarray(idx),
                                          jnp.asarray(lens), *c["tabs"], 2 * L,
                                          *c["statics"], 40, 20, **c["kw"], width=width))
    got = tf.pass1_rows_merged(_t(c["m_codes"]), _t(idx), _t(lens), c["index"], 2 * L,
                               width=width)
    assert (got.numpy() == exp).all()
    if width == 0:  # the rows' votes are the summary's merged lane
        assert (exp == c["summary"][idx, 3:8]).all() and exp[:, 0].sum() >= 10


def test_pass1_rows_packed_matches_jax(panel_case):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = panel_case
    _, _, work, _ = _work_lists(c)
    exp = np.asarray(jf.pass1_rows_packed(jnp.asarray(c["buf"]), jnp.asarray(work),
                                          *c["tabs"], L, *c["statics"], 40, 20, **c["kw"]))
    got = tf.pass1_rows_packed(_t(c["buf"]), _t(work), c["index"], L)
    assert (got.numpy() == exp).all()
    # the rows' votes are the summary's R1 / R2 lanes
    cols = np.where(work[:, 1] == 1, 8, 13)
    want = np.stack([c["summary"][r, k : k + 5] for r, k in zip(work[:, 0], cols)])
    assert (exp == want).all() and (exp[:, 1:] != 0).any()


def test_fused_pass2_combined_matches_jax(panel_case):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = panel_case
    _, _, _, w7 = _work_lists(c)
    exp = np.asarray(jf.fused_pass2_combined(jnp.asarray(c["m_codes"]), jnp.asarray(c["buf"]),
                                             jnp.asarray(w7), *c["tabs"], L, *c["statics"],
                                             10, **c["kw"]))
    got = tf.fused_pass2_combined(_t(c["m_codes"]), _t(c["buf"]), _t(w7), c["index"], L)
    assert got.dtype == torch.int32 and (got.numpy() == exp).all()
    assert exp[:, 0].sum() >= 10 and {0, 1, 2} <= set(w7[:, 1].tolist())


def _rows_edge_cases(rng, Lr, nrows=40, PB=301):
    """Random upload rows of reads of Lr bases and merged code rows of 2Lr
    (codes 0-15), and gathers of them: widths off multiples of 16 (and
    below 16), PB off a block's 8 rows, entries outside [0, nrows), lanes
    0/1/2 mixed -> (m_codes, buf, cases)."""
    w2, w4 = (Lr + 1) // 2, (Lr + 3) // 4
    buf = rng.integers(0, 256, (nrows, 2 * w2 + 2 * w4), dtype=np.uint8)
    m_codes = rng.integers(0, 16, (nrows, 2 * Lr), dtype=np.uint8)
    idx = rng.integers(-3, nrows + 3, PB).astype(np.int32)
    lane = rng.integers(0, 3, PB).astype(np.int32)
    cases = [(m_codes, None, idx, None, W) for W in (2 * Lr - MIN_OVERLAP, 37, 16, 5, 1)]
    cases += [(None, buf, idx, lane, W) for W in (Lr, Lr + 7, 9)]
    cases += [(m_codes, buf, idx, lane, W) for W in (2 * Lr - MIN_OVERLAP, 2 * Lr, 21)]
    cases.append((m_codes, buf, idx[:1], lane[:1], 3))
    return m_codes, buf, cases


def test_merge_rows_mirror_matches_plain(panel_case):
    """merge_rows_kernel's mirror against merge_rows_plain in its three
    uses, with rows outside the batch (255); then on random rows at read
    lengths whose upload rows are 2-byte aligned (L 75, 150) or not
    aligned at all, widths off multiples of 16 and below 16, PB off a
    block's 8 rows, entries outside the rows and lanes 0/1/2 mixed."""
    c = panel_case
    idx, _, work, w7 = _work_lists(c)
    m_codes, buf = c["m_codes"], c["buf"]
    odd = np.array([-1, B, 3], np.int32)
    cases = [(m_codes, None, np.concatenate([idx, odd]), None, 2 * L - MIN_OVERLAP, L),
             (m_codes, None, idx, None, 80, L),
             (None, buf, work[:, 0], work[:, 1], L, L),
             (m_codes, buf, w7[:, 0], w7[:, 1], 2 * L - MIN_OVERLAP, L),
             (None, buf, odd, np.array([1, 2, 0], np.int32), L + 7, L)]
    rng = np.random.default_rng(3)
    for Lr in (75, 150, 33):
        mc, bf, more = _rows_edge_cases(rng, Lr)
        cases += [x + (Lr,) for x in more]
    for mc, bf, ix, ln, W, Lr in cases:
        exp = _kernel_merge_rows(mc, bf, ix, ln, W, Lr)
        got = tf.merge_rows_plain(None if mc is None else _t(mc), None if bf is None else _t(bf),
                                  _t(ix), None if ln is None else _t(ln), W, Lr)
        assert (got.numpy() == exp).all(), (W, Lr)
        # the wrapper takes strided columns of a work list
        wrapped = tf.merge_rows(None if mc is None else _t(mc), None if bf is None else _t(bf),
                                _t(ix), None if ln is None else _t(ln), W, Lr)
        assert torch.equal(wrapped, got)
    # every kind of entry and lane is exercised
    assert any(ln is not None and {0, 1, 2} <= set(ln.tolist()) for *_, ln, _, _ in cases)


def test_fused_scan_codes_matches_jax(panel_case):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import fused as jf

    c = panel_case
    pairs = c["pairs"]
    mreads, ureads = [], []
    for (r1, q1, r2, q2) in pairs:
        m = SequenceReadPair(SequenceRead("@r", r1.decode("latin-1"), "+", q1.decode("latin-1")),
                             SequenceRead("@r", r2.decode("latin-1"), "+",
                                          q2.decode("latin-1"))).fast_merge()
        if m is not None:
            mreads.append(m.seq.encode("latin-1"))
        else:
            ureads += [r for r in (r1, r2) if r]
    Wm = 128
    mbuf, mlens, me = _pack_lane(mreads, len(mreads) + 3, Wm)
    ubuf, ulens, ue = _pack_lane(ureads, len(ureads) + 1, L)
    exc = np.array(me + [(r + len(mlens), col) for r, col in ue] + [(10_000, 0)], np.int32)
    st = Settings()
    reqs = (st.major_gene_key_requirement, st.minor_gene_key_requirement)
    out_j, okw_j = jf.fused_scan_codes(
        *(jnp.asarray(x) for x in (mbuf, mlens, ubuf, ulens, exc)), *c["tabs"], Wm, L, 64,
        *c["statics"], *reqs, st.mismatch_threshold, **c["kw"])
    out_t, okw_t = tf.fused_scan_codes(*(_t(x) for x in (mbuf, mlens, ubuf, ulens, exc)),
                                       c["index"], Wm, L, 64, *reqs, st.mismatch_threshold)
    out_t, out_j = out_t.numpy(), np.asarray(out_j)
    # the count row's columns 1-2 are the port's row counter of the vote
    # (JAX's hold zeros): every row voted on the warp path, none sorted
    assert (out_t[:-1] == out_j[:-1]).all()
    assert out_t[-1, 0] == out_j[-1, 0] and (out_t[-1, 3:] == out_j[-1, 3:]).all()
    assert out_t[-1, 1] == len(mlens) + len(ulens) and out_t[-1, 2] == 0
    assert (okw_t.numpy() == np.asarray(okw_j)).all()
    assert out_j[-1, 0] >= 10


def test_device_merge_profile_checks_on_the_cpu(tmp_path):
    """profiling/device_merge.run on gen_block pairs, on the CPU: every
    check it makes on the card passes with the plain versions, and it
    gives no time (not measured)."""
    from genefuserust_tpu_torch.ops.index import build_packed_index
    from genefuserust_tpu_torch.profiling import device_merge

    mapper, block = device_merge.make_pairs(512, 3, str(tmp_path))
    index = index_to_torch(build_packed_index(mapper.indexer), "cpu")
    r = device_merge.run(block, index, reps=1, plain_reps=1, host_reps=1, oracle_pairs=512)
    c = r["checks"]
    assert c["merged"] == c["host_merged"] == c["oracle_merged"] > 300
    assert c["engine_lane_rows"] == c["rows_merged"] + c["rows_packed"]
    assert r["kernels"]["merge_codes"]["ms"] is None
    assert all(v["bound_by"] == "bytes" for v in r["kernels"].values())


@pytest.mark.parametrize("nbytes, ops, by", [(3.35e9, 1e9, "bytes"), (1e6, 6.7e10, "operations")])
def test_bound_takes_the_larger_time(nbytes, ops, by):
    b = bound(nbytes, ops)
    want = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    assert b["bound_by"] == by and b["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert (b["bytes"], b["ops"]) == (int(nbytes), int(ops))


# ---------------- the kernels on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_merge_bytes_kernel_matches_plain(merge_pairs, cuda_device):
    _, rows = merge_pairs
    got = tmg.merge_batch(*(_t(x).to(cuda_device) for x in rows))
    plain = tmg.merge_batch_plain(*(_t(x).to(cuda_device) for x in rows))
    cpu = tmg.merge_batch(*(_t(x) for x in rows))
    for g, p, e in zip(got, plain, cpu):
        assert torch.equal(g, p) and torch.equal(g.cpu(), e)
    assert cpu.merged.sum() > 20


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [False, True])
def test_merge_codes_kernel_matches_plain(panel_data, lanes, cuda_device):
    c = panel_data
    args = (_t(c["buf"]).to(cuda_device), _t(c["lens2"]).to(cuda_device), L)
    got = tf.merge_packed(*args, lanes=lanes)
    exp = tf.merge_codes_plain(*args, lanes=lanes)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    if lanes:
        assert all(torch.equal(g, e) and g.data_ptr() % 16 == 0
                   for g, e in zip(got[2], exp[2]))
        assert torch.equal(got[3], exp[3])


def _at_offset(x, off, device):
    """x as a contiguous tensor on `device` that starts `off` bytes into
    its allocation."""
    flat = torch.empty(x.size + off, dtype=torch.uint8, device=device)
    t = flat[off:].view(x.shape)
    t.copy_(_t(x))
    return t


@pytest.mark.cuda
def test_merge_rows_kernel_matches_plain(panel_data, cuda_device):
    c = _port_case(panel_data)
    idx, _, work, w7 = _work_lists(c)
    dev = lambda x: None if x is None else _t(x).to(cuda_device)
    m_codes, buf = dev(c["m_codes"]), dev(c["buf"])
    w7d, workd = dev(w7), dev(work)
    odd = dev(np.array([-1, B, 3], np.int32))
    cases = [(m_codes, None, dev(idx), None, 2 * L - MIN_OVERLAP, L),
             (None, buf, workd[:, 0], workd[:, 1], L, L),
             (m_codes, buf, w7d[:, 0], w7d[:, 1], 2 * L - MIN_OVERLAP, L),
             (m_codes, None, odd, None, 50, L)]
    # the edge shapes of the mirror's test, the sources 0-3 bytes past an
    # allocation's start
    rng = np.random.default_rng(3)
    for Lr in (75, 150, 33):
        mc, bf, more = _rows_edge_cases(rng, Lr)
        for k, (m, b, ix, ln, W) in enumerate(more):
            cases.append((None if m is None else _at_offset(m, k % 4, cuda_device),
                          None if b is None else _at_offset(b, (3 * k) % 4, cuda_device),
                          dev(ix), dev(ln), W, Lr))
    for mc, bf, ix, ln, W, Lr in cases:
        got = tf.merge_rows(mc, bf, ix, ln, W, Lr)
        assert torch.equal(got, tf.merge_rows_plain(mc, bf, ix, ln, W, Lr))


@pytest.mark.cuda
def test_fused_functions_on_the_card_match_cpu(panel_data, cuda_device):
    c = _port_case(panel_data)
    index = index_to_torch(c["packed"], cuda_device)
    buf, lens2 = _t(c["buf"]).to(cuda_device), _t(c["lens2"]).to(cuda_device)
    summary, m_codes = tf.fused_pass1_chunked(buf, lens2, index, L, CHUNK)
    assert (summary.cpu().numpy() == c["summary"]).all()
    assert (m_codes.cpu().numpy() == c["m_codes"]).all()
    idx, lens, work, w7 = _work_lists(c)
    got = tf.pass1_rows_merged(m_codes, _t(idx).to(cuda_device), _t(lens).to(cuda_device),
                               index, 2 * L)
    assert torch.equal(got.cpu(), tf.pass1_rows_merged(_t(c["m_codes"]), _t(idx), _t(lens),
                                                       c["index"], 2 * L))
    got = tf.pass1_rows_packed(buf, _t(work).to(cuda_device), index, L)
    assert torch.equal(got.cpu(), tf.pass1_rows_packed(_t(c["buf"]), _t(work), c["index"], L))
    got = tf.fused_pass2_combined(m_codes, buf, _t(w7).to(cuda_device), index, L)
    assert torch.equal(got.cpu(), tf.fused_pass2_combined(_t(c["m_codes"]), _t(c["buf"]),
                                                          _t(w7), c["index"], L))
