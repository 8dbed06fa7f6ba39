"""The port's contig-sharded index (`parallel/sharded_index.py`) against
the JAX package's: the shard tables array for array, the sharded map_read
against `build_sharded_map_read` on virtual CPU devices, and each new
kernel's plain version and Python mirror against its JAX counterpart.
All comparisons are exact (integers)."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.sequence import encode_bases, reverse_complement
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.hashtable import EMPTY
from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
from genefuserust_tpu_torch.parallel import sharded_index as tsi
from test_torch_map_read import (
    M32,
    _ballots,
    _below,
    _kmer_flags,
    _last_head,
    _linked,
    _mask_route,
    _next_linked,
    _row_words,
    _segment,
    _window16,
    _word_chains,
)

MOTIF = "ACGTTGCAACGGTTACGATCCAGTTACG"
CPU = torch.device("cpu")


def _plant(panel, gene, offsets):
    _, chrom, start, _ = panel.genes[gene]
    s = panel.contigs[chrom]
    for off in offsets:
        s = s[: start + off] + MOTIF + s[start + off + len(MOTIF):]
    panel.contigs[chrom] = s


def _indexer(panel, tmp):
    _, csv = write_panel_files(panel, str(tmp))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv), Settings())
    ix.make_index()
    return ix


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """'six': the JAX test's 6-gene panel with a motif planted in genes
    owned by different shards (a dupe list split across shards) and 8
    times in one gene (a high-level dupe); 'two': the 2-gene panel with
    dupes, which leaves a third shard without any k-mer."""
    six = make_panel(n_genes=6, chrom_len=20000, gene_len=8000)
    _plant(six, 0, [1000, 3000])
    _plant(six, 3, [2000])
    _plant(six, 5, [500 + 900 * k for k in range(8)])
    two = make_panel(seed=11)
    _plant(two, 0, [1000, 3000, 7000])
    _plant(two, 1, [500 + 1100 * k for k in range(8)])
    out = {}
    for name, panel in (("six", six), ("two", two)):
        ix = _indexer(panel, tmp_path_factory.mktemp(name))
        assert ix.kmer_dupe and ix.kmer_high
        out[name] = panel, ix
    return out


def _reads(panel):
    """The JAX sharded test's reads (junctions between genes of different
    shards, in-gene reads, an RC), plus seeded random reads, RC reads,
    reads through the motif and reads with N."""
    rng = np.random.default_rng(0)
    n = len(panel.genes)
    genes = [(panel.contigs[c], s) for _, c, s, _ in panel.genes]
    reads = []
    for a in range(n // 2):
        for b in range(n // 2, n):
            (sa, ga), (sb, gb) = genes[a], genes[b]
            fused = sa[ga + 4000 - 150 : ga + 4001] + sb[gb + 3000 : gb + 3150]
            off = 40 + int(rng.integers(0, 30))
            reads.append(fused[off : off + 160])
    for s, g in genes:
        off = g + int(rng.integers(0, 2000))
        reads.append(s[off : off + 160])
    reads.append(reverse_complement(reads[0]))
    for _ in range(12):
        s, g = genes[int(rng.integers(n))]
        off = int(rng.integers(0, len(s) - 160))
        r = s[off : off + int(rng.integers(60, 161))]
        reads.append(reverse_complement(r) if rng.random() < 0.3 else r)
    s, g = genes[0]
    reads += [s[g + 990 : g + 1140], s[g + 2950 : g + 3030] + genes[-1][0][genes[-1][1] + 5000:
                                                                         genes[-1][1] + 5070]]
    r = list(reads[1])
    for p in rng.integers(0, len(r), 3):
        r[int(p)] = "N"
    reads += ["".join(r), "N" * 150, "ACGT" * 5]
    return reads


def _batch(reads, L=160):
    codes = np.full((len(reads), L), 255, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_bases(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens


def _segments(valid, start, end, contig, pos):
    valid, start, end, contig, pos = (np.asarray(x) for x in (valid, start, end, contig, pos))
    return [[(int(start[i, t]), int(end[i, t]), int(contig[i, t]), int(pos[i, t]))
             for t in range(2) if valid[i, t]] for i in range(valid.shape[0])]


# ---------------- the shard tables ----------------


@pytest.mark.parametrize("name,S", [("six", 1), ("six", 3), ("six", 4), ("two", 3)])
def test_pack_index_sharded_matches_jax(panels, name, S):
    from genefuserust_tpu.parallel import sharded_index as jsi

    _, ix = panels[name]
    owner_j, packs_j = jsi.pack_index_sharded(ix, S)
    owner_t, packs_t = tsi.pack_index_sharded(ix, S)
    assert np.array_equal(owner_t, owner_j) and len(packs_t) == S
    exp = jsi.stack_packs(packs_j)
    got = tsi.stack_packs(packs_t)
    for g, e in zip(got[:3], exp[:3]):
        assert g.dtype == e.dtype and np.array_equal(g, e)
    assert got[3:] == exp[3:]
    for pt, pj in zip(packs_t, packs_j):
        assert (pt.n_buckets, pt.shift, pt.max_dupe, pt.empty_key) == (
            pj.n_buckets, pj.shift, pj.max_dupe, pj.empty_key)
        assert np.array_equal(pt.dupes, pj.dupes) and np.array_equal(pt.table, pj.table)
    if name == "two":  # the third shard owns no contig: the empty pack
        assert packs_t[2].max_dupe == 1 and (packs_t[2].table[:, :, 1] == EMPTY).all()


# ---------------- the sharded map_read ----------------


def _jax_sharded(ix, S, reads, L=160):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from genefuserust_tpu.parallel import sharded_index as jsi

    _, packs = jsi.pack_index_sharded(ix, S)
    keys, vals, dupes, shift, D = jsi.stack_packs(packs)
    codes, lens = _batch(reads, L)
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    fn = jsi.build_sharded_map_read(mesh, shift, D, L)
    return fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(keys), jnp.asarray(vals),
              jnp.asarray(dupes))


@pytest.mark.parametrize("common", [True, False])
@pytest.mark.parametrize("name,S", [("six", 4), ("six", 3), ("two", 3)])
def test_sharded_map_read_matches_jax(panels, name, S, common):
    """Every valid segment equal to JAX's on S virtual CPU devices, with
    the dupe tables at their common width (stack_packs) or each at its own;
    and to the host oracle."""
    panel, ix = panels[name]
    reads = _reads(panel)
    exp = _segments(*_jax_sharded(ix, S, reads))
    _, packs = tsi.pack_index_sharded(ix, S)
    indexes = (tsi.shard_indexes(packs, [CPU] * S) if common
               else [index_to_torch(p, CPU) for p in packs])
    widths = {i.D for i in indexes}
    assert len(widths) == 1 if common else len(widths) > 1
    codes, lens = _batch(reads)
    r = tsi.sharded_map_read(torch.from_numpy(codes), torch.from_numpy(lens), indexes)
    got = _segments(*(x.numpy() for x in r))
    assert got == exp
    oracle = [[(s.seq_start, s.seq_end, s.start_gp.contig, s.start_gp.position)
               for s in ix.map_read(rd)] for rd in reads]
    assert got == oracle
    # the junction reads of genes on different shards map
    assert sum(len(g) == 2 for g in got) >= (6 if name == "six" else 1)


def test_sharded_s1_equals_single_table(panels):
    """One shard: every output of sharded_map_read equals the single-table
    map_read_batch on the split layout, the fill-in keys of rows without a
    second entry included."""
    panel, ix = panels["six"]
    reads = _reads(panel)
    codes, lens = (torch.from_numpy(a) for a in _batch(reads))
    _, packs = tsi.pack_index_sharded(ix, 1)
    got = tsi.sharded_map_read(codes, lens, tsi.shard_indexes(packs, [CPU]))
    exp = tm.map_read_batch(codes, lens, index_to_torch(build_packed_index(ix, "split"), CPU))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert got.seg_valid.all(1).sum() >= 4


# ---------------- the new kernels' plain versions and mirrors ----------------


def _merge_cases(S, seed):
    """(S, B, 6) counts-mode rows: positive counts with ties on count and
    on hi (lo compared unsigned), zero and negative counts, rows with one
    or no positive entry."""
    rng = np.random.default_rng(seed)
    B = 300
    v = np.zeros((S, B, 6), np.int64)
    v[:, :, [0, 3]] = rng.choice([-1, 0, 3, 5, 5, 12, 40], size=(S, B, 2))
    v[:, :, [1, 4]] = rng.integers(0, 3, (S, B, 2))
    v[:, :, [2, 5]] = rng.choice([-2, -1, 0, 1, 7, 2**31 - 1, -(2**31)], size=(S, B, 2))
    v[:, 0, [0, 3]] = 0  # no positive count
    v[:, 1, [0, 3]] = 0
    v[0, 1, 0] = 9  # one positive count
    # the same key never carries a positive count twice (a gplong has one
    # owner shard, and a shard's two entries differ): shift clashes apart
    keys = v[:, :, [1, 2, 4, 5]].reshape(S, B, 2, 2)
    for b in range(B):
        seen = set()
        for s in range(S):
            for e in range(2):
                k = tuple(keys[s, b, e])
                while v[s, b, 3 * e] > 0 and k in seen:
                    keys[s, b, e, 1] += 1
                    k = tuple(keys[s, b, e])
                seen.add(k)
    v[:, :, [1, 2, 4, 5]] = keys.reshape(S, B, 4)
    return torch.from_numpy(((v + 2**31) % 2**32 - 2**31).astype(np.int32))


MAX_SHARDS = 8  # shard counts merge_top2_kernel is built for (csrc/vote.cu)
MERGE_ROWS = 64  # its rows a block


def _merge_before(a, b):
    (ca, ha, la), (cb, hb, lb) = a, b
    if (ca > 0) != (cb > 0):
        return ca > 0
    if ca <= 0:
        return False
    if ca != cb:
        return ca > cb
    if ha != hb:
        return ha < hb
    return (la & 0xFFFFFFFF) < (lb & 0xFFFFFFFF)


def _top2(x, lo, n):
    """merge_top2_kernel's tournament over x[lo, lo + n): the halves' top
    twos; the left's first unless the right's first precedes it; the
    second the better of the two that can be second (the earlier one on a
    tie) -> (first, second or None)."""
    if n == 1:
        return x[lo], None
    h = n // 2
    a1, a2 = _top2(x, lo, h)
    b1, b2 = _top2(x, lo + h, n - h)
    if _merge_before(b1, a1):
        return b1, (a1 if b2 is None or not _merge_before(b2, a1) else b2)
    return a1, (b1 if a2 is None or _merge_before(b1, a2) else a2)


def _kernel_merge_top2(votes, major_req=40, minor_req=20, step=2):
    """merge_top2_kernel step for step on the shards' (B, 6) rows (a list,
    read where they lie): blocks of MERGE_ROWS rows, a thread a row; the
    kernel built for S shards holds the 2S candidates, shard s's first
    entry x[s] and its second x[S + s], and finds the top two by the
    tournament `_top2` -> (ok, gp)."""
    S, B = len(votes), votes[0].shape[0]
    assert 1 <= S <= MAX_SHARDS
    v = [t.numpy().astype(np.int64) for t in votes]
    ok = np.zeros(B, bool)
    gp = np.zeros((B, 4), np.int64)
    for blk in range(-(-B // MERGE_ROWS)):
        for b in range(blk * MERGE_ROWS, min(B, (blk + 1) * MERGE_ROWS)):
            x = [tuple(v[s][b, 0:3]) for s in range(S)] + [tuple(v[s][b, 3:6])
                                                           for s in range(S)]
            g1, g2 = _top2(x, 0, 2 * S)
            c1, c2 = max(g1[0], 0), max(g2[0], 0)
            ok[b] = c1 * step >= major_req and c2 * step >= minor_req
            gp[b] = [g1[1], g1[2], g2[1], g2[2]]
    return ok, gp.astype(np.int32)


def _jax_merge(votes, major_req=40, minor_req=20):
    """JAX's _merge_top2 and the gate of build_sharded_map_read on the
    shards' (B, 6) rows -> (ok, (g1c, g2c), gp)."""
    import jax.numpy as jnp

    from genefuserust_tpu.parallel.sharded_index import _merge_top2

    v = np.stack([t.numpy() for t in votes])
    cand = [np.concatenate([v[:, :, j], v[:, :, j + 3]], 0).T for j in range(3)]
    g1h, g1l, g1c, g2h, g2l, g2c = (np.asarray(x) for x in _merge_top2(
        *(jnp.asarray(c) for c in cand)))
    ok = (g1c * 2 >= major_req) & (g2c * 2 >= minor_req)
    return ok, (g1c, g2c), np.stack([g1h, g1l, g2h, g2l], 1)


def _check_merge(votes, major_req=40, minor_req=20):
    """merge_top2 (plain here) and the kernel's mirror against each other
    and against JAX: the gate everywhere, a (hi, lo) wherever its count is
    positive (JAX's sort leaves the order of the rest open) -> JAX's
    (ok, counts)."""
    ok, gp = (t.numpy() for t in tm.merge_top2(votes, major_req, minor_req))
    p_ok, p_gp = (t.numpy() for t in tm.merge_top2_plain(votes, major_req, minor_req))
    m_ok, m_gp = _kernel_merge_top2(votes, major_req, minor_req)
    B = votes[0].shape[0]
    assert ok.dtype == bool and ok.shape == (B,) and gp.dtype == np.int32 and gp.shape == (B, 4)
    assert np.array_equal(ok, p_ok) and np.array_equal(gp, p_gp)
    assert np.array_equal(ok, m_ok) and np.array_equal(gp, m_gp)
    j_ok, (g1c, g2c), j_gp = _jax_merge(votes, major_req, minor_req)
    assert np.array_equal(ok, j_ok)
    for cnt, cols in ((g1c, [0, 1]), (g2c, [2, 3])):
        pos = cnt > 0
        assert np.array_equal(gp[pos][:, cols], j_gp[pos][:, cols])
    return j_ok, (g1c, g2c)


@pytest.mark.parametrize("S", range(1, MAX_SHARDS + 1))
def test_merge_top2_matches_jax(S):
    """merge_top2_plain and the kernel's mirror against JAX's _merge_top2
    and gate on S shards' rows with count and hi ties."""
    ok, (_, g2c) = _check_merge(list(_merge_cases(S, seed=S)))
    assert ok.any() and (~ok).any() and (g2c == 0).any()


def _merge_edges(S, B, seed):
    """S shards' (B, 6) rows built to test the order's and the gate's
    edges, row b by b % 6: counts tied and broken by hi; tied on hi and
    broken by lo, one lo at or past 2^31 (negative as int32); one entry
    with a count <= 0; both of a shard's entries <= 0; a first count that
    meets the gate exactly (c * 2 == 40) with a second that meets its own
    (c * 2 == 20); the same one short of each."""
    rng = np.random.default_rng(seed)
    v = np.zeros((S, B, 6), np.int64)
    for b in range(B):
        kind = b % 6
        cnt = rng.choice([4, 7, 20, 31], size=(S, 2))
        hi = rng.integers(0, 2**20, (S, 2))
        lo = rng.integers(0, 2**32, (S, 2))
        if kind == 0:  # ties on the count, broken by hi
            cnt[:] = 25
        elif kind == 1:  # ties on count and hi, broken by lo (unsigned)
            cnt[:], hi[:] = 25, 7
            lo[0, 0] = 2**31 + 5
            lo.flat[-1] = 2**31 - 5
        elif kind == 2:  # counts <= 0 in one entry of each shard
            cnt[:, 1] = rng.choice([0, -1, -(2**20)], S)
        elif kind == 3:  # both of a shard's entries <= 0
            cnt[rng.integers(0, S)] = [0, -3]
        elif kind == 4:  # the gate exactly
            cnt[:] = 1
            cnt[0, 0], cnt[-1, 1] = 20, 10
        else:  # one short of it
            cnt[:] = 1
            cnt[0, 0], cnt[-1, 1] = 19, 9
        v[:, b, [0, 3]], v[:, b, [1, 4]], v[:, b, [2, 5]] = cnt, hi, lo
    # a key holds a positive count on one shard at most
    keys = v[:, :, [1, 2, 4, 5]].reshape(S, B, 2, 2)
    for b in range(B):
        seen = set()
        for s in range(S):
            for e in range(2):
                while v[s, b, 3 * e] > 0 and tuple(keys[s, b, e]) in seen:
                    keys[s, b, e, 1] += 1
                seen.add(tuple(keys[s, b, e]))
    v[:, :, [1, 2, 4, 5]] = keys.reshape(S, B, 4)
    t = torch.from_numpy(((v + 2**31) % 2**32 - 2**31).astype(np.int32))
    return [x.contiguous() for x in t]


@pytest.mark.parametrize("B", [0, 1, 63, 64, 65])
@pytest.mark.parametrize("S", [1, 2, 5, 8])
def test_merge_top2_mirror_edges(S, B):
    """The mirror, plain and JAX at row counts around the kernel's block
    of 64 rows, on rows that break ties by hi and by lo past 2^31, hold
    counts <= 0 in one or both entries, and meet the gate exactly or miss
    it by one."""
    ok, _ = _check_merge(_merge_edges(S, B, seed=S * 100 + B))
    if B > 5:
        assert ok[4::6].all() and not ok[5::6].any()


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_vote_counts_plain_matches_jax(layout):
    """The counts mode's plain version against JAX top2_votes' counts and
    keys on vote_edge_rows (warp and block path rows, ties, key 0)."""
    import jax.numpy as jnp

    from genefuserust_tpu.config import PASS1_STEP
    from genefuserust_tpu.ops import map_read as jm
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    pr, packed, names = vote_edge_rows(seed=5, layout=layout)
    index = index_to_torch(packed, CPU)
    c, p = jnp.asarray(pr[..., 0].numpy()), jnp.asarray(pr[..., 1].numpy())
    if hasattr(packed, "kv_tbl"):
        cc, cp, cv = jm.expand_candidates_kv(c, p, jnp.asarray(packed.dupes), packed.max_dupe,
                                             packed.cbits, packed.pos_bias)
    else:
        cc, cp, cv = jm.expand_candidates(c, p, jnp.asarray(packed.dupes), packed.max_dupe)
    B, NS, D = cc.shape
    i_idx = jnp.arange(NS, dtype=jnp.int32)[None, :, None] * PASS1_STEP
    h1, l1, c1, h2, l2, c2 = jm.top2_votes(cc.reshape(B, -1), (cp - i_idx).reshape(B, -1),
                                           cv.reshape(B, -1))
    exp = np.stack([np.asarray(x).astype(np.int32) for x in (c1, h1, l1, c2, h2, l2)], 1)
    got = tm.vote_counts_plain(pr, index).numpy()
    assert np.array_equal(got, exp), [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    assert (got[:, 0] >= 40).any() and (got[:, 3] == 0).any() and (got[:, 3] > 0).any()


def _flag_case(index, B=24, NK=200, seed=0):
    """Pass-2 probe results with hits on and next to two keys, misses,
    high dupes and dupe rows, and random (h1, l1, h2, l2)."""
    rng = np.random.default_rng(seed)
    nd = index.dupes.shape[0]
    pr = np.zeros((B, NK, 2), np.int64)
    gp = np.zeros((B, 4), np.int64)
    for b in range(B):
        g = [(int(rng.integers(0, 3)), int(rng.integers(-50, 5000))) for _ in range(2)]
        gp[b] = [g[0][0], g[0][1], g[1][0], g[1][1]]
        for i in range(NK):
            kind = rng.integers(6)
            if kind < 2:
                c, lo = g[kind]
                pr[b, i] = (c, lo + i + int(rng.integers(-2, 3)))
            elif kind == 2:
                pr[b, i] = (-1, int(rng.integers(0, nd)))  # DUPE
            elif kind == 3:
                pr[b, i] = (-2, 0)  # HIGH
            else:
                pr[b, i] = (EMPTY, 0)
    return _wrap32(pr), _wrap32(gp)


def _wrap32(a):
    """int64 array -> int32 tensor of its low 32 bits."""
    return torch.from_numpy(((a + 2**31) % 2**32 - 2**31).astype(np.int32))


def _kernel_shard_flags(prs, lengths, gp, indexes, words=None):
    """shard_flags_kernel step for step: a warp a (row, span of 32 words),
    a word a lane. Only the row's own k-mers (below its length - 15) are
    read; per shard, the chunks' two ballots are ORed into the lane of the
    chunk's word. `words` None: every word of the span stored (zero past
    the row's own chunks); else ORed into the row's own words."""
    span = 32  # FLAGS_SPAN in csrc/mask_segments.cu
    B, NK = prs[0].shape[:2]
    L = NK + 15
    nw = tm.flag_words(NK)
    flags = [_kmer_flags(pr, gp, ix) for pr, ix in zip(prs, indexes)]
    out = (np.zeros((B, nw, 2), np.int64) if words is None
           else words.numpy().astype(np.int64) & 0xFFFFFFFF)
    for b in range(B):
        nk = max(0, min(int(lengths[b]), L) - 15)
        own = -(-nk // 32)
        for c0 in range(0, nw, span):
            ce = min(c0 + span, own)
            lanes = np.zeros((span, 2), np.int64)
            for f3, f2 in flags:
                for c in range(c0, ce):
                    i = np.arange(32 * c, 32 * c + 32)
                    inside = i < nk
                    w3 = _ballots(f3[b, np.minimum(i, NK - 1)] & inside, 1)[0]
                    w2 = _ballots(f2[b, np.minimum(i, NK - 1)] & inside, 1)[0]
                    lanes[c - c0] |= (w3, w2)
            for lane in range(span):
                w = c0 + lane
                if words is None and w < nw:
                    out[b, w] = lanes[lane]
                elif words is not None and w < ce:
                    out[b, w] |= lanes[lane]
    return _wrap32(out)


def _flags_segment(nw):
    """The lanes a row takes on mask_from_flags' narrow launch."""
    return 8 if nw <= 8 else 16 if nw <= 16 else 32


def _seg_words(wrow, r, SEG, nwr, lim, prev):
    """seg_word over one round's lanes: each lane's word w = r * SEG + sl,
    its flags (zero from nwr on), window, in-bounds mask words and linked
    bases, the previous word from the previous lane (lane 0: `prev`, the
    previous round's last word) -> ([per lane (f3, f2, a3, a2, k3, k2)],
    the round's mismatches)."""
    lanes, miss = [], 0
    for sl in range(SEG):
        w = r * SEG + sl
        f3, f2 = (int(wrow[w, 0]), int(wrow[w, 1])) if w < nwr else (0, 0)
        p = lanes[sl - 1] if sl else prev
        inb = _below(w, lim)
        m2 = _window16(f2, p[1])
        a3, a2 = _window16(f3, p[0]) & inb, m2 & inb
        miss += bin(~m2 & inb & M32).count("1")
        k3 = _linked(a3, p[2], 0, 0)
        k2 = _linked(a2 & ~a3 & M32, p[3] & ~p[2] & M32, a3, p[2])
        lanes.append((f3, f2, a3, a2, k3, k2))
    return lanes, miss


def _seg_row(wrow, n, L, nw, mismatch_thr):
    """mask_from_flags_kernel (narrow) on one row: a segment of SEG lanes,
    rounds of SEG words up to the row's own last word, a word's next from
    the next lane or the next round's lane 0, the heads carried by a
    segmented max-scan and a carry over rounds -> [v3, v2, s3, s2, e3, e2]."""
    SEG = _flags_segment(nw)
    lim = min(n, L)
    nwr = -(-lim // 32)
    rounds = -(-nwr // 32) if SEG == 32 else 1
    zero = (0,) * 6
    cur, miss = _seg_words(wrow, 0, SEG, nwr, lim, zero)
    best, carry = {3: 0, 2: 0}, {3: -1, 2: -1}
    for r in range(rounds):
        nxt, m = _seg_words(wrow, r + 1, SEG, nwr, lim, cur[-1]) if r + 1 < rounds else \
            ([zero] * SEG, 0)
        miss += m
        heads, ends = {3: [], 2: []}, {3: [], 2: []}
        for sl in range(SEG):
            w = r * SEG + sl
            _, _, a3, a2, k3, k2 = cur[sl]
            _, _, n3, n2, nk3, nk2 = cur[sl + 1] if sl + 1 < SEG else nxt[0]
            o2, no2, last = a2 & ~a3 & M32, n2 & ~n3 & M32, _below(w, n - 1)
            h3, h2 = a3 & ~k3 & last, o2 & ~k2 & last
            heads[3].append(h3)
            heads[2].append(h2)
            ends[3].append((k3 | h3) & ~_next_linked(k3, nk3, a3, n3) & M32)
            ends[2].append((k2 | h2) & ~_next_linked(k2, nk2, o2, no2) & M32)
        for t in (3, 2):
            scan = np.maximum.accumulate([_last_head(r * SEG + sl, heads[t][sl])
                                          for sl in range(SEG)])
            for sl in range(SEG):
                before = max(carry[t], int(scan[sl - 1]) if sl else -1)
                best[t] = max(best[t], _word_chains(r * SEG + sl, heads[t][sl], ends[t][sl],
                                                    before, 16, 0xFFFF))
            carry[t] = max(carry[t], int(scan[-1]))
        cur = nxt
    ok = int(miss <= mismatch_thr)
    (v3, s3, e3), (v2, s2, e2) = (_segment(best[t], 16, 0xFFFF) for t in (3, 2))
    return [v3 & ok, v2 & ok, s3, s2, e3, e2]


def _kernel_mask_from_flags(words, lengths, gp, NK, mismatch_thr=10, wide=False):
    """mask_from_flags_kernel step for step (_seg_row: a row on a segment
    of 8, 16 or 32 lanes, shuffles for neighbour words, each row's own
    words only). `wide`: the wide launch, a word a lane over a row's own
    words, the window of (this, previous) word, then the chain steps of
    mask_segments (`_kernel_segments`), a long row by the block
    (`_block_segments`, the route of `_mask_route`)."""
    B, nw, _ = words.shape
    L = NK + 15
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    out = np.zeros((B, 10), np.int64)
    for b in range(B):
        n = int(lengths[b])
        if not wide:
            out[b] = _seg_row(w[b], n, L, nw, mismatch_thr) + gp[b, [0, 2, 1, 3]].tolist()
            continue
        nwr = -(-min(n, L) // 32)
        m3 = [_window16(int(w[b, c, 0]), int(w[b, c - 1, 0]) if c else 0) for c in range(nwr)]
        m2 = [_window16(int(w[b, c, 1]), int(w[b, c - 1, 1]) if c else 0) for c in range(nwr)]
        out[b] = _row_words(m3, m2, n, L, mismatch_thr, wide, _mask_route(n, L)) + \
            gp[b, [0, 2, 1, 3]].tolist()
    return out


def _probe_like(pr, lengths):
    """pr with every k-mer from a row's length - 15 on EMPTY, as the probe
    writes them (test_probe_results_past_a_row_length_are_empty)."""
    nk = (lengths.long() - 15).clamp(min=0)
    past = torch.arange(pr.shape[1])[None, :] >= nk[:, None]
    return torch.where(past[..., None], torch.tensor([EMPTY, 0], dtype=torch.int32), pr)


def _jax_flags(prs, gp, indexes):
    """JAX's pass-2 flags of each shard (_eq_pm1 on its candidates) and
    their max over the shards (the pmax) -> (B, NK) jnp int32."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    flags = []
    g = gp.numpy()
    for pr, index in zip(prs, indexes):
        keys, cv = tm._keys_at(index, pr, 1)
        hi, lo = (keys >> 32).to(torch.int32).numpy(), tm._i32(keys).numpy()
        m1 = jm._eq_pm1(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(g[:, 0, None, None]),
                        jnp.asarray(g[:, 1, None, None]))
        m2 = jm._eq_pm1(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(g[:, 2, None, None]),
                        jnp.asarray(g[:, 3, None, None]))
        cvj = jnp.asarray(cv.numpy())
        flags.append(jnp.max(jnp.where(cvj & m1, 3, jnp.where(cvj & m2, 2, 0)), axis=2))
    flag = flags[0]
    for f in flags[1:]:
        flag = jnp.maximum(flag, f)
    return flag


def _flag_bits(flag):
    """(B, NK) flags -> the (B, nw, 2) int32 words of the flag planes."""
    f = np.asarray(flag)
    nw = tm.flag_words(f.shape[1])
    return _wrap32(np.stack([np.array([_ballots(r == 3, nw) for r in f], np.int64),
                             np.array([_ballots(r >= 2, nw) for r in f], np.int64)], -1))


def _jax_from_flags(flag, lengths, mismatch_thr=10):
    """JAX's pass 2 after the flags: the 16-wide window, the mismatch
    count and extract_segments -> (B, 6) [v3, v2, s3, s2, e3, e2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    flag = jnp.asarray(np.asarray(flag))
    B, NK = flag.shape
    L = NK + 15
    padded = jnp.concatenate([jnp.zeros((B, 15), flag.dtype), flag,
                              jnp.zeros((B, 15), flag.dtype)], 1)
    mask = jnp.zeros((B, L), flag.dtype)
    for j in range(16):
        mask = jnp.maximum(mask, padded[:, 15 - j : 15 - j + L])
    lj = jnp.asarray(lengths.numpy())
    within = jnp.arange(L)[None, :] < lj[:, None]
    read_ok = np.asarray(jnp.sum((mask < 2) & within, axis=1) <= mismatch_thr)
    (v3, s3, e3), (v2, s2, e2) = ((np.asarray(x) for x in jm.extract_segments(mask, lj, t))
                                  for t in (3, 2))
    return np.stack([v3 & read_ok, v2 & read_ok, s3, s2, e3, e2], 1).astype(np.int64)


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_flags_and_mask_from_flags_match_jax_pass2(panels, layout):
    """Two shards' flags (each a table's candidates) ORed together, then
    mask+segments from the words: the plain versions and the kernels'
    mirrors against JAX's pass 2 on the max of the two shards' flags. The
    probe results past a row's length are EMPTY, as the probe writes them;
    the two shards in one launch, and in two (the second ORs)."""
    _, ix = panels["two"]
    index = index_to_torch(build_packed_index(ix, layout), CPU)
    (pa, gp), (pb, _) = _flag_case(index, seed=1), _flag_case(index, seed=2)
    B, NK = pa.shape[:2]
    lengths = torch.from_numpy(np.random.default_rng(3).integers(0, NK + 16, B).astype(np.int32))
    lengths[:4] = NK + 15
    pa, pb = _probe_like(pa, lengths), _probe_like(pb, lengths)
    words = tm.shard_flags([pa, pb], lengths, gp, [index, index])
    assert torch.equal(words, _kernel_shard_flags([pa, pb], lengths, gp, [index, index]))
    first = tm.shard_flags([pa], lengths, gp, [index])
    mirror = _kernel_shard_flags([pa], lengths, gp, [index])
    assert torch.equal(first, mirror)
    assert torch.equal(tm.shard_flags([pb], lengths, gp, [index], first), words)
    assert torch.equal(_kernel_shard_flags([pb], lengths, gp, [index], mirror), words)
    flag = _jax_flags([pa, pb], gp, [index, index])
    assert torch.equal(words, _flag_bits(flag))
    got = tm.mask_from_flags(words, lengths, gp, NK, 10).numpy()
    assert np.array_equal(got, _kernel_mask_from_flags(words, lengths, gp, NK))
    # JAX: the flags of each shard (_eq_pm1 on its candidates), their max,
    # the window, the mismatch count and extract_segments
    assert np.array_equal(got[:, :6], _jax_from_flags(flag, lengths))
    assert got[:, 0].any() or got[:, 1].any() or (got[:, 4] > 0).any()


# ---------------- pass 2 of the sharded path: edge rows, groups, word counts ----------------


def _edge_reads(panel):
    """_reads plus rows the sharded pass 2 must bound by their lengths:
    empty rows (the sharded engine pads its batch to a power of two with
    them), rows of 1-17 bases, rows whose last k-mer ends a chunk of 32
    (lengths 47 and 143: 32 and 128 k-mers) or starts one (48, 144), and
    one long read (1,100 bases, two spans of 32 words) that pads the rest."""
    reads = _reads(panel)
    _, chrom, start, _ = panel.genes[0]
    s = panel.contigs[chrom]
    reads += ["", ""] + [s[start + 900 : start + 900 + n] for n in (1, 15, 16, 17, 47, 48, 143,
                                                                    144)]
    reads.insert(5, s[start + 2000 : start + 3100])
    return reads


@pytest.mark.parametrize("layout,stride", [("kv2", 1), ("kv2", 2), ("split", 1), ("split", 2)])
def test_probe_results_past_a_row_length_are_empty(panels, layout, stride):
    """What the bounded shard flags rest on: the probe writes EMPTY for
    every k-mer from a row's length - 15 on, even where the code row holds
    valid bases there."""
    panel, ix = panels["six"]
    index = index_to_torch(build_packed_index(ix, layout), CPU)
    _, chrom, start, _ = panel.genes[3]
    s = panel.contigs[chrom]
    rng = np.random.default_rng(stride)
    lens = np.array([0, 1, 15, 16, 17, 31, 32, 47, 48, 100, 159, 160], np.int32)
    offs = rng.integers(0, 6000, len(lens))
    codes = np.stack([encode_bases(s[start + o : start + o + 160]) for o in offs])
    pr = tm.probe(torch.from_numpy(codes), torch.from_numpy(lens), stride, index)
    nk = np.maximum(lens.astype(np.int64) - 15, 0)
    past = (np.arange(pr.shape[1])[None, :] * stride) >= nk[:, None]
    assert (pr[..., 0].numpy()[past] == EMPTY).all() and (pr[..., 1].numpy()[past] == 0).all()
    assert (pr[..., 0].numpy()[~past] != EMPTY).any()


@pytest.mark.parametrize("cap_shards", [1, 2, 3, 4])
def test_sharded_map_read_flag_groups_match_jax(panels, cap_shards, monkeypatch):
    """The sharded map_read with its shards' flags in groups of 1 to 4 (a
    cap of that many shards' probe results; the first launch stores, each
    later one ORs) on the edge rows at the long read's padded width: equal
    to JAX's build_sharded_map_read on 4 virtual devices."""
    panel, ix = panels["six"]
    reads = _edge_reads(panel)
    L = -(-max(map(len, reads)) // 32) * 32
    exp = _segments(*_jax_sharded(ix, 4, reads, L))
    _, packs = tsi.pack_index_sharded(ix, 4)
    codes, lens = (torch.from_numpy(a) for a in _batch(reads, L))
    shard = codes.shape[0] * (L - 15) * 8
    monkeypatch.setattr(tsi, "FLAGS_GROUP_BYTES", cap_shards * shard)
    groups = tsi.flag_groups(4, shard)
    assert [len(g) for g in groups] == {1: [1] * 4, 2: [2, 2], 3: [3, 1], 4: [4]}[cap_shards]
    r = tsi.sharded_map_read(codes, lens, tsi.shard_indexes(packs, [CPU] * 4))
    assert _segments(*(x.numpy() for x in r)) == exp
    assert sum(len(g) == 2 for g in exp) >= 6


def test_shard_flags_mirror_on_edge_rows(panels, monkeypatch):
    """The shard flags' mirror on 4 split shards' probe results of the edge
    rows (lengths 0-17, chunk edges, the long read's two spans): one launch
    over the 4 shards, and groups whose later launches OR, against plain
    and JAX's pmax of the shards' flags; then mask from flags against JAX."""
    panel, ix = panels["six"]
    reads = _edge_reads(panel)
    L = -(-max(map(len, reads)) // 32) * 32
    codes, lens = (torch.from_numpy(a) for a in _batch(reads, L))
    _, packs = tsi.pack_index_sharded(ix, 4)
    indexes = tsi.shard_indexes(packs, [CPU] * 4)
    _, gp = tm.merge_top2([tm.vote_counts(tm.probe(codes, lens, 2, x), x, lens)
                           for x in indexes], 40, 20)
    prs = [tm.probe(codes, lens, 1, x) for x in indexes]
    NK = L - 15
    assert tm.flag_words(NK) > 32  # the long row spans two warps
    words = tm.shard_flags(prs, lens, gp, indexes)
    assert torch.equal(_kernel_shard_flags(prs, lens, gp, indexes), words)
    mirror = _kernel_shard_flags(prs[:3], lens, gp, indexes[:3])
    assert torch.equal(_kernel_shard_flags(prs[3:], lens, gp, indexes[3:], mirror), words)
    monkeypatch.setattr(tsi, "FLAGS_GROUP_BYTES", codes.shape[0] * NK * 8)  # a shard a group
    assert torch.equal(tsi.device_flags(codes, lens, gp, indexes), words)
    flag = _jax_flags(prs, gp, indexes)
    assert torch.equal(words, _flag_bits(flag))
    assert (words[lens <= 15] == 0).all() and words.any()
    got = tm.mask_from_flags(words, lens, gp, NK, 10).numpy()
    assert np.array_equal(_kernel_mask_from_flags(words, lens, gp, NK), got)
    assert np.array_equal(got[:, :6], _jax_from_flags(flag, lens))
    assert got[:, 0].sum() >= 6


def _flag_rows(B, NK, lengths, seed):
    """(B, NK) k-mer flags 0/2/3 of a row's own k-mers: most rows as a
    junction read flags them (3 up to a split, 2 after it) with holes of
    1-30 k-mers (a hole past 15 k-mers leaves bases unmasked: chains that
    link across at most 10 of them and chains that break, and mismatches
    around the threshold), the rest sparse runs; noise past a row's length
    (the kernel must not read it)."""
    rng = np.random.default_rng(seed)
    f = np.zeros((B, NK), np.int32)
    for b in range(B):
        nk = max(0, min(int(lengths[b]), NK + 15) - 15)
        if nk and rng.random() < 0.7:
            split = int(rng.integers(0, nk + 1))
            f[b, :split], f[b, split:nk] = (3, 2) if rng.random() < 0.8 else (2, 3)
            for _ in range(int(rng.integers(0, 4))):
                a = int(rng.integers(0, nk))
                f[b, a : min(nk, a + int(rng.integers(1, 31)))] = 0
        elif nk:
            for _ in range(int(rng.integers(1, 6))):
                a = int(rng.integers(0, nk))
                run = f[b, a : min(nk, a + int(rng.integers(1, 90)))]
                run[:] = np.maximum(run, rng.choice([2, 3]))
        f[b, nk:] = rng.choice([0, 2, 3], NK - nk)
    return f


@pytest.mark.parametrize("nw", [1, 7, 8, 9, 16, 17, 32, 33, 132])
def test_mask_from_flags_mirror_at_word_counts(nw):
    """The narrow mask from flags at every segment width and its edges
    (8, 16 or 32 lanes a row; two rounds at 33 words), rows of different
    lengths sharing a warp (4 and 2 rows a warp), lengths 0-16, the full
    width and past it; at 132 words a 4,200-base row among rows of 150
    bases (width 4,224). Mirror, plain and JAX's window + extract_segments
    on the same flags, exactly."""
    L = 32 * nw - (5 if nw > 1 else 8)
    NK = L - 15
    assert tm.flag_words(NK) == nw
    rng = np.random.default_rng(nw)
    B = 41
    if nw == 132:
        lengths = np.full(B, 150)
        lengths[[3, 17]] = (4200, 4224)
    else:
        lengths = rng.integers(0, L + 1, B)
        lengths[:8] = [0, 1, 15, 16, L, L + 9, 32 * (nw - 1) + 1, 32 * nw - 1]
    lengths = torch.from_numpy(lengths.astype(np.int32))
    flag = _flag_rows(B, NK, lengths, seed=nw)
    words = _flag_bits(flag)
    gp = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 4)).astype(np.int32))
    got = tm.mask_from_flags(words, lengths, gp, NK, 10).numpy()
    assert np.array_equal(_kernel_mask_from_flags(words, lengths, gp, NK), got)
    assert np.array_equal(got[:, :6], _jax_from_flags(flag, lengths))
    assert np.array_equal(got[:, 6:], gp.numpy()[:, [0, 2, 1, 3]])
    if nw > 1:
        assert got[:, 0].any() and got[:, 1].any() and not got[:, 0].all()


# ---------------- the kernels on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_shard_flags_and_mask_kernels_match_plain(panels, layout, cuda_device):
    """_flag_case's two shards on the card: one launch, two launches (the
    second ORs), bit-equal to plain; mask from flags bit-equal."""
    _, ix = panels["two"]
    packed = build_packed_index(ix, layout)
    index, dev = index_to_torch(packed, CPU), index_to_torch(packed, cuda_device)
    (pa, gp), (pb, _) = _flag_case(index, seed=1), _flag_case(index, seed=2)
    lengths = torch.from_numpy(np.random.default_rng(3).integers(
        0, pa.shape[1] + 16, pa.shape[0]).astype(np.int32))
    pa, pb = _probe_like(pa, lengths), _probe_like(pb, lengths)
    exp = tm.shard_flags([pa, pb], lengths, gp, [index, index])
    pad, pbd, ld, gd = (t.to(cuda_device) for t in (pa, pb, lengths, gp))
    assert torch.equal(tm.shard_flags([pad, pbd], ld, gd, [dev, dev]).cpu(), exp)
    first = tm.shard_flags([pad], ld, gd, [dev])
    assert torch.equal(tm.shard_flags([pbd], ld, gd, [dev], first).cpu(), exp)
    NK = pa.shape[1]
    assert torch.equal(tm.mask_from_flags(exp.to(cuda_device), ld, gd, NK, 10).cpu(),
                       tm.mask_from_flags_plain(exp, lengths, gp, NK, 10))


@pytest.mark.cuda
def test_sharded_pass2_kernels_on_edge_rows(panels, cuda_device, monkeypatch):
    """The edge rows on 4 split shards on the card: the probe EMPTY past
    each row's length, the shard flags in one launch and in groups,
    sharded_map_read equal to the CPU's."""
    panel, ix = panels["six"]
    reads = _edge_reads(panel)
    L = -(-max(map(len, reads)) // 32) * 32
    codes, lens = (torch.from_numpy(a) for a in _batch(reads, L))
    _, packs = tsi.pack_index_sharded(ix, 4)
    cpu = tsi.shard_indexes(packs, [CPU] * 4)
    card = tsi.shard_indexes(packs, [cuda_device] * 4)
    cd, ld = codes.to(cuda_device), lens.to(cuda_device)
    _, gp = tm.merge_top2([tm.vote_counts(tm.probe(codes, lens, 2, x), x, lens)
                           for x in cpu], 40, 20)
    prs = [tm.probe(cd, ld, 1, x) for x in card]
    for pr, x in zip(prs, cpu):
        assert torch.equal(pr.cpu(), tm.probe(codes, lens, 1, x))
    exp = tm.shard_flags([p.cpu() for p in prs], lens, gp, cpu)
    gd = gp.to(cuda_device)
    assert torch.equal(tm.shard_flags(prs, ld, gd, card).cpu(), exp)
    shard = codes.shape[0] * (L - 15) * 8
    for cap in (shard, 2 * shard, 3 * shard):
        monkeypatch.setattr(tsi, "FLAGS_GROUP_BYTES", cap)
        assert torch.equal(tsi.device_flags(cd, ld, gd, card).cpu(), exp)
    got = tsi.sharded_map_read(cd, ld, card)
    for g, e in zip(got, tsi.sharded_map_read(codes, lens, cpu)):
        assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 7, 8, 9, 16, 17, 32, 33, 132])
def test_mask_from_flags_kernel_at_word_counts(nw, cuda_device):
    L = 32 * nw - (5 if nw > 1 else 8)
    NK = L - 15
    rng = np.random.default_rng(nw)
    B = 1000
    lengths = torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32))
    words = _flag_bits(_flag_rows(B, NK, lengths, seed=nw))
    gp = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 4)).astype(np.int32))
    got = tm.mask_from_flags(words.to(cuda_device), lengths.to(cuda_device), gp.to(cuda_device),
                             NK, 10)
    assert torch.equal(got.cpu(), tm.mask_from_flags_plain(words, lengths, gp, NK, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("S", range(1, MAX_SHARDS + 1))
def test_merge_top2_kernel_matches_plain(S, cuda_device):
    """The merge kernel on the shards' own rows (one launch, no stack) at
    _merge_cases' rows and at the edge rows of 0, 1, 63, 64 and 65 rows,
    bit-equal to plain, ok and gp."""
    from genefuserust_tpu_torch.ops import cuda

    cases = [list(_merge_cases(S, seed=S))] + [_merge_edges(S, B, seed=S * 100 + B)
                                               for B in (0, 1, 63, 64, 65)]
    for votes in cases:
        exp = tm.merge_top2_plain(votes, 40, 20)
        n0 = cuda.LAUNCHES["merge_top2"]
        got = tm.merge_top2([v.to(cuda_device) for v in votes], 40, 20)
        assert cuda.LAUNCHES["merge_top2"] == n0 + (1 if votes[0].shape[0] else 0)
        assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
        for g, e in zip(got, exp):
            assert torch.equal(g.cpu(), e)
