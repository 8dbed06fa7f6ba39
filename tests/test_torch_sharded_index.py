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
from test_torch_map_read import _ballots, _mask_route, _row_words, _window16

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


def _kernel_merge_top2(votes, major_req=40, minor_req=20, step=2):
    """merge_top2_kernel step for step: per row, the first candidate that
    no earlier one precedes, then the same among the rest."""
    S, B, _ = votes.shape
    v = votes.numpy().astype(np.int64)

    def before(a, b):
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

    out = np.zeros((B, 5), np.int64)
    for b in range(B):
        cand = [tuple(v[k % S, b, 0:3] if k < S else v[k % S, b, 3:6]) for k in range(2 * S)]
        i1 = 0
        for k in range(1, 2 * S):
            if before(cand[k], cand[i1]):
                i1 = k
        i2 = 1 if i1 == 0 else 0
        for k in range(2 * S):
            if k != i1 and before(cand[k], cand[i2]):
                i2 = k
        c1, c2 = max(cand[i1][0], 0), max(cand[i2][0], 0)
        out[b] = [int(c1 * step >= major_req and c2 * step >= minor_req),
                  cand[i1][1], cand[i1][2], cand[i2][1], cand[i2][2]]
    return out


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_merge_top2_matches_jax(S):
    """merge_top2_plain and the kernel's mirror against JAX's _merge_top2
    and gate: counts and the gate everywhere, a (hi, lo) wherever its
    count is positive (JAX's sort leaves the order of the rest open)."""
    import jax.numpy as jnp

    from genefuserust_tpu.parallel.sharded_index import _merge_top2

    votes = _merge_cases(S, seed=S)
    v = votes.numpy()
    cand = [np.concatenate([v[:, :, j], v[:, :, j + 3]], 0).T for j in range(3)]
    g1h, g1l, g1c, g2h, g2l, g2c = (np.asarray(x) for x in _merge_top2(
        *(jnp.asarray(c) for c in cand)))
    ok = (g1c * 2 >= 40) & (g2c * 2 >= 20)
    plain = tm.merge_top2_plain(votes, 40, 20).numpy()
    mirror = _kernel_merge_top2(votes)
    for got in (plain, mirror):
        assert np.array_equal(got[:, 0], ok)
        for cnt, cols, want in ((g1c, [1, 2], (g1h, g1l)), (g2c, [3, 4], (g2h, g2l))):
            pos = cnt > 0
            assert np.array_equal(got[pos][:, cols], np.stack(want, 1)[pos])
    assert np.array_equal(plain, mirror)
    assert ok.any() and (~ok).any() and (g2c == 0).any()


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


def _kernel_shard_flags(pr, gp, index, words):
    """shard_flags_kernel step for step: per (row, chunk of 32 k-mers) the
    two ballots, ORed into the row's words."""
    B, NK = pr.shape[:2]
    keys, cv = tm._keys_at(index, pr, 1)
    g1 = tm.gplong(gp[:, 0], gp[:, 1])[:, None, None]
    g2 = tm.gplong(gp[:, 2], gp[:, 3])[:, None, None]
    f3 = (cv & ((keys - g1).abs() <= 1)).any(-1).numpy()
    f2 = f3 | (cv & ((keys - g2).abs() <= 1)).any(-1).numpy()
    out = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for b in range(B):
        for c, (w3, w2) in enumerate(zip(_ballots(f3[b], -(-NK // 32)),
                                         _ballots(f2[b], -(-NK // 32)))):
            out[b, c, 0] |= w3
            out[b, c, 1] |= w2
    return torch.from_numpy(((out + 2**31) % 2**32 - 2**31).astype(np.int32))


def _kernel_mask_from_flags(words, lengths, gp, NK, mismatch_thr=10, wide=False):
    """mask_from_flags_kernel step for step: one word a lane, the window
    of (this, previous) word, popcounts, then the chain steps of
    mask_segments (`_kernel_segments`). `wide`: the wide launch, a row's
    words only up to its own length, a long row by the block
    (`_block_segments`, the route of `_mask_route`)."""
    B, nw, _ = words.shape
    L = NK + 15
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    out = np.zeros((B, 10), np.int64)
    for b in range(B):
        n = int(lengths[b])
        nwr = -(-min(n, L) // 32) if wide else nw
        m3 = [_window16(int(w[b, c, 0]), int(w[b, c - 1, 0]) if c else 0) for c in range(nwr)]
        m2 = [_window16(int(w[b, c, 1]), int(w[b, c - 1, 1]) if c else 0) for c in range(nwr)]
        route = _mask_route(n, L) if wide else "warp"
        out[b] = _row_words(m3, m2, n, L, mismatch_thr, wide, route) + \
            gp[b, [0, 2, 1, 3]].tolist()
    return out


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_flags_and_mask_from_flags_match_jax_pass2(panels, layout):
    """Two shards' flags (each a table's candidates) ORed together, then
    mask+segments from the words: the plain versions and the kernels'
    mirrors against JAX's pass 2 on the max of the two shards' flags."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    _, ix = panels["two"]
    index = index_to_torch(build_packed_index(ix, layout), CPU)
    (pa, gp), (pb, _) = _flag_case(index, seed=1), _flag_case(index, seed=2)
    B, NK = pa.shape[:2]
    nw = tm.flag_words(NK)
    words = torch.zeros((B, nw, 2), dtype=torch.int32)
    mirror = words.clone()
    for pr in (pa, pb):
        tm.shard_flags(pr, gp, index, words)
        mirror = _kernel_shard_flags(pr, gp, index, mirror)
        assert torch.equal(words, mirror)
    lengths = torch.from_numpy(np.random.default_rng(3).integers(0, NK + 16, B).astype(np.int32))
    lengths[:4] = NK + 15
    got = tm.mask_from_flags(words, lengths, gp, NK, 10).numpy()
    assert np.array_equal(got, _kernel_mask_from_flags(words, lengths, gp, NK))
    # JAX: the flags of each shard (_eq_pm1 on its candidates), their max,
    # the window, the mismatch count and extract_segments
    flags = []
    for pr in (pa, pb):
        keys, cv = tm._keys_at(index, pr, 1)
        hi, lo = (keys >> 32).to(torch.int32).numpy(), tm._i32(keys).numpy()
        g = gp.numpy()
        m1 = jm._eq_pm1(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(g[:, 0, None, None]),
                        jnp.asarray(g[:, 1, None, None]))
        m2 = jm._eq_pm1(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(g[:, 2, None, None]),
                        jnp.asarray(g[:, 3, None, None]))
        cvj = jnp.asarray(cv.numpy())
        flags.append(jnp.max(jnp.where(cvj & m1, 3, jnp.where(cvj & m2, 2, 0)), axis=2))
    flag = jnp.maximum(*flags)
    L = NK + 15
    padded = jnp.concatenate([jnp.zeros((B, 15), flag.dtype), flag,
                              jnp.zeros((B, 15), flag.dtype)], 1)
    mask = jnp.zeros((B, L), flag.dtype)
    for j in range(16):
        mask = jnp.maximum(mask, padded[:, 15 - j : 15 - j + L])
    lj = jnp.asarray(lengths.numpy())
    within = jnp.arange(L)[None, :] < lj[:, None]
    read_ok = np.asarray(jnp.sum((mask < 2) & within, axis=1) <= 10)
    for t, (vc, sc, ec) in ((3, (0, 2, 4)), (2, (1, 3, 5))):
        v, s, e = (np.asarray(x) for x in jm.extract_segments(mask, lj, t))
        assert np.array_equal(got[:, vc], v & read_ok)
        assert np.array_equal(got[:, sc], s) and np.array_equal(got[:, ec], e)
    assert got[:, 0].any() or got[:, 1].any() or (got[:, 4] > 0).any()
