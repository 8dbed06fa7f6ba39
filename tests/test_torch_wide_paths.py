"""The wide paths of the vote and of mask+segments as redesigned for the
H100: a row's work bounded by its own length, a long row spread over a
block with its keys or words in shared memory, and global scratch only
past a cap. The kernels' mirrors (`_kernel_vote_rows`, `_kernel_mask_rows`
in test_torch_map_read.py, `_kernel_mask_from_flags(wide=True)` in
test_torch_sharded_index.py) are held to JAX map_read_pass1 /
map_read_pass2 / map_read_batch and to the plain versions, exactly: on
the 4,200- and 70,000-base reads (kv2 and split, both vote modes), one
wide row among 220 rows of 150 bases, rows whose keys or words pass a
small cap (the global route), chains across the block step's warp and
round edges and into a row's last word, rows shorter than 16 bases and
DUPE-heavy wide rows. The `cuda` tests hold the kernels to plain on the
same inputs on the card."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.sequence import encode_bases
from genefuserust_tpu.utils.synthetic import plant_fusion_pairs
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.hashtable import DUPE, EMPTY
from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows
from test_torch_long_reads import _long_batch, panel_ix, panel_reads  # noqa: F401
from test_torch_map_read import (
    _block_segments,
    _jax_pass2,
    _jax_tables,
    _jax_vote,
    _kernel_mask_rows,
    _kernel_segments,
    _kernel_vote_rows,
    _mask_bits,
    _mask_edge_rows,
    _mask_route,
    _vote_routes,
)
from test_torch_sharded_index import _kernel_mask_from_flags, _kernel_shard_flags

CPU = torch.device("cpu")
ST = Settings()
REQS = (ST.major_gene_key_requirement, ST.minor_gene_key_requirement)
THR = ST.mismatch_threshold
# caps that force the global route: the 70,000-base row's 2,267 keys past
# 1,024 (8 KB), its 2,188 words past the warps' 16 KB of shared memory
VOTE_CAP, MASK_CAP = 8 << 10, 16 << 10


def _jax_pass1(codes, lens, packed):
    """JAX map_read_pass1 -> (B, 5) int32 [ok, h1, l1, h2, l2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    t1, t2, dupes, kw = _jax_tables(packed)
    r = jm.map_read_pass1(jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()), t1, t2, dupes,
                          packed.shift, packed.max_dupe, *REQS, **kw)
    return np.stack([np.asarray(x).astype(np.int32) for x in r], axis=1)


def _jax_counts(pr, packed):
    """JAX's counts vote (expand, (contig, pos - 2s), top2_votes) -> (B, 6)
    int32 [c1, h1, l1, c2, h2, l2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    c, p = jnp.asarray(pr[..., 0].numpy()), jnp.asarray(pr[..., 1].numpy())
    if hasattr(packed, "kv_tbl"):
        cc, cp, cv = jm.expand_candidates_kv(c, p, jnp.asarray(packed.dupes), packed.max_dupe,
                                             packed.cbits, packed.pos_bias)
    else:
        cc, cp, cv = jm.expand_candidates(c, p, jnp.asarray(packed.dupes), packed.max_dupe)
    B, NS, D = cc.shape
    i = jnp.arange(NS, dtype=jnp.int32)[None, :, None] * 2
    h1, l1, c1, h2, l2, c2 = jm.top2_votes(cc.reshape(B, -1), (cp - i).reshape(B, -1),
                                           cv.reshape(B, -1))
    return np.stack([np.asarray(x).astype(np.int32) for x in (c1, h1, l1, c2, h2, l2)], axis=1)


def _jax_batch(codes, lens, packed):
    """JAX map_read_batch -> (B, 10) int32 in the kernels' column order."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    t1, t2, dupes, kw = _jax_tables(packed)
    r = jm.map_read_batch(jnp.asarray(codes.numpy()), jnp.asarray(lens.numpy()), t1, t2, dupes,
                          packed.shift, packed.max_dupe, *REQS, THR, **kw)
    return np.concatenate([np.asarray(r.seg_valid).astype(np.int32), *(
        np.asarray(x) for x in (r.seg_start, r.seg_end, r.seg_contig, r.seg_pos))], axis=1)


def _in_chunks(fn, rows, n, *args):
    """fn over row chunks of `rows` tensors (plain and JAX rows are
    independent, their padded intermediates are not small) -> rows."""
    B = rows[0].shape[0]
    parts = [fn(*(r[a : a + n] for r in rows), *args) for a in range(0, B, n)]
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def _mask_routes(lens, pr1, smem_cap=None):
    L = pr1.shape[1] + 15
    return [_mask_route(int(n), L, smem_cap) for n in lens]


def _flag_words(pr1, lens, gp, index):
    return tm.shard_flags([pr1], lens, gp, [index])


# ---------------- the long reads, kv2 and split ----------------


@pytest.fixture(scope="module")
def long_inputs(panel_reads, panel_ix):
    """Per layout: the 150-, 4,200- and 70,000-base batch (_long_batch) with
    its probe results at strides 2 and 1 (plain, on the CPU)."""
    panel, reads = panel_reads
    cases = {}
    for layout in ("kv2", "split"):
        codes, lens, packed, index = _long_batch(panel, reads, panel_ix, layout)
        cases[layout] = dict(codes=codes, lens=lens, packed=packed, index=index,
                             pr=tm.probe(codes, lens, 2, index), pr1=tm.probe(codes, lens, 1, index))
    return cases


@pytest.fixture(scope="module")
def long_cases(long_inputs):
    """long_inputs with JAX's pass 1 and map_read_batch of each batch."""
    return {k: dict(c, pass1=_jax_pass1(c["codes"], c["lens"], c["packed"]),
                    batch=_jax_batch(c["codes"], c["lens"], c["packed"]))
            for k, c in long_inputs.items()}


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_vote_mirror_matches_jax_pass1(long_cases, layout, counts):
    """The row-bounded walk and the block vote over counted keys against
    JAX map_read_pass1 (gated) or JAX's top2_votes (counts) and the plain
    versions; the long rows take the block in shared memory."""
    c = long_cases[layout]
    pr, lens, index = c["pr"], c["lens"], c["index"]
    assert tm.vote_width(pr.shape[1], index.D) > tm.MAX_VOTE_KEYS
    got = _kernel_vote_rows(pr, lens, index, counts=counts)
    assert _vote_routes(pr, lens, index) == ["warp", "shared", "shared"]
    if counts:
        exp = _jax_counts(pr, c["packed"])
        plain = tm.vote_counts(pr, index, lens)
    else:
        exp = c["pass1"]
        plain = tm.vote(pr, index, *REQS, lens)
    assert np.array_equal(got, exp) and np.array_equal(plain.numpy(), exp)
    assert exp[1:, 0].all()  # the long rows pass the gate / hold counts


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_mask_mirror_matches_jax_pass2_and_batch(long_cases, layout):
    """Pass 2 on the long batch: the rows' own extents and the block step
    (both long rows) against JAX map_read_pass2 and map_read_batch, from
    the probe results and from flag words."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    c = long_cases[layout]
    pr1, lens, index, packed = c["pr1"], c["lens"], c["index"], c["packed"]
    gp = torch.from_numpy(c["pass1"][:, 1:5].copy())
    t1, t2, dupes, kw = _jax_tables(packed)
    r = jm.map_read_pass2(jnp.asarray(c["codes"].numpy()), jnp.asarray(lens.numpy()),
                          *(jnp.asarray(gp[:, k].numpy()) for k in range(4)), t1, t2, dupes,
                          packed.shift, packed.max_dupe, THR, **kw)
    exp = np.concatenate([np.asarray(r.seg_valid).astype(np.int32), *(
        np.asarray(x) for x in (r.seg_start, r.seg_end, r.seg_contig, r.seg_pos))], axis=1)
    got = _kernel_mask_rows(pr1, lens, gp, index, THR)
    assert _mask_routes(lens, pr1) == ["warp", "block", "block"]
    assert np.array_equal(got, exp)
    assert np.array_equal(tm.mask_segments(pr1, lens, gp, index, THR).numpy(), exp)
    NK = pr1.shape[1]
    words = _flag_words(pr1, lens, gp, index)
    assert np.array_equal(_kernel_mask_from_flags(words, lens, gp, NK, THR, wide=True), exp)
    # the batch: a segment is valid only where the vote gate passed
    ok = c["pass1"][:, :1]
    assert np.array_equal(np.concatenate([got[:, :2] & ok, got[:, 2:]], 1), c["batch"])
    assert (exp[:, 4] > tm.MASK_MAX_WIDTH).any() and exp[1, 0] == 1


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_paths_global_route_on_the_long_batch(long_cases, layout):
    """Caps below the long rows' keys and words: the mirrors take global
    scratch for them and still equal JAX; the wrappers take the caps."""
    c = long_cases[layout]
    pr, pr1, lens, index = c["pr"], c["pr1"], c["lens"], c["index"]
    routes = _vote_routes(pr, lens, index, VOTE_CAP)
    assert routes[2] == "global" and routes[0] == "warp"
    got = _kernel_vote_rows(pr, lens, index)
    assert np.array_equal(got, c["pass1"])
    assert np.array_equal(tm.vote(pr, index, *REQS, lens, smem_cap=VOTE_CAP).numpy(), got)
    assert np.array_equal(tm.vote_counts(pr, index, lens, VOTE_CAP).numpy(),
                          _kernel_vote_rows(pr, lens, index, counts=True))
    gp = torch.from_numpy(c["pass1"][:, 1:5].copy())
    assert _mask_routes(lens, pr1, MASK_CAP) == ["warp", "block", "global"]
    seg = _kernel_mask_rows(pr1, lens, gp, index, THR)
    assert np.array_equal(seg, tm.mask_segments(pr1, lens, gp, index, THR,
                                                smem_cap=MASK_CAP).numpy())
    words = _flag_words(pr1, lens, gp, index)
    assert np.array_equal(_kernel_mask_from_flags(words, lens, gp, pr1.shape[1], THR, wide=True),
                          tm.mask_from_flags(words, lens, gp, pr1.shape[1], THR, MASK_CAP).numpy())
    with pytest.raises(ValueError):
        tm.vote(pr, index, *REQS, lens, smem_cap=tm.WIDE_SMEM_BYTES + 8)
    with pytest.raises(ValueError):
        tm.mask_segments(pr1, lens, gp, index, THR, smem_cap=-1)
    with pytest.raises(ValueError):
        tm.vote(pr, index, *REQS, lens[:2])


# ---------------- one wide row among 220 of 150 bases ----------------


@pytest.fixture(scope="module")
def mixed_batch(panel_reads, panel_ix):
    """The 70,000-base read among the 220 reads (R1 and R2) of
    plant_fusion_pairs: codes, lengths, the kv2 table, probe results."""
    panel, reads = panel_reads
    pairs = plant_fusion_pairs(panel, n_support=10, n_background=100)
    seqs = [r.seq for p in pairs for r in (p.left, p.right)]
    seqs.insert(37, reads[1])
    W = -(-max(map(len, seqs)) // 32) * 32
    codes = np.full((len(seqs), W), 255, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    packed = build_packed_index(panel_ix, "kv2")
    index = index_to_torch(packed, CPU)
    codes = torch.from_numpy(codes)
    return dict(codes=codes, lens=lens, packed=packed, index=index, wide_row=37,
                pr=tm.probe(codes, lens, 2, index), pr1=tm.probe(codes, lens, 1, index))


def _short_and_long(m, t, keep):
    """(B, width, ...) rows of the mixed batch -> the short rows cut to
    their first `keep` columns, and the long row whole. Rows are
    independent and a short row's columns past `keep` are misses, which
    vote and flag nothing, so JAX's and plain's rows are the same on the
    cut rows as on the padded ones (slot_min's padded width only counts
    against rows whose every slot holds a key)."""
    w = m["wide_row"]
    short = torch.cat([t[:w], t[w + 1 :]])
    return short[:, :keep].contiguous() if keep else short, t[w : w + 1]


def _merge_rows(m, short, long):
    w = m["wide_row"]
    return np.concatenate([short[:w], long, short[w:]])


def test_one_wide_row_among_short_rows_vote(mixed_batch):
    """Every row of the wide launch: the 220 short rows walk their own 68
    samples of 35,001 and stay on the warp path; the long row takes the
    block. Gated and counts rows against JAX and plain (in row chunks)."""
    m = mixed_batch
    pr, lens, index, packed = m["pr"], m["lens"], m["index"], m["packed"]
    assert pr.shape[0] >= 221 and (lens == 150).sum() >= 220
    routes = _vote_routes(pr, lens, index)
    assert routes.count("warp") == len(routes) - 1 and routes[m["wide_row"]] == "shared"
    got = _kernel_vote_rows(pr, lens, index)
    (short, long), (lshort, _) = _short_and_long(m, pr, 73), _short_and_long(m, lens, 0)
    assert int(lshort.max()) <= 2 * 73 + 14
    exp = _merge_rows(m, _jax_vote(short.numpy(), packed), _jax_vote(long.numpy(), packed))
    assert np.array_equal(got, exp)
    plain = _merge_rows(m, tm.vote_plain(short, index, *REQS).numpy(),
                        tm.vote_plain(long, index, *REQS).numpy())
    assert np.array_equal(plain, exp)
    assert exp[:, 0].sum() >= 10  # the junction pairs' reads pass the gate


def test_one_wide_row_among_short_rows_mask(mixed_batch):
    """Pass 2 of the same batch: short rows on their 5 words each, the long
    row on the block, against JAX's pass 2 and plain (in row chunks), from
    probe results and from flag words."""
    m = mixed_batch
    pr1, lens, index, packed = m["pr1"], m["lens"], m["index"], m["packed"]
    short_pr, _ = _short_and_long(m, m["pr"], 73)
    gp = torch.from_numpy(_merge_rows(m, tm.vote_plain(short_pr, index, *REQS).numpy(),
                                      tm.vote_plain(_short_and_long(m, m["pr"], 0)[1], index,
                                                    *REQS).numpy())[:, 1:5].copy())
    routes = _mask_routes(lens, pr1)
    assert routes.count("warp") == len(routes) - 1 and routes[m["wide_row"]] == "block"
    got = _kernel_mask_rows(pr1, lens, gp, index, THR)
    (short, long), (lshort, llong), (gshort, glong) = (
        _short_and_long(m, pr1, 145), _short_and_long(m, lens, 0), _short_and_long(m, gp, 0))
    exp = _merge_rows(m, _jax_pass2(short, lshort, gshort, packed),
                      _jax_pass2(long, llong, glong, packed))
    assert np.array_equal(got, exp)
    plain = _merge_rows(m, tm.mask_segments_plain(short, lshort, gshort, index, THR).numpy(),
                        tm.mask_segments_plain(long, llong, glong, index, THR).numpy())
    assert np.array_equal(plain, exp)
    words = _in_chunks(_flag_words, [pr1, lens, gp], 32, index)
    assert np.array_equal(_kernel_mask_from_flags(words, lens, gp, pr1.shape[1], THR, wide=True),
                          exp)
    assert exp[:, 0].sum() >= 10


# ---------------- the sharded pass 2 at padded widths ----------------


def _batch_4224(panel_reads, panel_ix, layout):
    """The 4,200-base read (row 17) among 80 reads of 150 bases, padded to
    4,224 bases -> codes, lengths, the table (packed, on the CPU), the
    vote's keys and the stride-1 probe results."""
    panel, reads = panel_reads
    pairs = plant_fusion_pairs(panel, n_support=10, n_background=30)
    seqs = [r.seq for p in pairs for r in (p.left, p.right)]
    seqs.insert(17, reads[0])
    W = -(-max(map(len, seqs)) // 32) * 32
    assert W == 4224 and sum(len(q) == 150 for q in seqs) == len(seqs) - 1
    codes = np.full((len(seqs), W), 255, np.uint8)
    for i, q in enumerate(seqs):
        codes[i, : len(q)] = encode_bases(q)
    codes = torch.from_numpy(codes)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int32)
    packed = build_packed_index(panel_ix, layout)
    index = index_to_torch(packed, CPU)
    gp = tm.vote(tm.probe(codes, lens, 2, index), index, *REQS)[:, 1:5].contiguous()
    return codes, lens, packed, index, gp, tm.probe(codes, lens, 1, index)


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_sharded_pass2_mirrors_on_a_4200_base_row_among_150(panel_reads, panel_ix, layout):
    """The 4,200-base read among 80 reads of 150 bases, every row padded to
    4,224 bases: the shard flags' mirror (the long row over 5 spans of 32
    words, the short rows' 5 words each, zero past them) and the narrow
    mask from flags' mirror (a warp a row, the long row in 5 rounds)
    against JAX map_read_pass2 and plain, exactly."""
    codes, lens, packed, index, gp, pr1 = _batch_4224(panel_reads, panel_ix, layout)
    NK = pr1.shape[1]
    words = _flag_words(pr1, lens, gp, index)
    assert torch.equal(words, tm.shard_flags_plain(pr1, gp, index))
    assert torch.equal(_kernel_shard_flags([pr1], lens, gp, [index]), words)
    exp = _jax_pass2(pr1, lens, gp, packed)
    got = tm.mask_from_flags(words, lens, gp, NK, THR).numpy()
    assert np.array_equal(got, exp)
    assert np.array_equal(_kernel_mask_from_flags(words, lens, gp, NK, THR), exp)
    assert exp[17, :2].all() and exp[17, 4:6].max() > 4000 and exp[:, 0].sum() >= 10


def test_shard_flags_mirror_on_the_mixed_batch(mixed_batch):
    """The shard flags at width 70,016: the 70,000-base row over 69 spans
    of 32 words, the 220 rows of 150 bases on their first 5 words and
    zero past them; the mirror (in row chunks) against plain, stored and
    ORed into the words of a first launch."""
    m = mixed_batch
    pr1, lens, index = m["pr1"], m["lens"], m["index"]
    gp = _in_chunks(tm.vote_plain, [m["pr"]], 32, index, *REQS)[:, 1:5].contiguous()
    plain = _in_chunks(lambda p, g: tm.shard_flags_plain(p, g, index), [pr1, gp], 32)
    got = _in_chunks(lambda p, n, g: _kernel_shard_flags([p], n, g, [index]), [pr1, lens, gp], 16)
    assert torch.equal(got, plain)
    half = torch.where(torch.arange(got.shape[0])[:, None, None] % 2 == 0, got, 0)
    assert torch.equal(_in_chunks(lambda p, n, g, w: _kernel_shard_flags([p], n, g, [index], w),
                                  [pr1, lens, gp, half], 16), got)
    assert got[m["wide_row"], 2000:].any() and not got[:, 5:][lens == 150].any()


# ---------------- chains across the block step's edges ----------------


def _edge_chain_masks(L):
    """(B, L) masks and lengths for the block step: chains across a warp's
    words (base 1,024 = word 32), heads carried over several warps, a chain
    across a round of 512 words (base 16,384), chains into the row's last
    in-bounds word at lengths on and off a word edge, gaps of 10 and 11 at
    a warp edge with a blocking flag, and random runs."""
    rows, lens = [], []

    def row(spans, n=L):
        m = np.zeros(L, np.int32)
        for a, b, t in spans:
            m[a : b + 1] = t
        rows.append(m)
        lens.append(n)

    row([(1000, 1100, 3)])
    row([(500, 5000, 3), (5200, 5400, 2)])
    row([(1020, 1023, 3), (1030, 1040, 3), (1045, 1200, 3)])  # gaps 6 and 4
    row([(16000, 17000, 3), (12000, 16500, 2)])
    row([(L - 990, L - 11, 3)], L - 10)  # into the last word, off its edge
    row([(L - 600, L - 1, 2)], L - L % 32)  # on a word edge
    for gap in (10, 11):
        for t, blk in ((3, 0), (2, 0), (2, 3)):
            spans = []
            for a in range(992 - 40 * gap, 1100, 20 + gap):
                spans.append((a, a + 19, t))
                if blk:
                    spans.append((a + 20 + gap // 2, a + 20 + gap // 2, blk))
            row(spans)
    rng = np.random.default_rng(L)
    for k in range(6):
        runs = rng.choice([0, 2, 3], p=[0.3, 0.3, 0.4], size=-(-L // 40))
        m = np.repeat(runs, 40)[:L].astype(np.int32)
        noise = rng.random(L) < 0.01
        m[noise] = rng.choice([0, 2, 3], size=noise.sum())
        rows.append(m)
        lens.append([L, L - 1, 2049, 16385, 16383, L - 33][k])
    return np.stack(rows), np.array(lens, np.int32)


@pytest.mark.parametrize("threads", [512, 64])
def test_block_segments_mirror_across_warp_and_round_edges(threads):
    """The block step's chains (a word a thread, heads carried by block
    exclusive max-scans within and across rounds) on masks of width 20,000
    against JAX extract_segments and the warp step, at the kernel's 512
    threads and at 64 (a round every 64 words)."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import extract_segments

    L = 20000
    mask, lens = _edge_chain_masks(L)
    ends = {}
    for target in (3, 2):
        ev, es, ee = (np.asarray(x) for x in extract_segments(
            jnp.asarray(mask), jnp.asarray(lens), target))
        for b, (m, n) in enumerate(zip(mask, lens)):
            m3, m2 = _mask_bits(m[: int(n)])  # the row's own words
            got = _block_segments(m3, m2, int(n), L, target, threads=threads)
            assert got == (ev[b], es[b], ee[b]), (b, target)
            assert _kernel_segments(m3, m2, int(n), L, target, wide=True) == got
        assert ev.any() and (~ev).any()
        ends[target] = ee
    # chains across base 1,024 and 16,384, into the last in-bounds base
    assert ends[3][0] == 1100 and ends[3][3] == 17000 and ends[3][4] == L - 11


def _moved_edge_rows(index):
    """_mask_edge_rows at width 1,100 moved past 65,535 bases behind
    misses (the hits' positions moved with them)."""
    pr, lengths, gp, names = _mask_edge_rows(index, 1100, seed=1100)
    off = tm.MASK_MAX_WIDTH
    moved = pr.clone()
    moved[..., 1] += torch.where(pr[..., 0] >= 0, off, 0).to(torch.int32)
    front = torch.tensor([EMPTY, 0], dtype=torch.int32).expand(pr.shape[0], off, 2)
    return torch.cat([front, moved], 1), lengths + off, gp, names


def test_wide_mask_mirror_on_rows_moved_past_65535(dupe_rows):
    """The hand-built pass-2 edge rows (equal chains, a target at the last
    base, gaps of 10 and 11, a higher flag in a gap, dupe keys, lengths on
    word edges) moved past 65,535 bases behind misses: every row takes the
    block step, its chains across the block's round at word 2,048; the
    mirror equals JAX's pass 2 with the default cap and the global route
    (the dupe panel's tables, kv2 and split)."""
    _, _, packed, index, _ = dupe_rows
    wpr, wlen, gp, names = _moved_edge_rows(index)
    exp = _jax_pass2(wpr, wlen, gp, packed)
    got = _kernel_mask_rows(wpr, wlen, gp, index, THR)
    bad = [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    assert not bad, f"the wide mirror differs from JAX on {bad}"
    for cap, route in ((None, "block"), (MASK_CAP, "global")):
        assert set(_mask_routes(wlen, wpr, cap)) == {route}
    # chains start and end past 65,535 (the misses in front fail the
    # mismatch test, so no segment is valid)
    assert (exp[:, 2] >= tm.MASK_MAX_WIDTH).any() and (exp[:, 4] > tm.MASK_MAX_WIDTH).any()


# ---------------- short rows and DUPE-heavy rows ----------------


def test_rows_shorter_than_16_bases_in_a_wide_batch(panel_reads, panel_ix):
    """Rows of 0-17 and 31 bases beside the 70,000-base read: no sample and
    no in-bounds k-mer below 16 bases; JAX map_read_batch and pass 1 agree
    with the mirrors."""
    panel, reads = panel_reads
    junction = plant_fusion_pairs(panel, n_support=1, n_background=0)[0].left.seq
    seqs = [junction[:n] for n in (0, 1, 15, 16, 17, 31)] + [reads[1], junction]
    W = -(-max(map(len, seqs)) // 32) * 32
    codes = np.full((len(seqs), W), 255, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_bases(s)
    codes, lens = torch.from_numpy(codes), torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    packed = build_packed_index(panel_ix, "kv2")
    index = index_to_torch(packed, CPU)
    pr = tm.probe(codes, lens, 2, index)
    votes = _kernel_vote_rows(pr, lens, index)
    assert np.array_equal(votes, _jax_pass1(codes, lens, packed))
    assert _vote_routes(pr, lens, index)[:3] == ["warp"] * 3 and (pr[:3, :, 0] == EMPTY).all()
    gp = torch.from_numpy(votes[:, 1:5].copy())
    seg = _kernel_mask_rows(tm.probe(codes, lens, 1, index), lens, gp, index, THR)
    batch = np.concatenate([seg[:, :2] & votes[:, :1], seg[:, 2:]], 1)
    assert np.array_equal(batch, _jax_batch(codes, lens, packed))
    assert not batch[:6, :2].any()


@pytest.fixture(scope="module", params=["kv2", "split"])
def dupe_rows(request):
    """vote_edge_rows at 6,000 samples a row (past the shared-memory block
    path for D 3), plus a row of DUPE samples only, each naming a dupe row
    of the most candidates (18,000 keys), and one of half DUPE samples."""
    pr, packed, names = vote_edge_rows(seed=5, layout=request.param, NS=6000)
    index = index_to_torch(packed, CPU)
    nd = index.dupes.shape[0]
    _, _, cv = tm.expand(index, torch.full((nd,), DUPE, dtype=torch.int32),
                         torch.arange(nd, dtype=torch.int32))
    full = torch.nonzero(cv.sum(1) == cv.sum(1).max()).flatten()
    rng = np.random.default_rng(7)
    extra = torch.full((2, pr.shape[1], 2), EMPTY, dtype=torch.int32)
    extra[0, :, 0] = DUPE
    extra[0, :, 1] = full[torch.from_numpy(rng.integers(0, len(full), pr.shape[1]))]
    extra[1, ::2] = extra[0, ::2]
    pr = torch.cat([pr, extra])
    lens = torch.full((pr.shape[0],), 2 * pr.shape[1] + 14, dtype=torch.int32)
    return pr, lens, packed, index, names + ["all_dupe", "half_dupe"]


def test_dupe_heavy_wide_rows_match_jax(dupe_rows):
    """The edge rows of the vote (ties, key 0, wrapping low halves, register
    widths) and DUPE-heavy rows on the wide path: the mirror equals JAX's
    vote and plain, with the keys in shared memory and past a cap."""
    pr, lens, packed, index, names = dupe_rows
    assert tm.vote_width(pr.shape[1], index.D) > tm.MAX_VOTE_KEYS
    exp = _jax_vote(pr.numpy(), packed)
    assert np.array_equal(tm.vote_plain(pr, index, *REQS).numpy(), exp)
    n = tm.vote_candidates(pr, index)
    assert int(n[-2]) == pr.shape[1] * int(tm.expand(
        index, pr[-2:-1, :1, 0], pr[-2:-1, :1, 1])[2].sum())
    # the all-DUPE row's 30,000 keys pass the shared memory's 28,672, the
    # half-DUPE row's 15,000 pass only the small cap
    assert int(n[-2]) > tm.WIDE_SMEM_BYTES // 8 > int(n[-1]) > VOTE_CAP // 8
    got = _kernel_vote_rows(pr, lens, index)
    bad = [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    assert not bad, f"the wide vote mirror differs from JAX on {bad}"
    for cap, route in ((None, "shared"), (VOTE_CAP, "global")):
        assert _vote_routes(pr, lens, index, cap)[-2:] == ["global", route]
    counts = _kernel_vote_rows(pr, lens, index, counts=True)
    assert np.array_equal(counts, _jax_counts(pr, packed))


# ---------------- the kernels on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_wide_kernels_match_plain_on_the_long_batch_with_caps(long_inputs, layout, cuda_device):
    """The four wide kernels with the default cap and the global route."""
    c = long_inputs[layout]
    pr, pr1, lens, index, packed = c["pr"], c["pr1"], c["lens"], c["index"], c["packed"]
    dev = index_to_torch(packed, cuda_device)
    prd, pr1d, ld = _on(cuda_device, pr, pr1, lens)
    gp = tm.vote_plain(pr, index, *REQS)[:, 1:5].contiguous()
    gpd = gp.to(cuda_device)
    words = _flag_words(pr1, lens, gp, index)
    for vcap, mcap in ((None, None), (VOTE_CAP, MASK_CAP)):
        assert torch.equal(tm.vote(prd, dev, *REQS, ld, vcap).cpu(),
                           tm.vote_plain(pr, index, *REQS))
        assert torch.equal(tm.vote_counts(prd, dev, ld, vcap).cpu(),
                           tm.vote_counts_plain(pr, index))
        exp = tm.mask_segments_plain(pr1, lens, gp, index, THR)
        assert torch.equal(tm.mask_segments(pr1d, ld, gpd, dev, THR, mcap).cpu(), exp)
        assert torch.equal(tm.mask_from_flags(words.to(cuda_device), ld, gpd, pr1.shape[1], THR,
                                              mcap).cpu(), exp)
    assert torch.equal(tm.shard_flags([pr1d], ld, gpd, [dev]).cpu(), words)


@pytest.mark.cuda
def test_wide_kernels_match_plain_on_the_mixed_batch(mixed_batch, cuda_device):
    m = mixed_batch
    pr, pr1, lens, index, packed = m["pr"], m["pr1"], m["lens"], m["index"], m["packed"]
    dev = index_to_torch(packed, cuda_device)
    prd, pr1d, ld = _on(cuda_device, pr, pr1, lens)
    v = _in_chunks(tm.vote_plain, [pr], 32, index, *REQS)
    gp = v[:, 1:5].contiguous()
    seg = _in_chunks(tm.mask_segments_plain, [pr1, lens, gp], 16, index, THR)
    words = _in_chunks(_flag_words, [pr1, lens, gp], 32, index).to(cuda_device)
    for vcap, mcap in ((None, None), (VOTE_CAP, MASK_CAP)):
        assert torch.equal(tm.vote(prd, dev, *REQS, ld, vcap).cpu(), v)
        assert torch.equal(tm.vote_counts(prd, dev, ld, vcap).cpu(),
                           _in_chunks(tm.vote_counts_plain, [pr], 32, index))
        gpd = gp.to(cuda_device)
        assert torch.equal(tm.mask_segments(pr1d, ld, gpd, dev, THR, mcap).cpu(), seg)
        assert torch.equal(tm.mask_from_flags(words, ld, gpd, pr1.shape[1], THR, mcap).cpu(), seg)
    assert torch.equal(tm.shard_flags([pr1d], ld, gpd, [dev]), words)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_sharded_pass2_kernels_on_a_4200_base_row_among_150(panel_reads, panel_ix, layout,
                                                             cuda_device):
    codes, lens, packed, index, gp, pr1 = _batch_4224(panel_reads, panel_ix, layout)
    dev = index_to_torch(packed, cuda_device)
    pr1d, ld, gpd = _on(cuda_device, pr1, lens, gp)
    words = tm.shard_flags([pr1d], ld, gpd, [dev])
    exp = tm.shard_flags_plain(pr1, gp, index)
    assert torch.equal(words.cpu(), exp)
    assert torch.equal(tm.mask_from_flags(words, ld, gpd, pr1.shape[1], THR).cpu(),
                       tm.mask_from_flags_plain(exp, lens, gp, pr1.shape[1], THR))


@pytest.mark.cuda
def test_wide_vote_kernel_matches_plain_on_dupe_heavy_rows(dupe_rows, cuda_device):
    pr, lens, packed, index, _ = dupe_rows
    dev = index_to_torch(packed, cuda_device)
    prd, ld = _on(cuda_device, pr, lens)
    for cap in (None, VOTE_CAP):
        assert torch.equal(tm.vote(prd, dev, *REQS, ld, cap).cpu(), tm.vote_plain(pr, index, *REQS))
        assert torch.equal(tm.vote_counts(prd, dev, ld, cap).cpu(), tm.vote_counts_plain(pr, index))


@pytest.mark.cuda
def test_wide_mask_kernel_on_moved_edge_rows_global_route(dupe_rows, cuda_device):
    _, _, packed, index, _ = dupe_rows
    wpr, wlen, gp, _ = _moved_edge_rows(index)
    exp = tm.mask_segments_plain(wpr, wlen, gp, index, THR)
    dev = index_to_torch(packed, cuda_device)
    for cap in (None, MASK_CAP):
        got = tm.mask_segments(*_on(cuda_device, wpr, wlen, gp), dev, THR, cap)
        assert torch.equal(got.cpu(), exp)
