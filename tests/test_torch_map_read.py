"""The port's map_read (plain versions of kernels 1-3 and the two passes)
against the JAX package's `ops/map_read.py`, bit for bit."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.core.sequence import encode_bases, reverse_complement
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import pack_index, pack_index_kv
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.index import index_to_torch

LAYOUTS = {
    "split": None,
    "kv2": dict(target_load=0.5, slots=1),
    "kv4": dict(target_load=0.6, slots=2),
    "kv8": dict(),
}
MOTIF = "ACGTTGCAACGGTTACGATCCAGTTACG"


# ---------------- units ----------------


def test_compute_kmers_with_invalid_codes():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import compute_kmers

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (64, 70), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 255
    codes[0, :] = 255
    codes[1, :] = 3  # all-T rows give k-mers >= 2^31
    lengths = rng.integers(0, 71, 64).astype(np.int32)
    lengths[:2] = 70
    km_j, ok_j = compute_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    km, ok = tm.compute_kmers(torch.from_numpy(codes), torch.from_numpy(lengths))
    assert (km.numpy() == np.asarray(km_j).astype(np.int64)).all()
    assert (ok.numpy() == np.asarray(ok_j)).all()
    assert km.max() >= 2**31 and (~ok).any() and ok.any()


def _top2_cases():
    """(hi, lo, valid) candidate rows: count ties, key 0, unsigned lo
    order, a single key, no key, only key 0, and random rows."""
    rows = [
        [(1, 100)] * 3 + [(1, 50)] * 3 + [(2, 5)],  # tie -> smaller key first
        [(0, 0)] * 5 + [(0, 1)] * 2 + [(3, -5)] * 2 + [(3, 5)] * 2,  # key 0 skipped
        [(7, -1)] * 4,  # one voted key only
        [],  # nothing valid
        [(0, 0)] * 6,  # key 0 only
        [(2, -1), (1, -1), (1, 0), (0, -2)] * 2 + [(1, -1)],  # lo 0xFFFFFFFF order
    ]
    P = 16
    rng = np.random.default_rng(1)
    for _ in range(40):
        n = int(rng.integers(0, P + 1))
        rows.append([(int(rng.integers(0, 3)), int(rng.integers(-2, 3))) for _ in range(n)])
    hi = np.zeros((len(rows), P), np.int32)
    lo = np.zeros((len(rows), P), np.int32)
    valid = np.zeros((len(rows), P), bool)
    for r, row in enumerate(rows):
        perm = rng.permutation(P)[: len(row)]
        for (h, l), p in zip(row, perm):
            hi[r, p], lo[r, p], valid[r, p] = h, l, True
    hi[~valid] = rng.integers(-5, 5, (~valid).sum())  # junk under invalid
    return hi, lo, valid


def test_top2_votes_ties_and_key_zero():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import top2_votes

    hi, lo, valid = _top2_cases()
    exp = [np.asarray(x) for x in top2_votes(jnp.asarray(hi), jnp.asarray(lo),
                                              jnp.asarray(valid))]
    keys = tm.gplong(torch.from_numpy(hi), torch.from_numpy(lo))
    g1, c1, g2, c2 = tm.top2_votes(keys, torch.from_numpy(valid))
    h1, l1 = tm._hi_lo(g1)
    h2, l2 = tm._hi_lo(g2)
    # exact everywhere, including the (count 0) fill-in keys
    for got, want in zip((h1, l1, c1, h2, l2, c2), exp):
        assert (got.numpy() == want).all()
    assert exp[2][0] == 3 and (exp[0][0], exp[1][0]) == (1, 50)
    assert (exp[0][1], exp[1][1], exp[3][1], exp[4][1]) == (0, 1, 3, 5)


def test_gplong_pm1_matches_jax_across_contig_boundary():
    """JAX forms pos - i in wrapping int32 with no borrow into the contig;
    the port's packed key must order and compare (+-1) exactly the same,
    including lo crossing 0 / 0xFFFFFFFF at a contig boundary."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import _eq_pm1

    edge = np.array([0, 1, 2, -1, -2, 2**31 - 1, -(2**31), 5], np.int32)
    hi, lo = np.meshgrid(np.array([0, 1, 2], np.int32), edge, indexing="ij")
    hi, lo = hi.ravel(), lo.ravel()
    gh, gl = hi[:, None], lo[:, None]
    exp = np.asarray(_eq_pm1(jnp.asarray(hi[None, :]), jnp.asarray(lo[None, :]),
                             jnp.asarray(gh), jnp.asarray(gl)))
    k = tm.gplong(torch.from_numpy(hi), torch.from_numpy(lo))
    got = ((k[None, :] - k[:, None]).abs() <= 1).numpy()
    assert (got == exp).all()
    # (1, 0xFFFFFFFF) and (2, 0) are neighbours; (1, 0) - 1 is (0, 0xFFFFFFFF)
    assert exp.sum() > len(hi)
    # pos - i below 0 keeps the contig: pos 1 sampled at i = 4 is (c, -3)
    pos = torch.tensor([[1]], dtype=torch.int32)
    assert tm.gplong(torch.tensor([[2]]), pos.to(torch.int64) - 4).item() == (2 << 32) | 0xFFFFFFFD


def _walk(mask, length, target):
    """The CUDA kernel's serial segment walk, line for line (csrc/
    mask_segments.cu segment_walk), so its rules are checked here too."""
    lim = min(length, len(mask))
    prev = last_blocked = hid = cur_end = -1
    best_len, best_start, best_end = -1, -1, 0
    for t in range(lim):
        m = mask[t]
        if m > target:
            last_blocked = t
            continue
        if m != target:
            continue
        linked = prev >= 0 and t - prev <= 10 and last_blocked <= prev
        head = not linked and t < length - 1
        prev = t
        if not (linked or head):
            continue
        if head:
            if hid >= 0 and cur_end - hid > best_len:
                best_len, best_start, best_end = cur_end - hid, hid, cur_end
            hid = t
        cur_end = t
    if hid >= 0 and cur_end - hid > best_len:
        best_len, best_start, best_end = cur_end - hid, hid, cur_end
    return best_len > 20, best_start, best_end


def _segment_masks():
    rng = np.random.default_rng(2)
    B, L = 400, 90
    runs = rng.choice([0, 2, 3], p=[0.3, 0.3, 0.4], size=(B, L // 6))
    mask = np.repeat(runs, 6, axis=1).astype(np.int32)
    noise = rng.random(mask.shape) < 0.05
    mask[noise] = rng.choice([0, 2, 3], size=noise.sum())
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    # ties: two equal 25-long target-3 chains (first wins)
    mask[0] = 0
    mask[0, 5:30] = 3
    mask[0, 50:75] = 3
    lengths[0] = L
    # a target at the last in-bounds base cannot start a chain
    mask[1] = 0
    mask[1, 40:66] = 2
    lengths[1] = 66
    mask[2] = 0
    mask[2, 65] = 3
    lengths[2] = 66
    # a higher flag between blocks a link; the gap bound is 10
    mask[3] = 0
    mask[3, 0:20] = 2
    mask[3, 22] = 3
    mask[3, 24:50] = 2
    mask[3, 60:71] = 2
    lengths[3] = L
    return mask, lengths


def test_extract_segments_ties_and_last_position():
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import extract_segments

    mask, lengths = _segment_masks()
    for target in (3, 2):
        ev, es, ee = (np.asarray(x) for x in extract_segments(
            jnp.asarray(mask), jnp.asarray(lengths), target))
        gv, gs, ge = (x.numpy() for x in tm.extract_segments(
            torch.from_numpy(mask), torch.from_numpy(lengths), target))
        assert (gv == ev).all() and (gs == es).all() and (ge == ee).all()
        walk = np.array([_walk(m, int(n), target) for m, n in zip(mask, lengths)])
        assert (walk[:, 0] == ev).all() and (walk[:, 1] == es).all()
        assert (walk[:, 2] == ee).all()
        assert ev.any() and (~ev).any()
    ev, es, ee = (np.asarray(x) for x in extract_segments(
        jnp.asarray(mask[:2]), jnp.asarray(lengths[:2]), 3))
    assert (es[0], ee[0]) == (5, 29)  # the first of two equal chains


# ---------------- the pass-1 vote on hand-built rows ----------------


def _jax_vote(pr, packed, major_req=40, minor_req=20):
    """map_read_pass1's vote after the probe, in JAX: expand, (contig,
    pos - 2s), top2_votes and the gate -> (B, 5) [ok, h1, l1, h2, l2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.config import PASS1_STEP
    from genefuserust_tpu.ops import map_read as jm

    c, p = jnp.asarray(pr[..., 0]), jnp.asarray(pr[..., 1])
    if hasattr(packed, "kv_tbl"):
        cc, cp, cv = jm.expand_candidates_kv(c, p, jnp.asarray(packed.dupes), packed.max_dupe,
                                             packed.cbits, packed.pos_bias)
    else:
        cc, cp, cv = jm.expand_candidates(c, p, jnp.asarray(packed.dupes), packed.max_dupe)
    B, NS, D = cc.shape
    i_idx = jnp.arange(NS, dtype=jnp.int32)[None, :, None] * PASS1_STEP
    h1, l1, c1, h2, l2, c2 = jm.top2_votes(cc.reshape(B, -1), (cp - i_idx).reshape(B, -1),
                                           cv.reshape(B, -1))
    ok = (c1 * PASS1_STEP >= major_req) & (c2 * PASS1_STEP >= minor_req)
    return np.stack([np.asarray(x).astype(np.int32) for x in (ok, h1, l1, h2, l2)], axis=1)


PAD_KEY = 2**63 - 1


def _votable(k):
    return k != 0 and (k >> 32) != 0x7FFFFFFF


def _kernel_vote(keys, P, step=2, major_req=40, minor_req=20):
    """The vote kernel (csrc/vote.cu) on one row's n valid keys, step for
    step: for n <= 256 the warp path (bitonic network over K registers x
    32 lanes, run ends from the ballot masks of run starts), else the
    block path (sort, run lengths by binary search) -> [ok, h1, l1, h2, l2]."""
    n = len(keys)
    if n <= tm.VOTE_WARP_KEYS:
        K = next(k for k in (1, 2, 4, 8) if 32 * k >= n)
        N = 32 * K
        v = [[PAD_KEY] * 32 for _ in range(K)]
        for e, key in enumerate(keys):
            v[e // 32][e % 32] = key
        for ls in range(1, N.bit_length()):
            for lj in range(ls - 1, -1, -1):
                size, j = 1 << ls, 1 << lj
                if j >= 32:
                    jr = j >> 5
                    for k in range(K):
                        if k & jr:
                            continue
                        asc = (k * 32) & size == 0
                        for lane in range(32):
                            a, b = v[k][lane], v[k | jr][lane]
                            v[k][lane], v[k | jr][lane] = (min(a, b), max(a, b)) if asc \
                                else (max(a, b), min(a, b))
                else:
                    new = [row[:] for row in v]
                    for k in range(K):
                        for lane in range(32):
                            other, e = v[k][lane ^ j], k * 32 + lane
                            keep_min = ((e & size) == 0) == ((e & j) == 0)
                            new[k][lane] = min(v[k][lane], other) if keep_min \
                                else max(v[k][lane], other)
                    v = new
        start = [[(v[k][lane - 1] != v[k][lane]) if lane else
                  (k == 0 or v[k - 1][31] != v[k][0]) for lane in range(32)] for k in range(K)]
        starts = [sum(1 << lane for lane in range(32) if start[k][lane]) for k in range(K)]
        sc = {}
        for k in range(K):
            for lane in range(32):
                if start[k][lane] and _votable(v[k][lane]):
                    e, nxt = k * 32 + lane, N
                    for kk in range(K - 1, k, -1):
                        if starts[kk]:
                            nxt = kk * 32 + (starts[kk] & -starts[kk]).bit_length() - 1
                    above = starts[k] & ~((2 << lane) - 1) & 0xFFFFFFFF
                    if above:
                        nxt = k * 32 + (above & -above).bit_length() - 1
                    sc[e] = ((nxt - e) << 32) | (N - 1 - e)
        flat = [v[e // 32][e % 32] for e in range(N)]
    else:
        N = 1 << (n - 1).bit_length()
        flat = sorted(keys) + [PAD_KEY] * (N - n)
        sc = {}
        for i in range(n):
            if (i == 0 or flat[i - 1] != flat[i]) and _votable(flat[i]):
                cnt = sum(1 for x in flat[i:n] if x == flat[i])
                sc[i] = (cnt << 32) | (N - 1 - i)
    best1 = max(sc.values(), default=-1)
    e1 = N - 1 - (best1 & 0xFFFFFFFF) if best1 >= 0 else 0
    best2 = max((x for e, x in sc.items() if e != e1), default=-1)
    e2 = N - 1 - (best2 & 0xFFFFFFFF) if best2 >= 0 else 0
    smin = tm.INVALID_KEY if n == 0 else (min(flat[0], tm.INVALID_KEY) if n < P else flat[0])
    c1, g1 = (best1 >> 32, flat[e1]) if best1 >= 0 else (0, smin)
    c2, g2 = (best2 >> 32, flat[e2]) if best2 >= 0 else (0, smin)

    def i32(x):
        return (x + 2**31) % 2**32 - 2**31

    return [int(c1 * step >= major_req and c2 * step >= minor_req),
            i32(g1 >> 32), i32(g1), i32(g2 >> 32), i32(g2)]


@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_vote_plain_matches_jax_on_edge_rows(layout):
    """vote_plain against JAX's top2_votes + gate on vote_edge_rows, and
    the kernel's algorithm (mirrored in Python) against both."""
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    pr, packed, names = vote_edge_rows(seed=5, layout=layout)
    index = index_to_torch(packed, "cpu")
    got = tm.vote_plain(pr, index, 40, 20).numpy()
    exp = _jax_vote(pr.numpy(), packed)
    assert (got == exp).all(), [names[i] for i in np.nonzero((got != exp).any(1))[0]]
    keys, cv = tm._keys_at(index, pr, 2)
    B, P = pr.shape[0], pr.shape[1] * index.D
    for b in range(B):
        valid = keys[b].reshape(-1)[cv[b].reshape(-1)].tolist()
        assert _kernel_vote(valid, P) == got[b].tolist(), names[b]
    n = tm.vote_candidates(pr, index)
    assert (n > tm.VOTE_WARP_KEYS).any() and (n == 0).any()
    assert got[:, 0].any() and not got[:, 0].all()
    # key 0 only: both entries missing, filled with the smallest key, 0
    assert got[names.index("only_key_0")].tolist() == [0, 0, 0, 0, 0]
    assert got[names.index("no_valid")].tolist() == [0] + [tm.INT32_MAX] * 4


# ---------------- the passes on a panel with dupes ----------------


@pytest.fixture(scope="module")
def panel_ix(tmp_path_factory):
    panel = make_panel(seed=11)
    for (_, chrom, start, _), offs in zip(
        panel.genes, ([1000, 3000, 7000], [500 + 1100 * k for k in range(8)])
    ):
        s = panel.contigs[chrom]
        for off in offs:
            s = s[: start + off] + MOTIF + s[start + off + len(MOTIF) :]
        panel.contigs[chrom] = s
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    assert ix.kmer_dupe and ix.kmer_high
    return panel, ix


def _reads(panel):
    rng = np.random.default_rng(3)
    (_, c1, s1, _), (_, c2, s2, _) = panel.genes
    g1, g2 = panel.contigs[c1], panel.contigs[c2]
    fused = g1[s1 + 4700 : s1 + 5001] + g2[s2 + 6000 : s2 + 6300]
    reads = [fused[160 + 11 * k : 310 + 11 * k] for k in range(8)]
    for _ in range(24):
        s = (g1, g2)[int(rng.integers(2))]
        off = int(rng.integers(0, len(s) - 150))
        reads.append(s[off : off + 150])
    reads += [reverse_complement(r) for r in reads[:4]]
    for k in range(4):
        r = list(reads[k])
        for p in rng.integers(0, 150, size=3):
            r[int(p)] = "N"
        reads.append("".join(r))
    # dupe motifs, a chimera through a dupe motif, reads overhanging a
    # gene start (pos - i crosses 0), a short read and an all-N read
    reads += [g1[s1 + 990 : s1 + 1140], g2[s2 + 490 : s2 + 640],
              g1[s1 + 2950 : s1 + 3030] + g2[s2 + 5000 : s2 + 5070],
              g1[s1 - 40 : s1 + 110], g2[s2 - 70 : s2 + 80],
              g1[s1 - 30 : s1 + 50] + g2[s2 + 7000 : s2 + 7070],
              "ACGT" * 5, "N" * 150]
    return reads


def _batch(reads, L=160):
    codes = np.full((len(reads), L), 255, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, s in enumerate(reads):
        c = encode_bases(s)
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, lengths


def _packed(ix, layout):
    if layout == "split":
        return pack_index(ix)
    p = pack_index_kv(ix, **LAYOUTS[layout])
    assert p is not None
    return p


def _jax_tables(packed):
    import jax.numpy as jnp

    if hasattr(packed, "kv_tbl"):
        return (jnp.asarray(packed.kv_tbl), jnp.zeros((1, 2), jnp.int32),
                jnp.asarray(packed.dupes),
                dict(kv=True, cbits=packed.cbits, pos_bias=packed.pos_bias))
    return (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl),
            jnp.asarray(packed.dupes), {})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_map_read_passes_match_jax(panel_ix, layout):
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    panel, ix = panel_ix
    st = ix.settings
    packed = _packed(ix, layout)
    index = index_to_torch(packed, "cpu")
    t1, t2, dupes, kw = _jax_tables(packed)
    codes, lengths = _batch(_reads(panel))
    cj, lj = jnp.asarray(codes), jnp.asarray(lengths)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    reqs = (st.major_gene_key_requirement, st.minor_gene_key_requirement)

    p1_j = [np.array(x) for x in jm.map_read_pass1(
        cj, lj, t1, t2, dupes, packed.shift, packed.max_dupe, *reqs, **kw)]
    p1_t = [x.numpy() for x in tm.map_read_pass1(ct, lt, index, *reqs)]
    for got, want in zip(p1_t, p1_j):
        assert (got == want).all()
    assert p1_j[0].any() and not p1_j[0].all()

    h = [jnp.asarray(x) for x in p1_j[1:]]
    r_j = jm.map_read_pass2(cj, lj, *h, t1, t2, dupes, packed.shift,
                            packed.max_dupe, st.mismatch_threshold, **kw)
    r_t = tm.map_read_pass2(ct, lt, *(torch.from_numpy(x) for x in p1_j[1:]),
                            index, st.mismatch_threshold)
    for got, want in zip(r_t, r_j):
        assert (got.numpy() == np.asarray(want)).all()

    b_j = jm.map_read_batch(cj, lj, t1, t2, dupes, packed.shift, packed.max_dupe,
                            *reqs, st.mismatch_threshold, **kw)
    b_t = tm.map_read_batch(ct, lt, index, *reqs, st.mismatch_threshold)
    for got, want in zip(b_t, b_j):
        assert (got.numpy() == np.asarray(want)).all()
    assert np.asarray(b_j.seg_valid).all(axis=1).sum() >= 4  # junction reads


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lookup_expand_matches_jax(panel_ix, layout):
    """Probe + dupe expansion: regular hits, dupe rows and high dupes."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    panel, ix = panel_ix
    packed = _packed(ix, layout)
    t1, t2, dupes, kw = _jax_tables(packed)
    codes, lengths = _batch(_reads(panel))
    km, kv = jm.compute_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    exp = jm.lookup_expand(t1, t2, dupes, packed.shift, packed.max_dupe,
                           kw.get("kv", False), kw.get("cbits", 0), kw.get("pos_bias", 0),
                           km, kv)
    got = tm.lookup_expand(index_to_torch(packed, "cpu"),
                           torch.from_numpy(np.asarray(km).astype(np.int64)),
                           torch.from_numpy(np.array(kv)))
    for g, e in zip(got, exp):
        assert g.shape == e.shape and (g.numpy() == np.asarray(e)).all()
    cv = got[2].numpy()
    assert cv.shape[-1] > 1 and cv[..., 1:].any()  # some dupe rows expanded


# ---------------- kernels 2 and 3 on the card ----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_vote_and_mask_kernels_match_plain(panel_ix, layout, cuda_device):
    panel, ix = panel_ix
    packed = _packed(ix, layout)
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    codes, lengths = _batch(_reads(panel) * 8, L=256)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    cd, ld = ct.to(cuda_device), lt.to(cuda_device)
    pr = tm.probe(ct, lt, 2, cpu)
    exp_v = tm.vote(pr, cpu, 40, 20)
    got_v = tm.vote(pr.to(cuda_device), dev, 40, 20)
    assert torch.equal(got_v.cpu(), exp_v)
    gp = exp_v[:, 1:5].contiguous()
    pr1 = tm.probe(ct, lt, 1, cpu)
    exp_m = tm.mask_segments(pr1, lt, gp, cpu, 10)
    got_m = tm.mask_segments(pr1.to(cuda_device), ld, gp.to(cuda_device), dev, 10)
    assert torch.equal(got_m.cpu(), exp_m)
    assert exp_m[:, 0].any()
    got_b = tm.map_read_batch(cd, ld, dev)
    exp_b = tm.map_read_batch(ct, lt, cpu)
    for g, e in zip(got_b, exp_b):
        assert torch.equal(g.cpu(), e)
    # hand-built rows: the warp path's register widths and the block path
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    epr, epacked, _ = vote_edge_rows(seed=5, layout=layout)
    eidx = index_to_torch(epacked, "cpu")
    assert torch.equal(tm.vote(epr.to(cuda_device), index_to_torch(epacked, cuda_device),
                               40, 20).cpu(), tm.vote_plain(epr, eidx, 40, 20))
