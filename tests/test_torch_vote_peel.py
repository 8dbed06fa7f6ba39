"""The vote's warp path (csrc/vote.cu `vote_rows`): a row of at most
VOTE_PEEL_KEYS distinct keys is voted on by peeling them one at a time
(`warp_peel`), a row of more by the bitonic sort (`warp_vote`), and the
launch counts both kinds of row into the (VOTE_STAT_SLOTS,) counter that
fused_scan_lanes carries to the engine (`vote.rows`, `vote.rows_sorted`).

On the CPU: a Python mirror of the peel against the plain vote on crafted
rows (every edge of the sort's register widths and of WARP_CAP, the cap
and the cap + 1, ties with wrapped low halves and negative keys,
non-votable keys on top, DUPE samples in kv and split tables, slot_min at
n < P and n = P), and `vote_tally`, the plain twin of the counter. On the
card (`cuda`): the kernel's rows, in both modes and over 1 and 3 shards,
bit-equal to the plain vote on the same rows and on a random batch of the
main path's shape, and its counter equal to `vote_tally`. No JAX here:
the card's machine has none."""

import dataclasses

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.config import PASS1_STEP
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.hashtable import DUPE, EMPTY
from genefuserust_tpu_torch.ops.index import TorchIndex

M32 = 0xFFFFFFFF
INT32_MAX = 0x7FFFFFFF
CAP = tm.VOTE_PEEL_KEYS
KV_CBITS, KV_POS_BIAS = 8, -(1 << 20)


def _i32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _key(c: int, lo: int) -> int:
    """gplong of (contig, low half) as a signed 64-bit int."""
    return _i32(c) * (1 << 32) + (lo & M32)


# ---------------- crafted rows ----------------
#
# A row is a list of samples: None (a miss), a key (c, lo) (a regular hit
# whose key is (c, lo): pos = lo + s * step) or a list of keys (a DUPE
# sample whose dupe row holds them, EMPTY past them).


def _batch(rows, NS: int, D: int, layout: str):
    """Crafted rows -> (pr (B, NS, 2) int32, TorchIndex) on the CPU."""
    pr = np.zeros((len(rows), NS, 2), np.int64)
    pr[..., 0] = EMPTY
    drows = []
    for b, row in enumerate(rows):
        assert len(row) <= NS
        for s, smp in enumerate(row):
            if smp is None:
                continue
            if isinstance(smp, tuple):
                pr[b, s] = (smp[0], _i32(smp[1] + s * PASS1_STEP))
            else:
                assert 1 <= len(smp) <= D
                pr[b, s] = (DUPE, len(drows))
                drows.append([(c, _i32(lo + s * PASS1_STEP)) for c, lo in smp])
    pr = torch.from_numpy(pr.astype(np.int32))
    if layout == "split":
        d = np.zeros((max(1, len(drows)), D, 2), np.int32)
        d[..., 0] = EMPTY
        for r, pairs in enumerate(drows):
            d[r, : len(pairs)] = pairs
        ix = TorchIndex(split=True, table=torch.zeros((1, 8), dtype=torch.int32),
                        vals=torch.zeros((8, 2), dtype=torch.int32),
                        dupes=torch.from_numpy(d), shift=0, max_dupe=D, cbits=0, pos_bias=0,
                        S=8, D=D, single_probe=False)
        return pr, ix
    assert D <= 8
    pbits = 32 - KV_CBITS
    d = np.zeros((len(drows), 8), np.int64)
    for r, pairs in enumerate(drows):
        for j, (c, p) in enumerate(pairs):
            assert 0 <= c < (1 << KV_CBITS) - 3
            d[r, j] = _i32(((c + 3) << pbits) | ((p - KV_POS_BIAS) & ((1 << pbits) - 1)))
    ix = TorchIndex(split=False, table=torch.zeros((1, 4), dtype=torch.int32),
                    vals=torch.zeros((0, 2), dtype=torch.int32),
                    dupes=torch.from_numpy(d.astype(np.int32)), shift=0, max_dupe=D,
                    cbits=KV_CBITS, pos_bias=KV_POS_BIAS, S=2, D=D if len(drows) else 1,
                    single_probe=False)
    return pr, ix


def _distinct(k: int, n: int, first: int = 0):
    """n regular samples over k distinct keys of contig 3, counts as even
    as k allows."""
    return [(3, 1000 + first + i % k) for i in range(n)]


def _n_edges():
    rows = []
    for n in (0, 1, 32, 33, 64, 65, 128, 129, 256, 257):
        rows.append(_distinct(2, n))  # two keys: the peel
        rows.append(_distinct(n, n))  # n keys: past the cap, the sort
        rows.append(_distinct(CAP, n) if n >= CAP else _distinct(max(1, n), n))
    return rows


def _cap_rows():
    rows = []
    for k in (CAP - 1, CAP, CAP + 1, CAP + 2):
        rows.append(_distinct(k, k))  # each key once: all tied
        rows.append(_distinct(k, 3 * k + 1))  # the first key once more
        rows.append(_distinct(k, 60, first=7))
        rows.append([(3, 50)] * 9 + _distinct(k - 1, 40))  # a clear winner
    return rows


def _tie_rows():
    wrapped = (5, 0xFFFFFFF0)  # its low half negative as int32
    small = (5, 10)
    other = (4, 0x80000000)
    return [
        [wrapped] * 5 + [small] * 5,
        [small] * 5 + [wrapped] * 5,
        [wrapped] * 4 + [other] * 4 + [small] * 4,
        [other] * 4 + [wrapped] * 4 + [small] * 4 + [(9, 1)] * 6,
        [wrapped] * 7 + [other] * 3 + [small] * 3,
        [(0, 0)] * 9 + [small] * 3 + [other] * 3,  # key 0 (not votable) on top
        [(INT32_MAX, 7)] * 9 + [small] * 2 + [wrapped] * 2,  # contig INT32_MAX on top
        [(INT32_MAX, 0xFFFFFFFF)] * 5,  # nothing votable, the key past INVALID_KEY
        [(0, 0)] * 4,
        [(0, 1)] * 3 + [(0, 0)] * 3,
    ]


def _dupe_rows(D: int):
    a, b, c = (7, 40), (8, 0xFFFFFF00), (2, 5)
    return [
        [a, [a, b], [a, b, c], None, a, [c] * 1 + [b] * (D - 1)],
        [[a] * D, [b] * D, [c] * D, a],
        [[(11, 100 + j) for j in range(D)] for _ in range(3)] + [[a]] * 4,
        [[(12, j) for j in range(D)] for _ in range(3)] + [[a, b]] * 4,  # past the cap
        [None, [b], None, [b, c], [c]],
    ]


def _negative_rows():
    """Split dupe rows may hold any contig but EMPTY: negative keys."""
    return [
        [[(-2, 9)], [(-2, 9)], (3, 9), (3, 9)],
        [[(-2, 9), (3, 9)], [(-2, 0)], [(-2, 9)], (3, 9), (3, 9)],
        [[(-1 << 31, 1)], [(-1 << 31, 1)], [(INT32_MAX, 0)]],
    ]


def _full_rows(NS: int):
    """n = P on a table with no dupes (D = 1): every sample a hit."""
    return [
        [(6, 77)] * NS,
        [(6, 77)] * (NS - 3) + [(6, 78)] * 3,
        [(INT32_MAX, 0xFFFFFFF0)] * NS,
        [(6, 77)] * (NS - 1),  # n = P - 1
    ]


def _gate_rows():
    # counts 20 and 10: the gate at c * step against major/minor requirements
    return [[(4, 4)] * 20 + [(4, 9)] * 10 + [None] * 5, [(4, 4)] * 20 + [(4, 9)] * 9]


CASES = {
    # name: (rows, NS, D, layout)
    "n_edges": (_n_edges(), 300, 1, "kv2"),
    "n_edges_split": (_n_edges(), 300, 2, "split"),
    "cap": (_cap_rows(), 89, 8, "kv2"),
    "ties": (_tie_rows(), 89, 1, "kv2"),
    "ties_split": (_tie_rows(), 89, 4, "split"),
    "dupes_kv2": (_dupe_rows(8), 89, 8, "kv2"),
    "dupes_split": (_dupe_rows(8), 89, 8, "split"),
    "negative_split": (_negative_rows(), 89, 3, "split"),
    "full_rows": (_full_rows(89), 89, 1, "kv2"),
    "full_rows_split": (_full_rows(73), 73, 1, "split"),
    "gate": (_gate_rows(), 89, 1, "kv2"),
}
GATES = [(40, 20), (41, 20), (40, 21), (41, 21), (0, 0)]


# ---------------- the peel, mirrored ----------------


def _votable(k: int) -> bool:
    return k != 0 and (k >> 32) != INT32_MAX


def _row_keys(pr, index):
    """Each row's valid keys, sample by sample (the warp compacts a chunk's
    regular hits before its DUPE slots; the peel's result does not depend
    on the order) -> a list a row."""
    keys, cv = tm._keys_at(index, pr, PASS1_STEP)
    B = pr.shape[0]
    keys, cv = keys.reshape(B, -1), cv.reshape(B, -1)
    return [keys[b][cv[b]].tolist() for b in range(B)]


def _peel(keys, P: int):
    """warp_peel on one row's valid keys -> (c1, g1, c2, g2), or None for a
    row of more than VOTE_PEEL_KEYS distinct keys."""
    left = list(range(len(keys)))
    c1 = c2 = g1 = g2 = 0
    least = None
    for d in range(len(keys) + 1):
        if not left:
            break
        if d == CAP:
            return None
        key = keys[left[0]]
        c = sum(keys[i] == key for i in left)
        left = [i for i in left if keys[i] != key]
        least = key if least is None else min(least, key)
        if _votable(key):
            if c > c1 or (c == c1 and key < g1):
                c1, g1, c2, g2 = c, key, c1, g1
            elif c > c2 or (c == c2 and key < g2):
                c2, g2 = c, key
    inv = _key(INT32_MAX, INT32_MAX)
    n = len(keys)
    smin = inv if n == 0 else (min(least, inv) if n < P else least)
    return c1, g1 if c1 else smin, c2, g2 if c2 else smin


def _counts(v):
    """vote_counts rows -> [(c1, g1, c2, g2)]."""
    return [(r[0], _key(r[1], r[2]), r[3], _key(r[4], r[5])) for r in v.tolist()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_peel_mirror_matches_the_plain_vote(case):
    rows, NS, D, layout = CASES[case]
    pr, ix = _batch(rows, NS, D, layout)
    exp = _counts(tm.vote_counts_plain(pr, ix))
    peeled = 0
    for b, keys in enumerate(_row_keys(pr, ix)):
        got = _peel(keys, NS * ix.D)
        assert (got is None) == (len(set(keys)) > CAP), b
        if got is not None:
            peeled += 1
            assert got == exp[b], (b, keys)
    assert peeled


def _expected_tally(pr, ix, lengths=None):
    """The counter by construction: rows of at most VOTE_WARP_KEYS valid
    keys (and, on the wide route with lengths, at most VOTE_WALK_MAX
    samples inside), sorted past VOTE_PEEL_KEYS distinct keys."""
    NS = pr.shape[1]
    wide = tm.vote_width(NS, ix.D) > tm.MAX_VOTE_KEYS
    keys, cv = tm._keys_at(ix, pr, PASS1_STEP)
    rows = sorted_ = 0
    for b in range(pr.shape[0]):
        ns = NS
        if wide and lengths is not None:
            ln = int(lengths[b])
            ns = 0 if ln < 16 else min(NS, (ln - 16) // PASS1_STEP + 1)
            if ns > tm.VOTE_WALK_MAX:
                continue
        k = keys[b, :ns][cv[b, :ns]].tolist()
        if len(k) <= tm.VOTE_WARP_KEYS:
            rows += 1
            sorted_ += len(set(k)) > CAP
    return rows, sorted_


@pytest.mark.parametrize("case", sorted(CASES))
def test_vote_tally_counts_the_warp_rows_and_the_sorted(case):
    rows, NS, D, layout = CASES[case]
    pr, ix = _batch(rows, NS, D, layout)
    got = tm.vote_tally(pr, ix)
    assert got == _expected_tally(pr, ix)
    if case == "n_edges":
        # 257 valid keys leave the warp path (three rows); of the rest, the
        # rows of more than CAP distinct keys are sorted
        assert got == (len(rows) - 3, sum(CAP < len(set(r)) for r in rows if len(r) <= 256))


def _wide_batch():
    """NS * D past MAX_VOTE_KEYS: the wide route, its lengths deciding
    which rows the warp path walks."""
    NS, D = 2100, 8
    rows = [_distinct(2, 40), _distinct(CAP + 1, 40), [(3, 1)] * 5,
            [None] * 2099 + [(3, 4)], _distinct(3, 200)]
    pr, ix = _batch(rows, NS, D, "split")
    lengths = torch.tensor([4214, 120, 80, 4214, 4110], dtype=torch.int32)
    return pr, ix, lengths


def test_vote_tally_on_the_wide_route_follows_the_lengths():
    pr, ix, lengths = _wide_batch()
    assert tm.vote_width(pr.shape[1], ix.D) > tm.MAX_VOTE_KEYS
    got = tm.vote_tally(pr, ix, lengths)
    assert got == _expected_tally(pr, ix, lengths)
    # rows 0 and 3 walk 2,100 samples: listed for the wide kernel
    assert got == (3, 1)
    assert tm.vote_tally(pr, ix) == (0, 0)  # without lengths every row is listed
    assert tm.vote_tally(pr[:0], ix) == (0, 0)


def test_the_cpu_vote_adds_its_tally_to_the_counter():
    rows, NS, D, layout = CASES["cap"]
    pr, ix = _batch(rows, NS, D, layout)
    stats = torch.zeros(tm.VOTE_STAT_SLOTS, dtype=torch.int64)
    out = tm.vote(pr, ix, 40, 20, stats=stats)
    assert torch.equal(out, tm.vote_plain(pr, ix, 40, 20))
    tm.vote(pr, ix, 40, 20, stats=stats)
    r, s = tm.vote_tally(pr, ix)
    assert 0 < s < r and int(stats.sum()) == 2 * (r + (s << 32))
    with pytest.raises(ValueError):
        tm.vote(pr, ix, 40, 20, stats=torch.zeros(4, dtype=torch.int64))


# ---------------- the readers of the counter ----------------

VOTE_READERS = ("vote_sort_share.cancer15", "vote_sort_share.oncokb1100")


class _Record:
    """A record whose window holds the counters as the engine adds them,
    once a batch: 40 batches of 65,536 rows, `sorted_` rows sorted in all;
    without `counted`, a program that never adds them."""

    samples, pairs, window_s, profile = 3, 3 << 20, 9.0, None

    def __init__(self, sorted_=131, counted=True):
        self.timers = {"vote.rows": (40 * 65536, 40),
                       "vote.rows_sorted": (sorted_, 40)} if counted else {}

    def timer(self, label):
        return self.timers.get(label, (0.0, 0))


@pytest.mark.parametrize("name", VOTE_READERS)
def test_the_vote_readers_read_the_share_sorted(name):
    from gfbench import registry

    assert registry.reader(name).read(_Record()) == 131 / (40 * 65536)
    assert registry.reader(name).read(_Record(0)) == 0.0
    listed = {m["name"]: m for m in registry.benchmark()["per_layer"]}[name]
    assert listed["layer"] == "Kernel vote" and listed["moves"] == "device_ms_per_mpair"
    assert listed["source"] == "program_counter"


@pytest.mark.parametrize("name", VOTE_READERS)
def test_the_vote_readers_find_nothing_in_a_program_without_the_counters(name):
    """A program without the counter (the parent of the peel, or a run on
    the CPU) leaves the metric out, and reading does not raise."""
    from gfbench import registry

    assert registry.reader(name).read(_Record(counted=False)) is None


# ---------------- the kernel on the card ----------------


def _on_card(index, dev):
    return dataclasses.replace(index, table=index.table.to(dev), vals=index.vals.to(dev),
                               dupes=index.dupes.to(dev))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tally(stats) -> tuple:
    t = int(stats.sum())
    return t & M32, t >> 32


def _shifted(pr, by: int):
    """Another shard's results on the same rows: every regular hit's
    position moved by `by` (its key too), the rest as they are."""
    pos = torch.where(pr[..., 0] >= 0, pr[..., 1] + by, pr[..., 1])
    return torch.stack([pr[..., 0], pos], -1)


def _check_on_card(pr, ix, dev, lengths=None, gates=GATES, plain_dev="cpu"):
    """vote in both modes, and over 1 and 3 shards, equal to plain (run on
    `plain_dev`: the plain versions are torch alone); the counter equal to
    vote_tally -> the tally."""
    dpr, dix = pr.to(dev), _on_card(ix, dev)
    dlen = None if lengths is None else lengths.to(dev)
    ppr, pix = pr.to(plain_dev), _on_card(ix, plain_dev)
    tally = tm.vote_tally(ppr, pix, None if lengths is None else lengths.to(plain_dev))
    for major, minor in gates:
        stats = torch.zeros(tm.VOTE_STAT_SLOTS, dtype=torch.int64, device=dev)
        got = tm.vote(dpr, dix, major, minor, dlen, stats=stats)
        assert torch.equal(got.cpu(), tm.vote_plain(ppr, pix, major, minor).cpu()), (major, minor)
        assert _tally(stats.cpu()) == tally
    exp = tm.vote_counts_plain(ppr, pix).cpu()
    assert torch.equal(tm.vote_counts(dpr, dix, dlen).cpu(), exp)
    prs = [ppr, _shifted(ppr, 2), _shifted(ppr, 1 << 20)]
    got = tm.vote_counts_shards([p.to(dev) for p in prs], [dix] * 3, dlen)
    for s, p in enumerate(prs):
        assert torch.equal(got[s].cpu(), tm.vote_counts_plain(p, pix).cpu()), s
    return tally


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_peel_and_the_sort_equal_the_plain_vote_on_the_card(case, cuda_device):
    rows, NS, D, layout = CASES[case]
    pr, ix = _batch(rows, NS, D, layout)
    r, s = _check_on_card(pr, ix, cuda_device)
    assert r > 0
    if case in ("n_edges", "cap"):
        assert 0 < s < r  # both the peel and the sort ran


@pytest.mark.cuda
def test_the_wide_route_counts_the_walked_rows_on_the_card(cuda_device):
    pr, ix, lengths = _wide_batch()
    assert _check_on_card(pr, ix, cuda_device, lengths, gates=[(40, 20)]) == (3, 1)


def _random_batch(layout: str, seed: int = 24):
    """The main path's shape: 65,536 rows of 89 samples, D 8; 70% of the
    rows on a diagonal of their own with misses, stray hits and DUPE
    samples from 4,096 dupe rows of 1-8 keys."""
    rng = np.random.default_rng(seed)
    B, NS, D, nd = 65536, 89, 8, 4096
    s = np.arange(NS)[None, :] * PASS1_STEP
    on = rng.random(B) < 0.7
    c0 = rng.integers(0, 136, B)[:, None]
    p0 = rng.integers(0, 1 << 17, B)[:, None]
    u = rng.random((B, NS))
    hit = on[:, None] & (u < 0.75)
    stray = (u >= 0.75) & (u < 0.80)
    dupe = (u >= 0.80) & (u < 0.84)
    contig = np.where(hit, c0, np.where(stray, rng.integers(0, 136, (B, NS)), EMPTY))
    pos = np.where(hit, p0 + s, np.where(stray, rng.integers(0, 1 << 17, (B, NS)), 0))
    contig = np.where(dupe, DUPE, contig)
    pos = np.where(dupe, rng.integers(0, nd, (B, NS)), pos)
    pr = torch.from_numpy(np.stack([contig, pos], -1).astype(np.int32))
    width = rng.integers(1, D + 1, nd)
    dc = rng.integers(0, 136, (nd, D))
    dp = rng.integers(0, 1 << 17, (nd, D))
    live = np.arange(D)[None, :] < width[:, None]
    if layout == "split":
        d = np.stack([np.where(live, dc, EMPTY), np.where(live, dp, 0)], -1).astype(np.int32)
        ix = TorchIndex(split=True, table=torch.zeros((1, 8), dtype=torch.int32),
                        vals=torch.zeros((8, 2), dtype=torch.int32), dupes=torch.from_numpy(d),
                        shift=0, max_dupe=D, cbits=0, pos_bias=0, S=8, D=D, single_probe=False)
        return pr, ix
    pbits = 32 - KV_CBITS
    pay = ((dc + 3) << pbits) | ((dp - KV_POS_BIAS) & ((1 << pbits) - 1))
    d = np.where(live, pay, 0)
    d = ((d + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    ix = TorchIndex(split=False, table=torch.zeros((1, 4), dtype=torch.int32),
                    vals=torch.zeros((0, 2), dtype=torch.int32), dupes=torch.from_numpy(d),
                    shift=0, max_dupe=D, cbits=KV_CBITS, pos_bias=KV_POS_BIAS, S=2, D=D,
                    single_probe=False)
    return pr, ix


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kv2", "split"])
def test_a_random_batch_of_the_main_paths_shape_on_the_card(layout, cuda_device):
    pr, ix = _random_batch(layout)
    r, s = _check_on_card(pr, ix, cuda_device, gates=[(40, 20)], plain_dev=cuda_device)
    assert r == pr.shape[0] and 0 < s < r
