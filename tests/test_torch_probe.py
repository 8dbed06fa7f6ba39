"""The port's table probe (kernel 1's plain version) against the JAX
package: `pallas_lookup` in interpret mode for the split layout,
`kv_lookup` / `hash_lookup` for the kv2, kv4, kv8 and split tables, and
`kvs_lookup` / `kv16_lookup` (with the numpy oracles `lookup_np_kvs` /
`lookup_np_kv16`) for the single-probe tables. A Python mirror of the
kernel's steps (code rows staged as 2-bit words and a 255 mask, k-mers
read across two words, h1 first, h2 only where the kv rule or, on
single-probe rows, the overflow flag asks for it, Q queries a thread; on
single-probe rows a lane pair a query, a 16-byte piece of a row a lane,
kv16's key half first and its payload half only where the keys ask for
it) is held to the same references on edge rows and edge queries, with
the table rows and 32-byte sectors it loads. The packer invariant that
kv16's key-half rule relies on (a flagged row keeps S-1 real keys inline
and the sentinel with the marker in its last slot) is held on both
packers. All outputs are integers, so equal means bit-equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import (
    EMPTY,
    OVF_PAYLOAD,
    h1_np,
    h2_np,
    lookup_np_kv16,
    lookup_np_kvs,
    pack_index,
    pack_index_kv,
    pack_index_kv16,
    pack_index_kvs,
)
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.config import KMER
from genefuserust_tpu_torch.core.sequence import encode_bases
from genefuserust_tpu_torch.ops import cuda as tcuda
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.index import _pack_kv16, _pack_kvs, index_to_torch
from genefuserust_tpu_torch.profiling.large_tables import rows_probed

# layout -> pack_index_kv arguments (kv8 is the packer's default)
KV_LAYOUTS = {
    "kv2": dict(target_load=0.5, slots=1),
    "kv4": dict(target_load=0.6, slots=2),
    "kv8": dict(),
}
SINGLE_LAYOUTS = ("kvs", "kv16")
# every table layout the probe takes
LAYOUTS = ("split", *sorted(KV_LAYOUTS), *SINGLE_LAYOUTS)


def dupe_panel():
    """make_panel with a 28 bp motif planted 3x in GENE1 (dupe entries) and
    8x in GENE2 (high-level dupes)."""
    panel = make_panel(seed=11)
    motif = "ACGTTGCAACGGTTACGATCCAGTTACG"
    for (_, chrom, start, _), offs in zip(
        panel.genes, ([1000, 3000, 7000], [500 + 1100 * k for k in range(8)])
    ):
        s = panel.contigs[chrom]
        for off in offs:
            s = s[: start + off] + motif + s[start + off + len(motif) :]
        panel.contigs[chrom] = s
    return panel


@pytest.fixture(scope="module")
def indexer(tmp_path_factory):
    panel = dupe_panel()
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    return ix


def _queries(ix, n, seed):
    """Half real keys, half random 32-bit values (about half >= 2^31)."""
    rng = np.random.default_rng(seed)
    real = rng.choice(np.asarray(ix.uniq_keys), size=n // 2).astype(np.uint32)
    miss = rng.integers(0, 2**32, n - n // 2, dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([real, miss])
    rng.shuffle(q)
    assert (q >= 2**31).sum() > n // 8
    return q


def _as_i32(q):
    return q.astype(np.uint32).view(np.int32)


def test_buckets_match_numpy_hashes():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    k[:4] = [0, 2**31, 2**32 - 1, 0x9E3779B1]
    for shift in (4, 12, 26, 28):
        b1, b2 = tm.buckets(torch.from_numpy(k.astype(np.int64)), shift)
        assert (b1.numpy() == h1_np(k, shift)).all()
        assert (b2.numpy() == h2_np(k, shift)).all()


def test_probe_matches_pallas_lookup(indexer):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.pallas_lookup import TILE, pallas_lookup

    packed = pack_index(indexer)
    q = _as_i32(_queries(indexer, TILE, seed=0))
    got = tm.probe_kmers(
        torch.from_numpy(q), torch.ones(TILE, dtype=torch.bool),
        index_to_torch(packed, "cpu"),
    ).numpy()
    exp = np.asarray(
        pallas_lookup(
            jnp.asarray(q), jnp.asarray(packed.keys_tbl),
            jnp.asarray(packed.vals_tbl), packed.shift, interpret=True,
        )
    )
    assert (got == exp).all()
    assert (got[:, 0] != EMPTY).sum() >= TILE // 2


def test_probe_matches_hash_lookup_with_invalid(indexer):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import hash_lookup

    packed = pack_index(indexer)
    q = _queries(indexer, 6000, seed=2)
    valid = np.random.default_rng(3).random(q.shape) < 0.8
    c, p = hash_lookup(
        (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl)),
        packed.shift, jnp.asarray(q), jnp.asarray(valid),
    )
    got = tm.probe_kmers(
        torch.from_numpy(_as_i32(q)), torch.from_numpy(valid),
        index_to_torch(packed, "cpu"),
    ).numpy()
    assert (got[:, 0] == np.asarray(c)).all()
    assert (got[:, 1] == np.asarray(p)).all()
    assert (got[~valid, 0] == EMPTY).all()


@pytest.mark.parametrize("layout", sorted(KV_LAYOUTS))
def test_probe_matches_kv_lookup(indexer, layout):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import kv_lookup

    packed = pack_index_kv(indexer, **KV_LAYOUTS[layout])
    assert packed is not None
    assert packed.kv_tbl.shape[1] == {"kv2": 2, "kv4": 4, "kv8": 8}[layout]
    q = _queries(indexer, 6000, seed=4)
    valid = np.random.default_rng(5).random(q.shape) < 0.85
    c, p = kv_lookup(
        jnp.asarray(packed.kv_tbl), packed.shift, packed.cbits, packed.pos_bias,
        jnp.asarray(q), jnp.asarray(valid),
    )
    c, p = np.asarray(c), np.asarray(p)
    got = tm.probe_kmers(
        torch.from_numpy(_as_i32(q)), torch.from_numpy(valid),
        index_to_torch(packed, "cpu"),
    ).numpy()
    assert (got[:, 0] == c).all()
    # JAX leaves the pos of an invalid query as whatever its row-0 probe
    # decoded (the engine never reads it, contig is EMPTY); the port makes
    # no load for an invalid query and reports pos 0
    hit = c != EMPTY
    assert (got[hit, 1] == p[hit]).all()
    assert (got[~valid, 1] == 0).all()
    # regular hits, dupes and high dupes are all exercised
    assert (c >= 0).any() and (c == -1).any() and (c == -2).any()


def _need2_jax(packed, k, valid):
    """JAX `_single_probe_lookup`'s need2, in numpy: a valid query whose h1
    row is flagged and whose matching slots' payloads sum to 0."""
    S = packed.kv_tbl.shape[1] // 2
    r1 = packed.kv_tbl[np.where(valid, h1_np(k, packed.shift), 0)]
    pay = np.where(r1[:, :S] == k.astype(np.uint32).view(np.int32)[:, None],
                   r1[:, S:], 0).sum(1, dtype=np.int32)
    return valid & (r1[:, 2 * S - 1] == OVF_PAYLOAD) & (pay == 0)


@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_single_probe_lookup_matches_jax(indexer, layout):
    """lookup, probe_kmers and the kernel mirror on the single-probe tables
    against JAX kvs_lookup / kv16_lookup and the numpy oracles, on keys in
    unflagged and flagged h1 rows, keys spilled to h2, misses on flagged
    and unflagged rows, keys and misses on unflagged rows with S-1 keys
    and an empty last slot, the sentinel (in an unflagged row, then in a
    flagged one) and invalid queries; the mirror loads valid + JAX need2
    rows on the packed table, and on the copy whose sentinel row is
    flagged without its S-1 keys fewer where the key half rules a flag
    out (the h2 row cannot hold the key; the results are JAX's)."""
    table = _packed(indexer, layout)
    packed, q, names = _single_queries(indexer, table)
    oracle = lookup_np_kvs if layout == "kvs" else lookup_np_kv16
    sentinel = np.array([table.empty_key] * 3, np.uint64)
    ones = np.ones(3, bool)
    for p, qq, vv, nn in ((table, sentinel, ones, np.array(["sentinel"] * 3)),
                          (table, q, names != "invalid", names),
                          (packed, q, names != "invalid", names)):
        index = index_to_torch(p, "cpu")
        assert index.single_probe and index.S == {"kvs": 4, "kv16": 8}[layout]
        assert tcuda.probe_name(index) == f"probe_{layout}"
        got, rows, sectors = _mirror_single(index, qq, vv)
        c, pos = _jax_lookup(p, layout, qq.astype(np.uint32), vv)
        _assert_like_jax(got, c, pos)
        assert np.array_equal(_mirror_lookup(index, qq, vv)[0], got)
        args = (torch.from_numpy(qq.astype(np.int64)), torch.from_numpy(vv))
        assert np.array_equal(torch.stack(tm.lookup(index, *args), 1).numpy(), got)
        flat = tm.probe_kmers(torch.from_numpy(qq.astype(np.uint32).view(np.int32)),
                              torch.from_numpy(vv), index)
        assert np.array_equal(flat.numpy(), got)
        oc, op = oracle(p, qq[vv].astype(np.uint32))
        assert (got[vv, 0] == oc).all()
        assert (got[vv, 1][oc != EMPTY] == op[oc != EMPTY]).all()
        need2 = _need2_jax(p, qq, vv)
        if p is table or layout == "kvs":
            assert rows == vv.sum() + need2.sum()
    if layout == "kv16":
        assert rows < vv.sum() + need2.sum()
    # the table's own sentinel row holds no flag at this load: one row each
    sb = int(_h1(np.uint64(table.empty_key), table.shift))
    assert table.kv_tbl[sb, -1] != OVF_PAYLOAD
    by = {n: got[names == n] for n in np.unique(names)}
    for n in ("h1_unflagged", "h1_flagged", "spilled", "h1_flaggable"):
        assert (by[n][:, 0] != EMPTY).all(), n
    for n in ("miss_flagged", "miss_unflagged", "miss_flaggable", "miss_sentinel_row",
              "sentinel", "invalid"):
        assert (by[n][:, 0] == EMPTY).all(), n
    assert (by["invalid"][:, 1] == 0).all()
    # spilled keys and misses on flagged rows load their h2 row; the
    # sentinel in a flagged row matches the marker's payload 1 and does not
    assert need2[names == "spilled"].all() and need2[names == "miss_flagged"].all()
    assert not need2[np.isin(names, ["sentinel", "h1_flagged", "h1_unflagged",
                                     "h1_flaggable", "miss_flaggable"])].any()
    # JAX reads the flagged sentinel row's h2 for its misses, the kernel not
    assert need2[names == "miss_sentinel_row"].all()
    # sectors a query: kvs one a row; kv16 the key half, the payload half
    # for a hit or where a flag is possible, the same again past a flag
    per = {n: set(sectors[names == n].tolist()) for n in np.unique(names)}
    if layout == "kvs":
        want = dict(h1_unflagged={1}, h1_flagged={1}, h1_flaggable={1}, spilled={2},
                    miss_unflagged={1}, miss_flaggable={1}, miss_flagged={2},
                    miss_sentinel_row={2}, invalid={0})
    else:
        want = dict(h1_unflagged={2}, h1_flagged={2}, h1_flaggable={2}, spilled={4},
                    miss_unflagged={1}, miss_flaggable={2}, miss_flagged={3},
                    miss_sentinel_row={1}, invalid={0})
    for n, v in want.items():
        assert per[n] == v, (n, per[n])


@pytest.mark.parametrize("packer", ["port", "jax"])
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_flagged_rows_keep_their_keys_inline(indexer, layout, packer):
    """The packer invariant the kv16 key-half rule relies on, on both
    packers: every flagged row holds keys other than the sentinel in
    slots 0..S-2 and the sentinel with OVF_PAYLOAD in slot S-1, and no
    unflagged row ends in the marker; also at four times the load (more
    flagged rows)."""
    fns = {"port": {"kvs": _pack_kvs, "kv16": _pack_kv16},
           "jax": {"kvs": pack_index_kvs, "kv16": pack_index_kv16}}[packer][layout]
    base = {"kvs": 1.0, "kv16": 4.0}[layout]
    for load in (base, 4 * base):
        p = fns(indexer, target_load=load)
        assert p is not None
        S = p.kv_tbl.shape[1] // 2
        keys, pay = p.kv_tbl[:, :S], p.kv_tbl[:, S:]
        sent = np.int64(p.empty_key).astype(np.uint32).view(np.int32)
        flagged = pay[:, S - 1] == OVF_PAYLOAD
        assert flagged.sum() >= 10, load
        assert (keys[flagged, : S - 1] != sent).all()
        assert (keys[flagged, S - 1] == sent).all()
        # a marker payload sits only in the last slot of a flagged row (a
        # real payload is never OVF_PAYLOAD: its tag is at least 1)
        assert not (pay[~flagged, S - 1] == OVF_PAYLOAD).any()
        assert not (pay[:, : S - 1] == OVF_PAYLOAD).any()


def test_probe_wrapper_checks_inputs(indexer):
    index = index_to_torch(pack_index(indexer), "cpu")
    codes = torch.zeros((4, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        tm.probe(codes, torch.zeros(4, dtype=torch.int64), 2, index)
    with pytest.raises(ValueError, match="contiguous"):
        tm.probe(codes[:, ::2], torch.zeros(4, dtype=torch.int32), 2, index)


# ---------------- a mirror of the kernel's steps (csrc/probe.cu) ----------------

M32 = 0xFFFFFFFF


def _h1(k, shift):
    return ((k * 0x9E3779B1) & M32) >> shift


def _h2(k, shift):
    return (((k ^ (k >> 15)) * 0x85EBCA6B + 0xC2B2AE35) & M32) >> shift


def _mirror_lookup(index, k, valid):
    """The kernel's lookup of uint64 k-mers: the h1 row of every valid
    query, the h2 row only of the valid queries whose key is not in h1
    (kv, split: `_mirror_split`) or, on single-probe rows, whose h1 row
    carries the overflow flag and matched no nonzero payload
    (`_mirror_single`) -> ((n, 2) int32, rows loaded (split: key rows),
    the 32-byte sectors requested on single-probe rows, the vals elements
    read on split rows, else None)."""
    if index.single_probe:
        out, rows, sectors = _mirror_single(index, k, valid)
        return out, rows, int(sectors.sum())
    if index.split:
        out, rows, vals = _mirror_split(index, k, valid)
        return out, int(rows.sum()), int(vals.sum())
    tbl, S = index.table.numpy(), index.S
    ki = k.astype(np.uint32).view(np.int32)[:, None]
    b1, b2 = (h(k, index.shift).astype(np.int64) for h in (_h1, _h2))
    r1 = tbl[np.where(valid, b1, 0)]
    m1 = r1[:, :S] == ki
    need2 = valid & ~m1.any(1)
    r2 = tbl[np.where(need2, b2, 0)]
    m2 = r2[:, :S] == ki
    rows = int(valid.sum() + need2.sum())
    # need2 leaves h1's sum 0 (no slot matched)
    p = np.where(need2, _pay(m2, r2[:, S:]), _pay(m1, r1[:, S:]))
    return _decoded(index, p, valid), rows, None


def _pay(m, payloads):
    """The uint32 sum (int64) of the payloads that the bool mask m selects
    (matching trailing shapes, summed over them)."""
    sel = np.where(m, payloads.astype(np.int64) & M32, 0)
    return sel.reshape(len(sel), -1).sum(1) & M32


def _decoded(index, p, valid):
    c, pos = tm._decode(torch.from_numpy(p), index.cbits, index.pos_bias)
    v = torch.from_numpy(valid)
    return torch.stack([torch.where(v, c, EMPTY), torch.where(v, pos, 0)], 1).numpy()


def _pieces(tbl, rows, off):
    """(n, 2, 4): lane h's 16-byte piece of each row, its int32 at off + 4h."""
    return np.stack([tbl[rows, off + 4 * h : off + 4 * h + 4] for h in (0, 1)], 1)


def _mirror_single(index, k, valid):
    """lookup_single of csrc/probe.cu: a lane pair a query, lane h reading
    16-byte piece h of a row. kvs: the keys (h 0) and the payloads (h 1),
    the row's one sector, the key lane's match handed to the payload lane,
    which sums the matched payloads and reads the marker (slot 3). kv16:
    the key half first (slots 4h..4h+3, one sector); a lane reads its
    payload piece only where its half of the keys matched, and the odd
    lane the marker's piece (slot 7) where the key half leaves a flag
    possible (slots 0-6 real keys, slot 7 the sentinel); the payload half
    is one sector. h2 past a marked row whose matched payloads sum to 0,
    read the same way -> ((n, 2) int32, rows loaded, (n,) sectors a
    query)."""
    tbl, S = index.table.numpy(), index.S
    ki = k.astype(np.uint32).view(np.int32)[:, None, None]
    b1, b2 = (h(k, index.shift).astype(np.int64) for h in (_h1, _h2))
    kp = _pieces(tbl, np.where(valid, b1, 0), 0)
    if S == 4:
        m = (kp[:, 0] == ki[:, 0]) & valid[:, None]
        pay = _pay(m, kp[:, 1])
        need2 = valid & (kp[:, 1, 3] == OVF_PAYLOAD) & (pay == 0)
        kp2 = _pieces(tbl, np.where(need2, b2, 0), 0)
        pay |= _pay((kp2[:, 0] == ki[:, 0]) & need2[:, None], kp2[:, 1])
        sectors = valid.astype(np.int64) + need2
    else:
        sent = np.int32(index.empty_key)
        m = (kp == ki) & valid[:, None, None]
        real = kp != sent
        flaggable = valid & real[:, 0].all(1) & real[:, 1, :3].all(1) & ~real[:, 1, 3]
        want = m.any(2)
        want[:, 1] |= flaggable
        pp = np.where(want[:, :, None], _pieces(tbl, np.where(valid, b1, 0), S), 0)
        pay = _pay(m, pp)
        need2 = flaggable & (pp[:, 1, 3] == OVF_PAYLOAD) & (pay == 0)
        kp2 = _pieces(tbl, np.where(need2, b2, 0), 0)
        m2 = (kp2 == ki) & need2[:, None, None]
        want2 = m2.any(2)
        pp2 = np.where(want2[:, :, None], _pieces(tbl, np.where(need2, b2, 0), S), 0)
        pay |= _pay(m2, pp2)
        sectors = valid.astype(np.int64) + want.any(1) + need2 + want2.any(1)
    return _decoded(index, pay, valid), int(valid.sum() + need2.sum()), sectors


def _mirror_split(index, k, valid):
    """lookup_split of csrc/probe.cu: a lane pair a query, lane h reading
    16-byte piece h of a key row (slots 4h..4h+3, the row's one sector);
    each lane's 4-bit match handed to the other, so both hold the 8-bit
    match and take its lowest bit, the even lane's half first; h2 pieces
    only where no slot of h1 matched; then the query's own lane reads the
    8-byte vals element of the slot, none for a miss or an invalid query
    -> ((n, 2) int32, (n,) key rows a query, (n,) vals elements a query)."""
    tbl, S = index.table.numpy(), index.S
    assert S == 8
    ki = k.astype(np.uint32).view(np.int32)[:, None, None]
    b1, b2 = (h(k, index.shift).astype(np.int64) for h in (_h1, _h2))
    bits = np.uint32(1) << np.arange(8, dtype=np.uint32).reshape(2, 4)

    def match(rows, live):
        # each lane's 4 bits at 4h, or-ed across the pair
        hit = (_pieces(tbl, np.where(live, rows, 0), 0) == ki) & live[:, None, None]
        return np.where(hit, bits, np.uint32(0)).reshape(len(rows), 8).sum(1, dtype=np.uint32)

    m = match(b1, valid)
    need2 = valid & (m == 0)
    m = np.where(need2, match(b2, need2), m)
    found = m != 0
    slot = np.where(found, np.log2(np.where(found, m & -m, 1)).astype(np.int64), 0)
    at = (np.where(need2, b2, b1) * S + slot) * 2
    v = index.vals.numpy().reshape(-1)
    c = np.where(found, v[np.where(found, at, 0)], EMPTY)
    pos = np.where(found, v[np.where(found, at + 1, 0)], 0)
    return (np.stack([c, pos], 1).astype(np.int32), valid.astype(np.int64) + need2,
            found.astype(np.int64))


def _stage(flat, c0, nch):
    """Chunks c0 .. c0+nch-1 of 16 code bytes -> (2-bit bases, first base
    highest; 255 mask, first base in bit 15), as uint64. Bytes past the
    end read as 255."""
    at = (c0 + np.arange(nch))[:, None] * 16 + np.arange(16)
    b = np.where(at < len(flat), flat[np.minimum(at, len(flat) - 1)], 255).astype(np.uint64)
    bad = b == 255
    code = np.where(bad, 0, b & 3)
    pk = (code << (2 * (15 - np.arange(16, dtype=np.uint64)))).sum(1)
    mk = (bad.astype(np.uint64) << (15 - np.arange(16, dtype=np.uint64))).sum(1)
    return pk, mk


def split_default_shape():
    """(queries a thread, threads a block) of the split kernel in a build of
    csrc/probe.cu without -D overrides: its PROBE_SPLIT_Q and
    PROBE_SPLIT_THREADS, which the library reports as
    `cuda.probe_split_shape()`."""
    import re

    src = open(os.path.join(tcuda.CSRC, "probe.cu")).read()
    return tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                 for name in ("PROBE_SPLIT_Q", "PROBE_SPLIT_THREADS"))


def staged_chunks_max(W, NQ, stride, T, Q):
    """The launch's shared-memory words for a tile's span (probe_launch in
    csrc/probe.cu): T*Q - 1 steps of `stride` bases, plus the bases after
    a row's last k-mer start at each row boundary the tile crosses, + 3."""
    rows_max = (T * Q - 1) // NQ + 2
    span = stride * (T * Q - 1) + (rows_max - 1) * max(0, W - NQ * stride)
    return span // 16 + 3


def _kernel_probe(codes, lengths, stride, index, T=64, Q=4):
    """Mirror of the kernel over (B, W) code rows: tiles of T*Q queries,
    thread t's i-th query q0 + i*T + t; the tile's span, from its first
    query's k-mer to its last one's, staged once as 2-bit words (within the
    launch's shared memory for any W), each k-mer the 32 bits at its offset
    across two words and valid when its window holds no 255 bit and
    j <= len - 16 -> ((B, NQ, 2) int32, rows loaded, sectors requested on
    single-probe rows, vals elements read on split rows, else None)."""
    B, W = codes.shape
    NQ = (W - KMER + stride) // stride
    n, flat = B * NQ, codes.reshape(-1)
    out, loaded, sectors = np.zeros((n, 2), np.int32), 0, 0
    nch_max = staged_chunks_max(W, NQ, stride, T, Q)
    for q0 in range(0, n, T * Q):
        ql = min(n, q0 + T * Q) - 1
        ra, rb = q0 // NQ, ql // NQ
        c0 = (ra * W + (q0 - ra * NQ) * stride) >> 4
        base = c0 * 16 - ra * W  # the span's first byte in row ra
        nch = (((rb - ra) * W + (ql - rb * NQ) * stride - base) >> 4) + 2
        assert nch <= nch_max
        pk, mk = _stage(flat, c0, nch)
        q = (q0 + np.arange(Q)[:, None] * T + np.arange(T)).reshape(-1)
        q = q[q < n]
        row = q // NQ
        j = (q - row * NQ) * stride
        g = (row - ra) * W + j - base
        c, o = g >> 4, (g & 15).astype(np.uint64)
        k = (((pk[c] << np.uint64(32)) | pk[c + 1]) >> (np.uint64(32) - 2 * o)) & M32
        bad = ((((mk[c] << np.uint64(16)) | mk[c + 1]) << o) & M32) >> np.uint64(16)
        valid = (bad == 0) & (j <= lengths[row].astype(np.int64) - KMER)
        out[q], rows, sec = _mirror_lookup(index, k, valid)
        loaded += rows
        sectors += sec or 0
    counted = index.single_probe or index.split
    return out.reshape(B, NQ, 2), loaded, sectors if counted else None


def _rows_needed(index, codes, lengths, stride):
    """Rows a lookup needs, from the plain version: one per valid k-mer
    whose key lies in its h1 row, two for any other; on single-probe rows
    one per valid k-mer and a second where its h1 row is flagged and no
    slot matched with a nonzero payload."""
    km, ok = tm.compute_kmers(torch.from_numpy(codes), torch.from_numpy(lengths))
    k = km[:, ::stride][ok[:, ::stride]]
    b1, _ = tm.buckets(k, index.shift)
    r1, S = index.table[b1], index.S
    match = r1[:, :S] == tm._i32(k)[:, None]
    if index.single_probe:
        pay = torch.where(match, r1[:, S:], 0).to(torch.int64).sum(1) & M32
        return int(k.shape[0] + ((r1[:, 2 * S - 1] == OVF_PAYLOAD) & (pay == 0)).sum())
    return int(2 * k.shape[0] - match.any(1).sum())


def _edge_codes(ix, W=45, seed=8):
    """Code rows: a single 255 at every position, lengths 0, 15, 16, 17
    and W, all-T rows (k-mers >= 2^31), rows of panel sequence (hits,
    dupes) and random rows with 255s. W = 45 keeps rows off the 16-byte
    chunk grid."""
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    panel = dupe_panel()
    seqs = [panel.contigs[chrom][start:end] for _, chrom, start, end in panel.genes]
    for p in range(W):
        r = encode_bases(seqs[p % len(seqs)][40 * p : 40 * p + W])
        r[p] = 255
        rows.append(r)
        lens.append(W)
    for L in (0, 15, 16, 17, W):
        rows.append(encode_bases(seqs[0][1000 + L : 1000 + L + W]))
        lens.append(L)
    rows.append(np.full(W, 3, np.uint8))
    lens.append(W)
    for _ in range(60):
        s = seqs[int(rng.integers(0, len(seqs)))]
        at = int(rng.integers(0, len(s) - W))
        rows.append(encode_bases(s[at : at + W]))
        lens.append(int(rng.integers(KMER, W + 1)))
    rnd = rng.integers(0, 4, (40, W), dtype=np.uint8)
    rnd[rng.random(rnd.shape) < 0.03] = 255
    rows += list(rnd)
    lens += rng.integers(0, W + 1, 40).tolist()
    return np.stack(rows).astype(np.uint8), np.asarray(lens, np.int32)


def _edge_queries(ix, packed, seed=9):
    """Flat uint32 queries: real keys, random ones (half >= 2^31), real
    keys >= 2^31, the absent-key sentinel, keys placed in h2 while their h1
    row is full, keys with h1 == h2 (in the table or not) and copies of
    real keys marked invalid -> (packed, queries, names); the invalid
    group is named "invalid". Where no key in h2 has a full h1 row (the
    split layout's 8-slot rows at this load), the empty slots of 50 such
    h1 rows are filled with keys absent from the panel, in a copy of the
    table. On the split layout also keys in each slot 0-7 of their h1 row
    ("slot_s": real ones where the slot holds any, and keys absent from
    the panel written into the copy, each with vals of its own) and in
    slots 4-7 of their h2 row (the odd lane's half), the sentinel's h1 row
    filled in slots 0-3 so that it first matches in the odd lane's half."""
    rng = np.random.default_rng(seed)
    index = index_to_torch(packed, "cpu")
    tbl, S = index.table.numpy(), index.S
    keys = np.asarray(ix.uniq_keys).astype(np.uint64)
    sentinel = np.uint64(packed.empty_key)
    b1, b2 = _h1(keys, index.shift), _h2(keys, index.shift)
    ki = keys.astype(np.uint32).view(np.int32)[:, None]
    in_h1 = (tbl[b1][:, :S] == ki).any(1)
    empty = np.int64(sentinel).astype(np.uint32).view(np.int32)
    h1_full = (tbl[b1][:, :S] != empty).all(1)
    split = getattr(packed, "keys_tbl", None) is not None
    # the added groups draw from a generator of their own, so the others
    # keep their keys
    frng = np.random.default_rng(seed + 1000)
    fresh = np.setdiff1d(frng.integers(0, 2**32, 400_000, dtype=np.uint64), keys)
    fresh = frng.permutation(fresh[fresh != sentinel])
    groups = {}
    if split:
        kt, vt = packed.keys_tbl.copy(), packed.vals_tbl.copy()
        if not (~in_h1 & h1_full).any():
            old = np.setdiff1d(rng.integers(0, 2**32, 4096, dtype=np.uint64), keys)
            old = old[old != sentinel]
            rows = np.unique(b1[~in_h1])[:50]
            slots = kt[rows] == empty
            n = int(slots.sum())
            kt[rows[np.nonzero(slots)[0]], np.nonzero(slots)[1]] = (
                old[:n].astype(np.uint32).view(np.int32))
            fresh = fresh[~np.isin(fresh, old[:n])]
        # fresh keys in slot s of their own h1 row (or, "h2_slot", of their
        # h2 row), where that slot is empty and the key is in no other row
        # of the copy; each with vals (s, 1000 * s + i)
        def plant(hash_fn, slot, name, count=16):
            placed = []
            for k in fresh:
                r = int(hash_fn(k, index.shift))
                if len(placed) == count:
                    break
                if kt[r, slot] != empty:
                    continue
                if name == "h2_slot" and int(_h1(k, index.shift)) == r:
                    continue
                kt[r, slot] = np.int64(k).astype(np.uint32).view(np.int32)
                vt[r * S + slot] = (slot, 1000 * slot + len(placed))
                placed.append(k)
            assert len(placed) == count, (name, slot)
            return np.asarray(placed, np.uint64)

        sb = int(_h1(sentinel, index.shift))
        for s in range(4):  # the sentinel matches first in the odd lane's half
            if kt[sb, s] == empty:
                kt[sb, s] = np.int64(fresh[0]).astype(np.uint32).view(np.int32)
                fresh = fresh[1:]
        for s in range(S):
            real = keys[tbl[b1, s] == ki[:, 0]][:16]
            groups[f"slot_{s}"] = np.concatenate([real, plant(_h1, s, "slot")])
            fresh = fresh[~np.isin(fresh, groups[f"slot_{s}"])]
        h2s = []
        for s in range(4, 8):
            h2s.append(plant(_h2, s, "h2_slot", 8))
            fresh = fresh[~np.isin(fresh, h2s[-1])]
        groups["h2_slot_4_7"] = np.concatenate(h2s)
        packed = dataclasses.replace(packed, keys_tbl=kt, vals_tbl=vt)
        tbl = kt
        h1_full = (tbl[b1][:, :S] != empty).all(1)
    rnd = rng.integers(0, 2**32, 200000, dtype=np.uint64)
    same = rnd[_h1(rnd, index.shift) == _h2(rnd, index.shift)]
    groups.update({
        "real": rng.choice(keys, 500),
        "random": rnd[:500],
        "real_high": keys[keys >= 2**31][:100],
        "sentinel": np.array([sentinel] * 3, np.uint64),
        "h2_with_h1_full": keys[~in_h1 & h1_full][:200],
        "h1_equals_h2": np.concatenate([keys[b1 == b2], same[:50]]),
        "invalid": frng.choice(keys, 60),
    })
    for name, v in groups.items():
        assert len(v), name
    names = np.concatenate([[k] * len(v) for k, v in groups.items()])
    return packed, np.concatenate(list(groups.values())).astype(np.uint64), names


def _packed(ix, layout):
    if layout == "split":
        return pack_index(ix)
    if layout in SINGLE_LAYOUTS:
        p = (pack_index_kvs if layout == "kvs" else pack_index_kv16)(ix)
        assert p is not None and p.kv_tbl.shape[1] == {"kvs": 8, "kv16": 16}[layout]
        return p
    return pack_index_kv(ix, **KV_LAYOUTS[layout])


def _jax_lookup(packed, layout, k, valid):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import hash_lookup, kv16_lookup, kv_lookup, kvs_lookup

    if layout == "split":
        c, p = hash_lookup((jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl)),
                           packed.shift, jnp.asarray(k), jnp.asarray(valid))
    else:
        fn = {"kvs": kvs_lookup, "kv16": kv16_lookup}.get(layout, kv_lookup)
        c, p = fn(jnp.asarray(packed.kv_tbl), packed.shift, packed.cbits, packed.pos_bias,
                  jnp.asarray(k), jnp.asarray(valid))
    return np.asarray(c), np.asarray(p)


def _single_queries(ix, packed, seed=12):
    """Flat uint64 queries on a single-probe table: keys in unflagged and
    in flagged h1 rows, keys spilled to h2, misses whose h1 row is flagged
    or not, keys and misses on unflagged rows with S-1 keys and an empty
    last slot (flaggable: the key half alone cannot rule a flag out), the
    sentinel, misses on the sentinel's h1 row, and copies of spilled and
    flagged keys to be marked invalid -> (packed, queries, names). The
    returned table is a copy whose sentinel's h1 row carries the flag (its
    last slot the sentinel with OVF_PAYLOAD) without S-1 keys inline, so
    the sentinel meets a flagged row and the packer invariant does not
    hold there."""
    rng = np.random.default_rng(seed)
    S = packed.kv_tbl.shape[1] // 2
    tbl = packed.kv_tbl.copy()
    sentinel = np.uint64(packed.empty_key)
    s32 = np.int64(sentinel).astype(np.uint32).view(np.int32)
    sb = int(_h1(sentinel, packed.shift))
    assert (tbl[sb, : S - 1] == s32).any()  # not filled: no S-1 keys inline
    flaggable = (packed.kv_tbl[:, : S - 1] != s32).all(1) & (packed.kv_tbl[:, S - 1] == s32)
    tbl[sb, S - 1] = s32
    tbl[sb, 2 * S - 1] = OVF_PAYLOAD
    packed = dataclasses.replace(packed, kv_tbl=tbl)
    keys = np.asarray(ix.uniq_keys).astype(np.uint64)
    ki = keys.astype(np.uint32).view(np.int32)[:, None]
    b1, b2 = _h1(keys, packed.shift), _h2(keys, packed.shift)
    flagged = tbl[:, 2 * S - 1] == OVF_PAYLOAD
    flaggable &= ~flagged
    in_h1 = (tbl[b1][:, :S] == ki).any(1)
    in_h2 = (tbl[b2][:, :S] == ki).any(1) & ~in_h1
    rnd = np.setdiff1d(rng.integers(0, 2**32, 400_000, dtype=np.uint64), keys)
    rnd = rnd[rnd != sentinel]
    rb = _h1(rnd, packed.shift)
    # misses whose h1 row is the sentinel's: h1 inverted, the low bits random
    inv = pow(0x9E3779B1, -1, 1 << 32)
    low = rng.integers(0, 1 << packed.shift, 50, dtype=np.uint64)
    at_sb = np.setdiff1d(((np.uint64(sb) << np.uint64(packed.shift)) | low) * np.uint64(inv)
                         & np.uint64(M32), keys)
    assert (_h1(at_sb, packed.shift) == sb).all()
    groups = {
        "sentinel": np.array([sentinel] * 3, np.uint64),
        "h1_unflagged": rng.choice(keys[in_h1 & ~flagged[b1]], 400),
        "h1_flagged": keys[in_h1 & flagged[b1]][:200],
        "h1_flaggable": keys[in_h1 & flaggable[b1]][:200],
        "spilled": keys[in_h2],
        "miss_flagged": rnd[flagged[rb] & (rb != sb)][:200],
        "miss_unflagged": rnd[~flagged[rb] & ~flaggable[rb]][:400],
        "miss_flaggable": rnd[flaggable[rb]][:200],
        "miss_sentinel_row": at_sb[at_sb != sentinel],
    }
    groups["invalid"] = np.concatenate([groups["spilled"][:20], groups["h1_flagged"][:20],
                                        groups["miss_flagged"][:20]])
    for name, v in groups.items():
        assert len(v), name
    names = np.concatenate([[k] * len(v) for k, v in groups.items()])
    return packed, np.concatenate(list(groups.values())).astype(np.uint64), names


def _assert_like_jax(got, c, p):
    """Contig everywhere; pos where JAX found a hit (JAX leaves an invalid
    kv query's pos as its row-0 probe decoded, the port reports 0)."""
    assert (got[..., 0] == c).all()
    hit = c != EMPTY
    assert (got[..., 1][hit] == p[hit]).all()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_mirror_matches_jax_on_edge_rows(indexer, layout, stride):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import compute_kmers

    packed = _packed(indexer, layout)
    index = index_to_torch(packed, "cpu")
    codes, lengths = _edge_codes(indexer)
    for T, Q in ((32, 1), (64, 4), (32, 8)):
        got, loaded, sectors = _kernel_probe(codes, lengths, stride, index, T, Q)
        plain = tm.probe_plain(torch.from_numpy(codes), torch.from_numpy(lengths), stride, index)
        assert np.array_equal(got, plain.numpy())
        # h2 rows only for the valid k-mers whose key is not in h1 (on
        # single-probe rows: past a flagged h1 row)
        assert loaded == _rows_needed(index, codes, lengths, stride)
        # kvs: a sector a row; kv16: a key half a row, and payload halves
        # for the hits and where a flag is possible, fewer than two a row;
        # split: a vals element a hit
        if layout == "kvs":
            assert sectors == loaded
        elif layout == "kv16":
            assert loaded < sectors < 2 * loaded
        elif layout == "split":
            need = rows_probed(index, torch.from_numpy(codes), torch.from_numpy(lengths), stride)
            assert (loaded, sectors) == (need["rows"], need["vals_rows"])
    km, ok = compute_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    c, p = _jax_lookup(packed, layout, km[:, ::stride], ok[:, ::stride])
    _assert_like_jax(got, c, p)
    # every kind of result is exercised
    assert (c >= 0).any() and (c == -1).any() and (c == EMPTY).any()


def _edge_validity(names, seed=10):
    """The edge queries' validity: 90% of the random group, none of the
    invalid group, every other query."""
    valid = np.random.default_rng(seed).random(names.shape) < 0.9
    valid[names != "random"] = True
    valid[names == "invalid"] = False
    return valid


@pytest.mark.parametrize("layout", ["split", *sorted(KV_LAYOUTS)])
def test_kernel_mirror_matches_jax_on_edge_queries(indexer, layout):
    packed, q, names = _edge_queries(indexer, _packed(indexer, layout))
    index = index_to_torch(packed, "cpu")
    valid = _edge_validity(names)
    got, loaded, counted = _mirror_lookup(index, q, valid)
    assert loaded >= valid.sum()
    c, p = _jax_lookup(packed, layout, q.astype(np.uint32), valid)
    _assert_like_jax(got, c, p)
    flat = tm.probe_kmers(torch.from_numpy(q.astype(np.uint32).view(np.int32)),
                          torch.from_numpy(valid), index)
    assert np.array_equal(got, flat.numpy())
    assert (got[names == "sentinel", 0] == EMPTY).all()
    assert (got[names == "h2_with_h1_full", 0] != EMPTY).all()
    assert (got[names == "real_high", 0] != EMPTY).all()
    assert (got[names == "invalid"] == [EMPTY, 0]).all()
    assert (q[names == "real_high"] >= 2**31).all() and (q >= 2**31).sum() > 100
    if layout != "split":
        assert counted is None
    else:
        # the odd lane's half holds keys: h1 slots 4-7 and h2 slots 4-7
        for s in range(8):
            assert (got[names == f"slot_{s}", 0] != EMPTY).all(), s
        planted = np.isin(names, [f"slot_{s}" for s in range(4, 8)])
        assert (got[planted, 0] == [int(n[-1]) for n in names[planted]]).all()
        assert (got[names == "h2_slot_4_7", 0] == np.repeat(np.arange(4, 8), 8)).all()
        # key rows and vals elements a query: one row in h1, two past it, a
        # vals element a hit (the sentinel matches an empty slot and reads
        # its EMPTY vals), none for an invalid query
        _, rows, vals = _mirror_split(index, q, valid)
        per = {n: (set(rows[names == n].tolist()), set(vals[names == n].tolist()))
               for n in np.unique(names)}
        want = dict(slot_0=({1}, {1}), slot_7=({1}, {1}), h2_slot_4_7=({2}, {1}),
                    h2_with_h1_full=({2}, {1}), sentinel=({1}, {1}), invalid=({0}, {0}))
        for n, v in want.items():
            assert per[n] == v, (n, per[n])
        keys = index.table[torch.from_numpy(np.stack([_h1(q, index.shift), _h2(q, index.shift)],
                                                     1).astype(np.int64))]
        in_row = (keys == torch.from_numpy(_as_i32(q))[:, None, None]).any(2).numpy()
        assert counted == (valid & in_row.any(1)).sum()
        assert loaded == valid.sum() + (valid & ~in_row[:, 0]).sum()
    if layout == "split":
        from genefuserust_tpu.ops.pallas_lookup import TILE, pallas_lookup
        import jax.numpy as jnp

        pad = np.zeros(-len(q) % TILE, np.uint64)
        qq = np.concatenate([q, pad]).astype(np.uint32).view(np.int32)
        exp = np.asarray(pallas_lookup(jnp.asarray(qq), jnp.asarray(packed.keys_tbl),
                                       jnp.asarray(packed.vals_tbl), packed.shift,
                                       interpret=True))[: len(q)]
        assert np.array_equal(got[valid], exp[valid])


def test_variant_builds_are_named_apart():
    # a launch-shape sweep builds probe.cu with -D overrides beside the
    # port's library, never in its place
    base = tcuda.library_path()
    variant = tcuda.library_path(("probe.cu",), ("PROBE_Q=2", "PROBE_POLICY=0"))
    assert variant != base
    assert variant != tcuda.library_path(("probe.cu",), ("PROBE_Q=2", "PROBE_POLICY=1"))
    assert variant == tcuda.library_path(("probe.cu",), ("PROBE_Q=2", "PROBE_POLICY=0"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _layout_queries(ix, packed, layout, artificial=True):
    """The edge queries of a layout -> (packed, queries, validity). On
    single-probe tables: `_single_queries`' table, whose sentinel row is
    flagged without its keys, or with `artificial=False` the packed table
    itself (where the packer invariant holds)."""
    if layout in SINGLE_LAYOUTS:
        epacked, q, names = _single_queries(ix, packed)
        return (epacked if artificial else packed), q, names != "invalid"
    packed, q, names = _edge_queries(ix, packed)
    return packed, q, names != "invalid"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_probe_kernel_matches_plain(indexer, layout, cuda_device):
    packed = _packed(indexer, layout)
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (300, 192), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 255
    lengths = rng.integers(0, 193, 300).astype(np.int32)
    q = _queries(indexer, 5000, seed=7)
    valid = rng.random(q.shape) < 0.9
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    ecodes, elens = _edge_codes(indexer)
    epacked, eq, ev = _layout_queries(indexer, packed, layout)
    # single-probe rows: also the copy whose sentinel row is flagged
    # without its keys (results only: the kernel may load fewer rows there)
    tables = [(cpu, dev)] + [(index_to_torch(epacked, "cpu"), index_to_torch(epacked, cuda_device))
                             for _ in range(layout in SINGLE_LAYOUTS)]
    for tc, td in tables:
        for c, ln in ((codes, lengths), (ecodes, elens)):
            for stride in (1, 2):
                exp = tm.probe(torch.from_numpy(c), torch.from_numpy(ln), stride, tc)
                got = tm.probe(torch.from_numpy(c).to(cuda_device),
                               torch.from_numpy(ln).to(cuda_device), stride, td)
                assert torch.equal(got.cpu(), exp)
    for p, qq, vv in ((packed, q, valid), (epacked, eq, ev)):
        args = (torch.from_numpy(_as_i32(qq)), torch.from_numpy(vv))
        exp = tm.probe_kmers(*args, index_to_torch(p, "cpu"))
        got = tm.probe_kmers(*(a.to(cuda_device) for a in args), index_to_torch(p, cuda_device))
        assert torch.equal(got.cpu(), exp)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_probe_kernel_loads_the_rows_needed(indexer, layout, cuda_device):
    # the kernel's own count of its table row loads: h2 only for keys not in
    # h1 (on single-probe rows: past a flagged h1 row); on split rows also
    # its count of vals elements, a hit's one each
    packed = _packed(indexer, layout)
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    codes, lengths = _edge_codes(indexer)
    c_d, l_d = torch.from_numpy(codes).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    split = layout == "split"
    for stride in (1, 2):
        exp = tm.probe(torch.from_numpy(codes), torch.from_numpy(lengths), stride, cpu)
        B, W = codes.shape
        NQ = exp.shape[1]
        out = torch.empty((B, NQ, 2), dtype=torch.int32, device=cuda_device)
        loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        tcuda.launch_probe(c_d, l_d, None, None, B * NQ, W, stride, NQ, dev, out,
                           row_loads=loads[:1], vals_loads=loads[1:] if split else None)
        assert torch.equal(out.cpu(), exp)
        assert int(loads[0]) == _rows_needed(cpu, codes, lengths, stride)
        if split:
            mirror = _kernel_probe(codes, lengths, stride, cpu)
            assert loads.tolist() == list(mirror[1:])
    # the edge queries, flat: valid + JAX need2 rows on single-probe tables
    # (the packed table, where the packer invariant holds)
    epacked, eq, ev = _layout_queries(indexer, packed, layout, artificial=False)
    edev = index_to_torch(epacked, cuda_device)
    exp, rows, counted = _mirror_lookup(index_to_torch(epacked, "cpu"), eq, ev)
    if layout in SINGLE_LAYOUTS:
        assert rows == ev.sum() + _need2_jax(epacked, eq, ev).sum()
    out = torch.empty((len(eq), 2), dtype=torch.int32, device=cuda_device)
    loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    name = tcuda.probe_name(edev)
    n0 = tcuda.LAUNCHES[name]
    tcuda.launch_probe(None, None, torch.from_numpy(_as_i32(eq)).to(cuda_device),
                       torch.from_numpy(ev).to(cuda_device), len(eq), 0, 1, 1, edev, out,
                       row_loads=loads[:1], vals_loads=loads[1:] if split else None)
    assert np.array_equal(out.cpu().numpy(), exp) and int(loads[0]) == rows
    if split:
        assert int(loads[1]) == counted
    assert tcuda.LAUNCHES[name] == n0 + 1
    assert name == {"kvs": "probe_kvs", "kv16": "probe_kv16"}.get(layout, "probe")
    # a row-offset view of the codes is refused on the card
    wide = torch.zeros((4, 45), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        tm.probe(wide[1:], torch.zeros(3, dtype=torch.int32, device=cuda_device), 1, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", SINGLE_LAYOUTS)
def test_probe_kernel_counts_the_sectors_requested(indexer, layout, cuda_device):
    """The single-probe variant's own count of the 32-byte sectors it
    requests equals the mirror's, on the edge rows at strides 1 and 2 and
    on the edge queries, on the packed table and on the copy whose
    sentinel row is flagged without its keys."""
    packed = _packed(indexer, layout)
    epacked, eq, ev = _layout_queries(indexer, packed, layout)
    codes, lengths = _edge_codes(indexer)
    c_d, l_d = torch.from_numpy(codes).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    for p in (packed, epacked):
        cpu, dev = index_to_torch(p, "cpu"), index_to_torch(p, cuda_device)
        for stride in (1, 2):
            exp, rows, sectors = _kernel_probe(codes, lengths, stride, cpu)
            B, W = codes.shape
            NQ = exp.shape[1]
            out = torch.empty((B, NQ, 2), dtype=torch.int32, device=cuda_device)
            loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
            tcuda.launch_probe(c_d, l_d, None, None, B * NQ, W, stride, NQ, dev, out,
                               row_loads=loads[:1], sector_loads=loads[1:])
            assert np.array_equal(out.cpu().numpy(), exp)
            assert loads.tolist() == [rows, sectors]
        exp, rows, sectors = _mirror_lookup(cpu, eq, ev)
        out = torch.empty((len(eq), 2), dtype=torch.int32, device=cuda_device)
        loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        tcuda.launch_probe(None, None, torch.from_numpy(_as_i32(eq)).to(cuda_device),
                           torch.from_numpy(ev).to(cuda_device), len(eq), 0, 1, 1, dev, out,
                           row_loads=loads[:1], sector_loads=loads[1:])
        assert np.array_equal(out.cpu().numpy(), exp)
        assert loads.tolist() == [rows, sectors]


@pytest.mark.cuda
def test_split_kernel_at_every_sweep_shape(indexer, cuda_device):
    """Every launch shape `chip_smoke.py --probe-sweep` builds of the split
    kernel (queries a thread x row cache policy x threads a block):
    bit-equal to plain on the packed table and on the edge queries' copy,
    over the edge rows at strides 1 and 2 and the flat edge queries, its
    key-row and vals counts equal to the mirror's, its launch shape as
    the library reports it equal to the build's."""
    from concurrent.futures import ThreadPoolExecutor

    from chip_smoke import split_sweep_shapes

    assert tcuda.probe_split_shape() == split_default_shape()
    shapes = split_sweep_shapes()
    with ThreadPoolExecutor(8) as ex:
        libs = [tcuda.load(p) for p in ex.map(lambda d: tcuda.build(("probe.cu",), d),
                                              [d for _, d in shapes])]
    packed = _packed(indexer, "split")
    epacked, eq, ev = _layout_queries(indexer, packed, "split")
    codes, lengths = _edge_codes(indexer)
    c_d, l_d = torch.from_numpy(codes).to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    B, W = codes.shape
    for p in (packed, epacked):
        cpu, dev = index_to_torch(p, "cpu"), index_to_torch(p, cuda_device)
        want = {s: _kernel_probe(codes, lengths, s, cpu) for s in (1, 2)}
        flat = _mirror_lookup(cpu, eq, ev)
        for (shape, _), lib in zip(shapes, libs):
            q, _, t = shape.split(",")[:3]
            assert tcuda.probe_split_shape(lib) == (int(q), int(t)), shape
            for s, (exp, rows, vals) in want.items():
                NQ = exp.shape[1]
                out = torch.zeros((B, NQ, 2), dtype=torch.int32, device=cuda_device)
                loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
                tcuda.launch_probe(c_d, l_d, None, None, B * NQ, W, s, NQ, dev, out,
                                   row_loads=loads[:1], lib=lib, vals_loads=loads[1:])
                assert np.array_equal(out.cpu().numpy(), exp), (shape, s)
                assert loads.tolist() == [rows, vals], (shape, s)
            out = torch.zeros((len(eq), 2), dtype=torch.int32, device=cuda_device)
            loads = torch.zeros(2, dtype=torch.int64, device=cuda_device)
            tcuda.launch_probe(None, None, torch.from_numpy(_as_i32(eq)).to(cuda_device),
                               torch.from_numpy(ev).to(cuda_device), len(eq), 0, 1, 1, dev, out,
                               row_loads=loads[:1], lib=lib, vals_loads=loads[1:])
            assert np.array_equal(out.cpu().numpy(), flat[0]), shape
            assert loads.tolist() == list(flat[1:]), shape
