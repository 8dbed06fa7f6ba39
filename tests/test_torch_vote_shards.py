"""The counts-mode vote of a device's shards in one launch
(`ops/map_read.py::vote_counts_shards`, `csrc/vote.cu` vote_shards_kernel
and vote_shards_wide_kernel). Its Python mirror, `_kernel_vote_shards`,
follows the kernels step for step: the (shard, row) grid with the warp
path and the block path, the one wide list of s * B + b entries for all
the shards of a launch, the global pass with the keys past shared memory
read once for the call, and launches of at most 8 shards. The mirror and
the wrapper (its plain version here) are held to the JAX package's
per-shard `top2_votes` (`genefuserust_tpu/parallel/sharded_index.py`
per_shard) and, merged, to its `_merge_top2`, exactly: at 1, 2, 3, 4, 8
and 9 shards, on split shard tables of several dupe widths and on the kv2
tables of two panels, on rows of 0 and 1-17 bases, 150-base rows, a 1,100-base row past
the warp path, 4,200- and 70,000-base rows on the wide route (shared
memory and global scratch), and a shard without any valid candidate. The
`cuda` test holds the kernels to the plain version on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from genefuserust_tpu_torch.config import PASS1_STEP
from genefuserust_tpu_torch.ops import cuda
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.hashtable import EMPTY
from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
from genefuserust_tpu_torch.parallel import sharded_index as tsi
from test_torch_long_reads import _long_batch, panel_ix, panel_reads  # noqa: F401
from test_torch_map_read import (
    VOTE_WALK_MAX,
    _kernel_vote,
    _row_samples,
    _vote_row,
    _wide_block_vote,
    _wide_row_keys,
)
from test_torch_sharded_index import (  # noqa: F401
    MAX_SHARDS,
    _batch,
    _check_merge,
    _edge_reads,
    panels,
)

CPU = torch.device("cpu")
VOTE_WARPS = 8  # rows a block of vote_shards_kernel (a row a warp)
# a cap that sends the 70,000-base row's 2,267 keys to global scratch
VOTE_CAP = 8 << 10


def _kernel_vote_shards(prs, indexes, lengths=None, smem_cap=None):
    """vote_counts_shards on the card, step for step -> ((S, B, 6) int32
    rows, what it did: launches of each kernel, device reads, each row's
    route). Launches of at most MAX_SHARDS shards; in a launch, block
    (x, y) takes rows VOTE_WARPS x .. + VOTE_WARPS - 1 of the launch's
    shard y, a warp a row. Narrow route (every shard's vote_width within
    MAX_VOTE_KEYS): a row of at most 256 valid keys among its samples
    inside its length is voted by its warp, any other by the block over
    all its samples (the probe made the rest misses). Wide route: a row of
    more than VOTE_WALK_MAX samples, or of more than 256 keys, goes to the
    launch's one list as y * B + b; one wide launch votes each entry with
    its keys in shared memory, or lists it again with its offset in the
    scratch past `smem_cap` // 8 keys; then one read of every launch's
    count of those keys, and a global pass for each launch that has any."""
    S = len(prs)
    B, NS = prs[0].shape[:2]
    keys_cap = (tm.WIDE_SMEM_BYTES if smem_cap is None else smem_cap) // 8
    wide = max(tm.vote_width(NS, ix.D) for ix in indexes) > tm.MAX_VOTE_KEYS
    out = np.zeros((S, B, 6), np.int64)
    did = dict(vote_counts=0, vote_counts_wide=0, vote_counts_wide_global=0, reads=0, routes={})

    def samples(b):
        return NS if lengths is None else _row_samples(int(lengths[b]), NS)

    def block(s, b, keys):
        P = NS * indexes[s].D
        return _vote_row(*_wide_block_vote(keys, P), PASS1_STEP, 0, 0, True)

    overs = []
    for a in range(0, S, MAX_SHARDS):
        group = range(a, min(S, a + MAX_SHARDS))
        did["vote_counts"] += 1
        listed = []
        for blk in range(-(-B // VOTE_WARPS)):
            for y, s in enumerate(group):  # blockIdx.y
                pr, ix = prs[s], indexes[s]
                for b in range(blk * VOTE_WARPS, min(B, (blk + 1) * VOTE_WARPS)):
                    ns = samples(b)
                    keys = [] if wide and ns > VOTE_WALK_MAX else _wide_row_keys(pr[b], ns, ix)
                    if (wide and ns > VOTE_WALK_MAX) or len(keys) > tm.VOTE_WARP_KEYS:
                        if wide:
                            listed.append(y * B + b)
                            continue
                        keys = _wide_row_keys(pr[b], NS, ix)  # block_vote: all NS samples
                        did["routes"][s, b] = "block"
                    else:
                        did["routes"][s, b] = "warp"
                    out[s, b] = _kernel_vote(keys, NS * ix.D, PASS1_STEP, counts=True)
        if not wide:
            continue
        did["vote_counts_wide"] += 1
        again, total = [], 0
        for e in sorted(listed):  # the list's order is the atomics'; no row reads another
            s, b = a + e // B, e % B
            keys = _wide_row_keys(prs[s][b], samples(b), indexes[s])
            if len(keys) > keys_cap:
                again.append((e, total, keys))
                total += len(keys)
                continue
            did["routes"][s, b] = "shared"
            out[s, b] = block(s, b, keys)
        overs.append((a, again, total))
    if wide and NS * max(ix.D for ix in indexes) > keys_cap:
        did["reads"] += 1
        for a, again, total in overs:
            if not total:
                continue
            did["vote_counts_wide_global"] += 1
            scratch = [None] * total
            for e, off, keys in again:
                s, b = a + e // B, e % B
                assert all(k is None for k in scratch[off : off + len(keys)])
                scratch[off : off + len(keys)] = keys
                did["routes"][s, b] = "global"
                out[s, b] = block(s, b, scratch[off : off + len(keys)])
    return torch.from_numpy(out.astype(np.int32)), did


def _jax_top2(pr, index):
    """JAX per_shard's vote of one shard: expand_candidates(_kv), (contig,
    pos - 2s), top2_votes -> (B, 6) int32 [c1, h1, l1, c2, h2, l2]."""
    import jax.numpy as jnp

    from genefuserust_tpu.ops import map_read as jm

    c, p = jnp.asarray(pr[..., 0].numpy()), jnp.asarray(pr[..., 1].numpy())
    d = jnp.asarray(index.dupes.numpy())
    if index.split:
        cc, cp, cv = jm.expand_candidates(c, p, d, index.max_dupe)
    else:
        cc, cp, cv = jm.expand_candidates_kv(c, p, d, index.max_dupe, index.cbits,
                                             index.pos_bias)
    B, NS, D = cc.shape
    i = jnp.arange(NS, dtype=jnp.int32)[None, :, None] * PASS1_STEP
    h1, l1, c1, h2, l2, c2 = jm.top2_votes(cc.reshape(B, -1), (cp - i).reshape(B, -1),
                                           cv.reshape(B, -1))
    return torch.from_numpy(np.stack([np.asarray(x).astype(np.int32)
                                      for x in (c1, h1, l1, c2, h2, l2)], 1))


def _check(prs, indexes, lengths, caps=(None,)):
    """The mirror at each shared-memory cap and vote_counts_shards (with
    and without lengths) against JAX's per-shard votes; the merged rows
    against JAX's _merge_top2 (up to MAX_SHARDS shards, as a sharded
    map_read has) -> the mirror's records, one a cap."""
    exp = torch.stack([_jax_top2(pr, ix) for pr, ix in zip(prs, indexes)])
    assert torch.equal(tm.vote_counts_shards(prs, indexes, lengths, caps[-1]), exp)
    assert torch.equal(tm.vote_counts_shards(prs, indexes), exp)
    _check_merge(list(exp[:MAX_SHARDS]))
    dids = []
    for cap in caps:
        got, did = _kernel_vote_shards(prs, indexes, lengths, cap)
        assert torch.equal(got, exp), np.nonzero((got != exp).any(-1).numpy())
        assert did["vote_counts"] == -(-len(prs) // MAX_SHARDS)
        dids.append(did)
    return dids


def _edge_batch(panel):
    """_edge_reads (rows of 0 and 1-17 bases, chunk edges, 150-160-base
    reads, a 1,100-base row) as codes and lengths at their padded width."""
    reads = _edge_reads(panel)
    L = -(-max(map(len, reads)) // 32) * 32
    return (torch.from_numpy(a) for a in _batch(reads, L))


def _shard_tables(panels, layout, S):
    """S shard tables: split, the 'six' panel's sharded pack, each shard at
    its own dupe width (one launch takes shards of several widths); kv2,
    the 'six' and 'two' panels' tables in turn (on the 'two' table the
    'six' reads mostly miss)."""
    if layout == "split":
        _, packs = tsi.pack_index_sharded(panels["six"][1], S)
        return [index_to_torch(p, CPU) for p in packs]
    kv = [index_to_torch(build_packed_index(panels[n][1], "kv2"), CPU) for n in ("six", "two")]
    return [kv[s % 2] for s in range(S)]


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("layout", ["split", "kv2"])
def test_vote_shards_mirror_matches_jax_on_edge_rows(panels, layout, S):
    """The narrow route: every row voted by its warp, the 1,100-base row by
    the block; 9 shards take two launches. On 8 or 9 split shards of the
    six-gene panel some shards own no contig: their rows hold no valid
    candidate."""
    codes, lens = _edge_batch(panels["six"][0])
    indexes = _shard_tables(panels, layout, S)
    prs = [tm.probe(codes, lens, PASS1_STEP, ix) for ix in indexes]
    assert max(tm.vote_width(prs[0].shape[1], ix.D) for ix in indexes) <= tm.MAX_VOTE_KEYS
    did, = _check(prs, indexes, lens)
    routes = set(did["routes"].values())
    assert routes == {"warp", "block"} and did["vote_counts_wide"] == 0
    empty = [s for s, pr in enumerate(prs) if not (pr[..., 0] >= -1).any()]
    assert (S >= 8) == bool(empty) if layout == "split" else not empty
    if layout == "split" and S >= 3:
        assert len({ix.D for ix in indexes}) > 1


@pytest.fixture(scope="module")
def long_shards(panel_reads, panel_ix):
    """Per layout: the 150-, 4,200- and 70,000-base batch (_long_batch) and
    its table."""
    panel, reads = panel_reads
    return {layout: _long_batch(panel, reads, panel_ix, layout) for layout in ("kv2", "split")}


def _thinned(pr, s):
    """Shard s's results: the batch's with every (s + 1)-th sample a miss
    from shard 1 on (the shards' votes differ; the rows keep the batch's
    lengths), and shard 2's all misses (no valid candidate)."""
    if s == 2:
        return torch.full_like(pr, EMPTY)
    out = pr.clone()
    if s:
        out[:, :: s + 1] = torch.tensor([EMPTY, 0], dtype=torch.int32)
    return out


@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("layout", ["split", "kv2"])
def test_vote_shards_mirror_matches_jax_on_the_wide_route(long_shards, layout, S):
    """The wide route (70,016-wide rows): the 150-base rows by their warps,
    the 4,200-base rows (past VOTE_WALK_MAX samples) and the 70,000-base
    rows from the one list with their keys in shared memory, and with a
    small cap the 70,000-base rows in global scratch, one read a call."""
    codes, lens, _, index = long_shards[layout]
    pr = tm.probe(codes, lens, PASS1_STEP, index)
    prs = [_thinned(pr, s) for s in range(S)]
    indexes = [index] * S
    assert tm.vote_width(pr.shape[1], index.D) > tm.MAX_VOTE_KEYS
    for cap, did in zip((None, VOTE_CAP), _check(prs, indexes, lens, (None, VOTE_CAP))):
        routes = did["routes"]
        assert all(routes[s, 0] == "warp" for s in range(S))
        long_rows = {routes[s, b] for s in range(S) for b in (1, 2) if s != 2}
        assert long_rows <= {"shared", "global"} and ("global" in long_rows) == bool(cap)
        assert routes[0, 2] == ("global" if cap else "shared")
        assert did["reads"] == 1 and did["vote_counts_wide"] == -(-S // MAX_SHARDS)
        assert did["vote_counts_wide_global"] == (did["vote_counts_wide"] if cap else 0)


def test_vote_counts_shards_refuses_what_the_kernel_does_not_take(panels):
    codes, lens = _edge_batch(panels["six"][0])
    split = _shard_tables(panels, "split", 2)
    kv = _shard_tables(panels, "kv2", 2)
    prs = [tm.probe(codes, lens, PASS1_STEP, ix) for ix in split]
    with pytest.raises(ValueError):
        tm.vote_counts_shards(prs, split[:1])
    with pytest.raises(ValueError):
        tm.vote_counts_shards([prs[0], prs[1][:, :-1].contiguous()], split)
    with pytest.raises(ValueError):
        tm.vote_counts_shards(prs, [split[0], kv[1]])
    with pytest.raises(ValueError):
        tm.vote_counts_shards(prs, split, lens[:-1])
    with pytest.raises(ValueError):
        tm.vote_counts_shards([], [])


# ---------------- the kernels on the card ----------------


def _on_card(index, dev):
    """A CPU TorchIndex's tables on `dev`."""
    return dataclasses.replace(index, table=index.table.to(dev), vals=index.vals.to(dev),
                               dupes=index.dupes.to(dev))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "kv2"])
def test_vote_shards_kernels_match_plain(panels, long_shards, layout, cuda_device):
    """Both routes on the card at 1, 3, 4 and 9 shards (default cap and the
    global route), bit-equal to the stack of vote_counts_plain, one
    vote_counts launch for up to 8 shards; then sharded_map_read on 3
    shards of the card against the CPU's."""
    codes, lens = _edge_batch(panels["six"][0])
    for S in (1, 3, 4, 9):
        indexes = _shard_tables(panels, layout, S)
        prs = [tm.probe(codes, lens, PASS1_STEP, ix) for ix in indexes]
        exp = torch.stack([tm.vote_counts_plain(pr, ix) for pr, ix in zip(prs, indexes)])
        dix = [_on_card(ix, cuda_device) for ix in indexes]
        dprs = [pr.to(cuda_device) for pr in prs]
        for lengths in (lens.to(cuda_device), None):
            cuda.reset_launches()
            got = tm.vote_counts_shards(dprs, dix, lengths)
            assert cuda.LAUNCHES["vote_counts"] == -(-S // MAX_SHARDS)
            assert torch.equal(got.cpu(), exp)
    lcodes, llens, _, index = long_shards[layout]
    pr = tm.probe(lcodes, llens, PASS1_STEP, index)
    prs = [_thinned(pr, s) for s in range(9)]
    exp = torch.stack([tm.vote_counts_plain(p, index) for p in prs])
    dix = _on_card(index, cuda_device)
    dprs = [p.to(cuda_device) for p in prs]
    for S in (1, 3, 9):
        for cap in (None, VOTE_CAP):
            cuda.reset_launches()
            got = tm.vote_counts_shards(dprs[:S], [dix] * S, llens.to(cuda_device), cap)
            assert torch.equal(got.cpu(), exp[:S])
            assert cuda.LAUNCHES["vote_counts_wide"] == -(-S // MAX_SHARDS)
            assert cuda.LAUNCHES["vote_counts_wide_global"] == (
                cuda.LAUNCHES["vote_counts_wide"] if cap else 0)
    _, packs = tsi.pack_index_sharded(panels["six"][1], 3)
    r_cpu = tsi.sharded_map_read(codes, lens, tsi.shard_indexes(packs, [CPU] * 3))
    cuda.reset_launches()
    r = tsi.sharded_map_read(codes.to(cuda_device), lens.to(cuda_device),
                             tsi.shard_indexes(packs, [cuda_device] * 3))
    assert cuda.LAUNCHES["vote_counts"] == 1 == cuda.LAUNCHES["merge_top2"]
    for g, e in zip(r, r_cpu):
        assert torch.equal(g.cpu(), e)
