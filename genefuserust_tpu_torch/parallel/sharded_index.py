"""Contig-sharded k-mer index: panels across devices, or S tables on one.

Port of `genefuserust_tpu/parallel/sharded_index.py`. For panels bigger
than one device's memory, the index is partitioned by CONTIG (gene) into
shards; every shard sees the whole read batch. Exactness argument (the
JAX module's):

  - dupe/high classification is GLOBAL (done on the host before
    partitioning): high-level kmers are dropped everywhere (absence ==
    skip, identical voting/masking effect); a dupe list split across
    shards still votes the same multiset of shifted positions because a
    gplong's contig determines its owning shard — vote counts per gplong
    are complete on exactly one shard.
  - global top-2 = merge of per-shard top-2 candidates by the reference
    rule (count desc, ascending-i64 gplong): since every gplong is counted
    wholly on one shard, the union of shard-local top-2s contains the
    global top-2.
  - pass-2 per-position flags are computed per shard (only the owner of a
    candidate's contig can flag it) and merged with a max over the shards
    — exactly the reference's make_mask max semantics.

The packing (`shard_contigs`, `pack_index_sharded`, `_pack_entries`,
`stack_packs`) is the JAX module's on the port's native helpers and its
O(n) absent-key search; its tables equal the JAX ones array for array.

Where the JAX package runs one `shard_map` program over a mesh, the port
takes a list of torch devices, one per shard (`parallel/mesh.py`); each
shard's tables stay on its device and its kernels run there, a launch of
the vote and one of the flags for each device's shards, one device after
another. The small per-shard outputs come to the first device through
`.to()` (NCCL collectives wait for the multi-GPU slice):

  each device  probe (stride 2) of its shards, one vote_counts_shards
               launch over them (groups past FLAGS_GROUP_BYTES)
                                                      -> (S, B, 6) to device 0
  device 0     merge_top2 over the S shards' rows      -> gate and top two
  each device  probe (stride 1) of its shards, one shard_flags launch
               over them (groups past FLAGS_GROUP_BYTES) -> ORed flag words
  device 0     the other devices' words ORed in; mask_from_flags
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from .. import native
from ..config import KMER, PASS1_STEP
from ..ops import map_read as M
from ..ops.hashtable import DUPE, EMPTY, SLOTS, PackedIndex, _build
from ..ops.index import TorchIndex, _sentinel_keys, index_to_torch


def shard_contigs(indexer, n_shards: int) -> np.ndarray:
    """contig id -> shard, greedy balance by gene sequence length."""
    sizes = [(len(s), c) for c, s in enumerate(indexer.fusion_seq)]
    sizes.sort(reverse=True)
    load = np.zeros(n_shards, np.int64)
    owner = np.zeros(len(indexer.fusion_seq), np.int32)
    for sz, c in sizes:
        s = int(np.argmin(load))
        owner[c] = s
        load[s] += sz
    return owner


def pack_index_sharded(indexer, n_shards: int, build_form: bool = True):
    """-> (owner, [PackedIndex per shard] with a COMMON bucket count).

    Global classification first (thr from settings), then entries routed by
    contig owner; high kmers dropped entirely. `build_form=False` drops each
    pack's (nb, SLOTS, 3) build table (`table` None) once its device form
    is made: half a pack's bytes, which the engine does not read."""
    thr = indexer.settings.skip_key_dup_threshold
    counts = indexer.group_count
    owner = shard_contigs(indexer, n_shards)

    # expand kept (non-high) groups to entry rows with their group kmer
    keep_groups = counts <= thr
    grp_of_row = np.repeat(np.arange(len(counts)), counts)
    rows = np.nonzero(keep_groups[grp_of_row])[0]
    r_kmer = indexer.se_kmer[rows]
    r_contig = indexer.se_contig[rows]
    r_pos = indexer.se_pos[rows]
    r_shard = owner[r_contig]

    per_shard = []
    max_keys = 1
    for s in range(n_shards):
        sel = r_shard == s
        sk, sc, sp = r_kmer[sel], r_contig[sel], r_pos[sel]
        # group within shard (stable by kmer; insertion order preserved)
        srt = native.sort_entries_by_kmer(sk, sc, sp)
        if srt is not None:
            sk, sc, sp = srt
        else:
            order = np.argsort(sk, kind="stable")
            sk, sc, sp = sk[order], sc[order], sp[order]
        per_shard.append((sk, sc, sp))
        # count shard-local unique keys for sizing
        if len(sk):
            gs = native.group_starts(sk)
            nk = len(gs) if gs is not None else len(np.unique(sk))
        else:
            nk = 1
        max_keys = max(max_keys, nk)
    # the routed copies of the panel's entries are not needed past here;
    # at genome scale they take ~3x the bytes of the shards' own entries
    del grp_of_row, rows, r_kmer, r_contig, r_pos, r_shard, sel
    nb = 16
    while nb * 2 < max_keys:
        nb *= 2
    while True:
        # shard packs are independent; gf_pack_table releases the GIL
        with ThreadPoolExecutor(max_workers=min(4, max(1, n_shards))) as ex:
            packs = list(ex.map(lambda a: _pack_entries(*a, nb, thr, build_form), per_shard))
        if all(p is not None for p in packs):
            return owner, packs
        nb *= 2  # a shard overflowed: retry all at the common doubled size


def _packed(table, dupes, nb, shift, max_dupe, build_form: bool = True) -> PackedIndex:
    keys_tbl, sentinel = _sentinel_keys(table)
    return PackedIndex(table if build_form else None, dupes, nb, shift, max_dupe,
                       keys_tbl=keys_tbl,
                       vals_tbl=table[:, :, 1:].reshape(-1, 2).copy(), empty_key=sentinel)


def _pack_entries(sk, sc, sp, nb, thr, build_form: bool = True):
    """Pack grouped (sorted) entry arrays into a PackedIndex at exactly
    `nb` buckets; None on overflow (local dupe lists <= thr entries by
    construction of the global classification)."""
    shift = 32 - int(round(np.log2(nb)))
    if len(sk) == 0:
        table = np.zeros((nb, SLOTS, 3), np.int32)
        table[:, :, 1] = EMPTY
        return _packed(table, np.full((1, 1, 2), EMPTY, np.int32), nb, shift, 1, build_form)
    gstart = native.group_starts(sk)
    if gstart is None:
        first = np.concatenate([[True], sk[1:] != sk[:-1]])
        gstart = np.nonzero(first)[0]
    gcount = np.diff(np.append(gstart, len(sk)))
    uk = sk[gstart]
    is_reg = gcount == 1
    reg_i = np.nonzero(is_reg)[0]
    dup_i = np.nonzero(~is_reg)[0]
    keys = np.concatenate([uk[reg_i], uk[dup_i]]).astype(np.uint32)
    contigs = np.concatenate(
        [sc[gstart[reg_i]], np.full(len(dup_i), DUPE, np.int32)]
    ).astype(np.int32)
    poss = np.concatenate(
        [sp[gstart[reg_i]], np.arange(len(dup_i), dtype=np.int32)]
    ).astype(np.int32)
    max_dupe = int(gcount[dup_i].max()) if len(dup_i) else 1
    dupes = np.full((max(1, len(dup_i)), max_dupe, 2), EMPTY, np.int32)
    dupes[:, :, 1] = 0
    if len(dup_i):
        off = np.arange(max_dupe)[None, :]
        src = gstart[dup_i][:, None] + off
        valid = off < gcount[dup_i][:, None]
        srcc = np.clip(src, 0, len(sk) - 1)
        dupes[:, :, 0] = np.where(valid, sc[srcc], EMPTY)
        dupes[:, :, 1] = np.where(valid, sp[srcc], 0)
    table = native.pack_table(keys, contigs, poss, nb, shift, SLOTS, EMPTY)
    if table is None:
        table = _build(keys, contigs, poss, nb, shift)
    if table is None:
        return None
    return _packed(table, dupes, nb, shift, max_dupe, build_form)


def _common_dupes(packs: List[PackedIndex]):
    """Every pack's dupe table padded to the largest row count and width,
    EMPTY slots at pos 0 -> ([(nd, D, 2)], D)."""
    D = max(p.max_dupe for p in packs)
    nd = max(p.dupes.shape[0] for p in packs)
    out = []
    for p in packs:
        d = np.full((nd, D, 2), EMPTY, np.int32)
        d[..., 1] = 0
        d[: p.dupes.shape[0], : p.max_dupe] = p.dupes
        out.append(d)
    return out, D


def stack_packs(packs: List[PackedIndex]):
    """Pad per-shard packs to common shapes and stack on axis 0 (the shard
    axis). -> (keys (S,nb,SLOTS), vals (S,nb*SLOTS,2), dupes (S,nd,D,2),
    shift, max_dupe)."""
    nb = max(p.n_buckets for p in packs)
    for p in packs:
        assert p.n_buckets == nb, "pack_index_sharded uses a common nb"
    dupes, D = _common_dupes(packs)
    keys = np.stack([p.keys_tbl for p in packs]).astype(np.int32)
    vals = np.stack([p.vals_tbl for p in packs]).astype(np.int32)
    return keys, vals, np.stack(dupes), packs[0].shift, D


def shard_indexes(packs: List[PackedIndex], devices) -> List[TorchIndex]:
    """One split-layout TorchIndex per shard, on its device, every shard's
    dupe table at the common shape of `stack_packs` (the JAX engine's
    tables). `index_to_torch` of a pack alone keeps its own width: EMPTY
    padding slots vote and flag nothing, so both scan alike."""
    if len(devices) != len(packs):
        raise ValueError(f"{len(packs)} shard tables for {len(devices)} devices")
    dupes, D = _common_dupes(packs)
    return [index_to_torch(dataclasses.replace(p, dupes=d, max_dupe=D), dev)
            for p, d, dev in zip(packs, dupes, devices)]


def table_bytes(indexes: List[TorchIndex]) -> int:
    """Bytes of the shards' device tables (keys, vals, dupes)."""
    return sum(t.numel() * t.element_size() for ix in indexes
               for t in (ix.table, ix.vals, ix.dupes))


# The probe results of one device's shards that a shard_flags launch
# (stride 1) or a vote_counts_shards call (stride 2) takes at once, at
# most (bytes). A call's peak device memory grows by at most this over
# holding one shard's results at a time; a shard whose results pass it
# alone takes a launch of its own. At 8,192 rows of width 224 a shard's
# stride-1 results are 13.7 MB, so 4 shards take one launch.
FLAGS_GROUP_BYTES = 512 << 20


def flag_groups(n_shards: int, shard_bytes: int):
    """The shards of one device in groups, in order, each a shard_flags
    launch or a vote_counts_shards call: as many as fit in
    FLAGS_GROUP_BYTES of probe results (at least one, at most
    MAX_FLAG_SHARDS) -> [range of shard positions]."""
    per = max(1, min(M.MAX_FLAG_SHARDS, FLAGS_GROUP_BYTES // max(1, shard_bytes)))
    return [range(a, min(n_shards, a + per)) for a in range(0, n_shards, per)]


def device_flags(codes, lengths, gp, indexes: List[TorchIndex]):
    """Pass 2's flag words of shards that lie on one device (codes,
    lengths and gp on it too): each group of `flag_groups` probed (stride
    1) and flagged in one launch, the first group's launch storing the
    words and each later one ORing into them -> (B, nw, 2) int32."""
    B, L = codes.shape
    words = None
    for group in flag_groups(len(indexes), B * (L - KMER + 1) * 8):
        ixs = [indexes[s] for s in group]
        prs = [M.probe(codes, lengths, 1, ix) for ix in ixs]
        words = M.shard_flags(prs, lengths, gp, ixs, words)
        del prs
    return words


def sharded_map_read(codes, lengths, indexes: List[TorchIndex], major_req: int = 40,
                     minor_req: int = 20, mismatch_thr: int = 10) -> M.MapReadResult:
    """Both passes of map_read over shard tables -> the MapReadResult of
    the whole panel, on the first shard's device (the JAX package's
    `build_sharded_map_read`). codes (B, L) uint8 and lengths (B,) int32
    go to every shard's device; on the card `codes` must be a fresh tensor
    (the probe reads it in 16-byte chunks)."""
    if not indexes or len(indexes) > M.MAX_SHARDS:
        raise ValueError(f"sharded_map_read: 1 to {M.MAX_SHARDS} shards, got {len(indexes)}")
    dev0 = indexes[0].table.device
    devs = [ix.table.device for ix in indexes]
    inputs = {d: (codes.to(d), lengths.to(d)) for d in dict.fromkeys(devs)}
    B, L = codes.shape
    NK = L - KMER + 1
    votes = [None] * len(indexes)
    for d in inputs:
        mine = [s for s, e in enumerate(devs) if e == d]
        for group in flag_groups(len(mine), B * ((NK - 1) // PASS1_STEP + 1) * 8):
            pos = [mine[i] for i in group]
            ixs = [indexes[s] for s in pos]
            prs = [M.probe(*inputs[d], PASS1_STEP, ix) for ix in ixs]
            v = M.vote_counts_shards(prs, ixs, inputs[d][1]).to(dev0)
            del prs
            for s, row in zip(pos, v):
                votes[s] = row
    ok, gp = M.merge_top2(votes, major_req, minor_req)
    words = {}
    for d in inputs:
        mine = [ix for ix, e in zip(indexes, devs) if e == d]
        words[d] = device_flags(*inputs[d], gp.to(d), mine)
    merged = words[dev0]
    for d, w in words.items():
        if d != dev0:
            merged |= w.to(dev0)
    r = M.mask_from_flags(merged, inputs[dev0][1], gp, NK, mismatch_thr)
    return M.MapReadResult((r[:, 0:2] != 0) & ok[:, None], r[:, 2:4], r[:, 4:6], r[:, 6:8],
                           r[:, 8:10])
