"""Tables past 2^31 and 2^32 bytes, built on the card from a panel's table.

chip_smoke.py's phase 17 holds the probe, the vote, mask+segments and the
shard flags bit-equal to their plain versions where the rows they read lie
past the 2^31- and 2^32-byte marks, which a panel's own tables reach only
at genome scale (profiling/scale_proof.py). Packing such a table on the
host takes minutes; these helpers move a packed panel's entries into a
table of 2^log2_nb buckets on the tensor's own device in seconds:

  - `widen_kv`: a kv2 table (one [key | payload] row a bucket) of the same
    entries, each key in its h1 row, or in its h2 row where another key
    took h1 (the first in key order wins a row; a key that finds both
    rows taken is left out, so both versions miss it alike);
  - `widen_split`: a split table (8 key slots a bucket, a vals row a
    slot) of the same entries, the keys of odd value in their h2 bucket
    (so the probe's second load runs), and the dupe rows moved to start at
    row `dupe_base`, the entries' dupe row numbers with them.

The tables keep the panel's sentinel key in empty slots. Being the same
entries, a read probes the same hits; the row it reads is anywhere in the
table.
"""

from __future__ import annotations

import torch

from ..ops import map_read as tm
from ..ops.hashtable import DUPE, EMPTY
from ..ops.index import TorchIndex

SPLIT_SLOTS = 8


def kv2_entries(index: TorchIndex):
    """The occupied slots of a kv2 table -> (keys int64 uint32 values,
    payloads int32); an empty slot has payload 0."""
    if index.split or index.single_probe or index.S != 1:
        raise ValueError("kv2_entries takes a kv2 table")
    used = index.table[:, 1] != 0
    return index.table[used, 0].to(torch.int64) & tm.M32, index.table[used, 1]


def _first_in_group(b: torch.Tensor):
    """Of entries with buckets `b`: (the entries sorted by bucket, stably,
    each entry's rank among those of its bucket)."""
    order = torch.argsort(b, stable=True)
    sb = b[order]
    _, counts = torch.unique_consecutive(sb, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sb.shape[0], device=b.device) - torch.repeat_interleave(starts, counts)
    return order, rank


def widen_kv(index: TorchIndex, log2_nb: int) -> TorchIndex:
    """`index`'s kv2 entries in a kv2 table of 2^log2_nb rows -> (its
    TorchIndex, the dupe rows shared; the keys that found both their rows
    taken)."""
    keys, pay = kv2_entries(index)
    nb, shift = 1 << log2_nb, 32 - log2_nb
    dev = index.table.device
    table = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    table[:, 0] = index.empty_key
    table[:, 1] = 0
    b1, b2 = tm.buckets(keys, shift)
    order, rank = _first_in_group(b1)
    win = order[rank == 0]
    table[b1[win], 0] = tm._i32(keys[win])
    table[b1[win], 1] = pay[win]
    lose = order[rank > 0]
    lose = lose[table[b2[lose], 1] == 0]
    o2, r2 = _first_in_group(b2[lose])
    win2 = lose[o2[r2 == 0]]
    table[b2[win2], 0] = tm._i32(keys[win2])
    table[b2[win2], 1] = pay[win2]
    wide = TorchIndex(split=False, table=table, vals=index.vals, dupes=index.dupes, shift=shift,
                      max_dupe=index.max_dupe, cbits=index.cbits, pos_bias=index.pos_bias, S=1,
                      D=index.D, single_probe=False, empty_key=index.empty_key)
    return wide, int(keys.shape[0] - win.shape[0] - win2.shape[0])


def split_dupes(index: TorchIndex, dupe_base: int) -> torch.Tensor:
    """A kv index's (nd, 8) packed dupe rows as the split layout's (nd, D,
    2) [contig, pos] rows, EMPTY-padded, placed from row `dupe_base` of a
    table of dupe_base + nd rows whose other rows are empty."""
    nd, D = index.dupes.shape[0], index.D
    c, p = tm._decode(index.dupes[:, :D].to(torch.int64) & tm.M32, index.cbits, index.pos_bias)
    c = torch.where(c >= 0, c, EMPTY)
    p = torch.where(c >= 0, p, 0)
    out = torch.empty((dupe_base + nd, D, 2), dtype=torch.int32, device=index.dupes.device)
    out[..., 0] = EMPTY
    out[..., 1] = 0
    out[dupe_base:, :, 0] = c
    out[dupe_base:, :, 1] = p
    return out


def widen_split(index: TorchIndex, log2_nb: int, dupe_base: int = 0) -> TorchIndex:
    """`index`'s kv2 entries in a split table of 2^log2_nb buckets, the
    dupe rows from row `dupe_base` on -> (its TorchIndex, the keys past a
    bucket's 8 slots)."""
    keys, pay = kv2_entries(index)
    contig, pos = tm._decode(pay.to(torch.int64) & tm.M32, index.cbits, index.pos_bias)
    pos = torch.where(contig == DUPE, pos + dupe_base, pos)
    nb, shift = 1 << log2_nb, 32 - log2_nb
    dev = index.table.device
    b1, b2 = tm.buckets(keys, shift)
    b = torch.where(keys & 1 == 1, b2, b1)
    order, rank = _first_in_group(b)
    kept = order[rank < SPLIT_SLOTS]
    flat = b[kept] * SPLIT_SLOTS + rank[rank < SPLIT_SLOTS]
    keys_tbl = torch.full((nb, SPLIT_SLOTS), index.empty_key, dtype=torch.int32, device=dev)
    keys_tbl.view(-1)[flat] = tm._i32(keys[kept])
    vals = torch.empty((nb * SPLIT_SLOTS, 2), dtype=torch.int32, device=dev)
    vals[:, 0] = EMPTY
    vals[:, 1] = 0
    vals[flat, 0] = contig[kept]
    vals[flat, 1] = pos[kept]
    dupes = split_dupes(index, dupe_base)
    wide = TorchIndex(split=True, table=keys_tbl, vals=vals, dupes=dupes, shift=shift,
                      max_dupe=index.D, cbits=0, pos_bias=0, S=SPLIT_SLOTS, D=index.D,
                      single_probe=False)
    return wide, int(keys.shape[0] - kept.shape[0])


def rows_probed(index: TorchIndex, codes, lens, stride: int, indices: bool = False) -> dict:
    """The table rows a lookup of the batch's valid k-mers at `stride`
    reads (h1, and h2 where the key is not in h1) -> their count, the
    largest row's byte offset, the rows past 2^31 and 2^32 bytes and the
    hits; for the split layout also the vals rows of the hits. With
    `indices`, also those rows in query order ("row_index", "vals_index")."""
    km, ok = tm.compute_kmers(codes, lens)
    k = km[:, ::stride][ok[:, ::stride]]
    b1, b2 = tm.buckets(k, index.shift)
    ki = tm._i32(k)[:, None]
    m1 = index.table[b1][:, : index.S] == ki
    in_h1 = m1.any(1)
    rows = torch.stack([b1, torch.where(in_h1, -1, b2)], 1).reshape(-1)
    rows = rows[rows >= 0]
    rb = 4 * index.table.shape[1]
    off = rows * rb
    c, _ = tm.lookup(index, k, torch.ones_like(in_h1))
    out = dict(valid=int(k.shape[0]), hits=int((c != tm.EMPTY).sum()), rows=int(rows.shape[0]),
               row_bytes=rb, max_offset=int(off.max()), past_2_31=int((off >= 1 << 31).sum()),
               past_2_32=int((off >= 1 << 32).sum()))
    if indices:
        out["row_index"] = rows
    if index.split:
        m2 = index.table[b2][:, : index.S] == ki
        hit = in_h1 | m2.any(1)
        flat = torch.where(in_h1, b1 * index.S + m1.to(torch.uint8).argmax(1),
                           b2 * index.S + m2.to(torch.uint8).argmax(1))[hit]
        voff = flat * 8
        out.update(vals_rows=int(flat.shape[0]), vals_max_offset=int(voff.max()),
                   vals_past_2_32=int((voff >= 1 << 32).sum()))
        if indices:
            out["vals_index"] = flat
    return out


def dupe_rows_named(index: TorchIndex, pr: torch.Tensor) -> dict:
    """The dupe rows that probe results `pr` name -> their count, the
    largest row's byte offset and the rows past 2^31 bytes."""
    rows = pr[..., 1][pr[..., 0] == DUPE].to(torch.int64)
    rb = index.dupes[0].numel() * 4
    off = rows * rb
    return dict(dupe_samples=int(rows.shape[0]), dupe_row_bytes=rb,
                dupe_max_offset=int(off.max()) if rows.numel() else 0,
                dupe_past_2_31=int((off >= 1 << 31).sum()))
