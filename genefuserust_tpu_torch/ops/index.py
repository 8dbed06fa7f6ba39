"""Panel index tables as torch tensors.

The tables are built on the host with numpy (`build_packed_index`, on the
placement code of `ops/hashtable.py`); this module carries those arrays to
the device unchanged and records the static parameters the probe needs.
Three kinds of table reach the scan:

  - kv rows (`PackedIndexKV`): `kv_tbl (nb, 2S) int32`, S [key | payload]
    slots per bucket, each key in one of its two buckets — kv2 (S=1, the
    product layout), kv4 (S=2), kv8 (S=4). Dupe rows are 8 packed payloads.
  - single-probe rows (`PackedIndexKVS`, S=4; `PackedIndexKV16`, S=8): the
    same [key | payload] slots and dupe rows, each key in its h1 bucket
    unless that bucket overflowed; an overflowed row carries the marker
    payload OVF_PAYLOAD in its last slot, and only a query that misses
    such a row reads its h2 bucket. Selected by GENEFUSE_TABLE_LAYOUT=kvs
    or kv16, never by default.
  - split (`PackedIndex`): `keys_tbl (nb, 8)` + `vals_tbl (nb*8, 2)`,
    used when a panel exceeds the packed-payload bit budget. Dupe rows are
    `(D, 2)` [contig, pos] pairs.

`build_packed_index` mirrors the JAX package's dispatch and packers
(`genefuserust_tpu/ops/hashtable.py`) with the same numpy placement, so
its tables are bit-equal to theirs, but it finds the empty-slot sentinel
with `absent_key` (O(n), no sort) instead of the reference's `np.unique`
over every key, which dominated a kv2 pack on some numpy versions.
`index_to_torch` also takes the reference's own table records (it reads
their fields by name), which is how the tests carry them across.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from .. import native
from .hashtable import (
    EMPTY,
    KV16_SLOTS,
    KV_SLOTS,
    OVF_PAYLOAD,
    SLOTS,
    PackedIndex,
    PackedIndexKV,
    PackedIndexKV16,
    PackedIndexKVS,
    _build,
    _encode_payload,
    _entries_from_indexer,
    _kv_budget,
    _place_2choice,
    _place_single_hash,
)

log = logging.getLogger("genefuse")


def absent_key(present: np.ndarray) -> int:
    """Smallest uint32 not in `present` (read as uint32 bit patterns).

    n keys leave at least one of 0..n free, so only keys <= n are marked."""
    v = np.asarray(present).astype(np.int64).ravel() & 0xFFFFFFFF
    seen = np.zeros(len(v) + 1, bool)
    seen[v[v <= len(v)]] = True
    return int(np.argmin(seen))


def _sentinel_keys(table: np.ndarray):
    """(nb, S, 3) [key, contig, pos] slots -> (keys with the empty slots
    set to the absent key as int32, the absent key)."""
    empty = table[:, :, 1] == EMPTY
    keys = table[:, :, 0].copy()
    sentinel = absent_key(keys[~empty])
    keys[empty] = np.int32(sentinel - (1 << 32) if sentinel >= 1 << 31 else sentinel)
    return keys, sentinel


def _pack_kv(indexer, target_load: float = 0.9, slots: int = KV_SLOTS,
             max_buckets: int = 1 << 27):
    """The reference's `pack_index_kv` with `absent_key`: the kv rows, or
    None when the panel exceeds the payload bit budget or the row cap.
    Where the reference's rounding of the bucket count to an even power of
    two alone passes `max_buckets`, the layout is given up as there, and a
    warning names it."""
    keys, contigs, poss, dupes, max_dupe = _entries_from_indexer(indexer)
    budget = _kv_budget(contigs, poss, dupes, max_dupe)
    if budget is None:
        return None
    cbits, pbits, pos_bias = budget
    nb = 16
    while nb * slots * target_load < max(len(keys), 1):
        nb *= 2
    if (nb.bit_length() - 1) & 1:
        nb *= 2
        if nb // 2 <= max_buckets < nb:
            log.warning("kv%d table layout given up: %d buckets round up to %d, above "
                        "max_buckets %d", 2 * slots, nb // 2, nb, max_buckets)
    table = None
    while nb <= max_buckets:
        shift = 32 - int(round(np.log2(nb)))
        table = native.pack_table(keys, contigs, poss, nb, shift, slots, EMPTY)
        if table is None:
            placed = _place_2choice(keys, nb, shift, slots)
            if placed is not None:
                table = np.zeros((nb, slots, 3), np.int32)
                table[:, :, 1] = EMPTY
                pb, ps = placed
                table[pb, ps, 0] = keys.astype(np.int32)
                table[pb, ps, 1] = contigs
                table[pb, ps, 2] = poss
        if table is not None:
            break
        nb *= 2
    if table is None:
        return None
    tkeys, sentinel = _sentinel_keys(table)
    payload = _encode_payload(
        table[:, :, 1].ravel(), table[:, :, 2].ravel(), pbits, pos_bias
    ).reshape(nb, slots)
    kv_tbl = np.concatenate([tkeys, payload], axis=1).astype(np.int32)
    return PackedIndexKV(kv_tbl, _packed_dupes(dupes, pbits, pos_bias), nb, shift, cbits,
                         pos_bias, max_dupe, sentinel)


def _packed_dupes(dupes, pbits: int, pos_bias: int) -> np.ndarray:
    """(nd, D, 2) dupe lists -> the kv layouts' (max(1, n_dup), 8) rows of
    packed payloads."""
    n_dup = dupes.shape[0]
    dupes_packed = np.zeros((max(1, n_dup), 8), np.int32)
    if n_dup:
        D = dupes.shape[1]
        dupes_packed[:, :D] = _encode_payload(
            dupes[:, :, 0].ravel(), dupes[:, :, 1].ravel(), pbits, pos_bias
        ).reshape(n_dup, D)
    return dupes_packed


def _pack_single(indexer, slots: int, target_load: float, max_buckets: int):
    """The reference's `pack_index_kvs` (slots KV_SLOTS) and
    `pack_index_kv16` (KV16_SLOTS) with `absent_key`: the single-probe rows,
    or None when the panel exceeds the payload bit budget or placement
    cannot fit under `max_buckets` rows."""
    keys, contigs, poss, dupes, max_dupe = _entries_from_indexer(indexer)
    budget = _kv_budget(contigs, poss, dupes, max_dupe)
    if budget is None:
        return None
    cbits, pbits, pos_bias = budget
    nb = 16
    while nb * target_load < max(len(keys), 1):
        nb *= 2
    placed = None
    while nb <= max_buckets:
        shift = 32 - int(round(np.log2(nb)))
        placed = _place_single_hash(keys, nb, shift, slots)
        if placed is not None:
            break
        nb *= 2
    if placed is None:
        return None
    out_b, out_s, ovf = placed
    sentinel = absent_key(keys)
    s32 = np.int32(sentinel - (1 << 32) if sentinel >= 1 << 31 else sentinel)
    tkeys = np.full((nb, slots), s32, np.int32)
    payload = np.zeros((nb, slots), np.int32)
    payload[ovf, slots - 1] = OVF_PAYLOAD
    tkeys[out_b, out_s] = keys.astype(np.int32)
    payload[out_b, out_s] = _encode_payload(contigs, poss, pbits, pos_bias)
    kv_tbl = np.concatenate([tkeys, payload], axis=1).astype(np.int32)
    cls = PackedIndexKV16 if slots == KV16_SLOTS else PackedIndexKVS
    return cls(kv_tbl, _packed_dupes(dupes, pbits, pos_bias), nb, shift, cbits, pos_bias,
               max_dupe, sentinel)


def _pack_kvs(indexer, target_load: float = 1.0, max_buckets: int = 1 << 27):
    return _pack_single(indexer, KV_SLOTS, target_load, max_buckets)


def _pack_kv16(indexer, target_load: float = 4.0, max_buckets: int = 1 << 26):
    return _pack_single(indexer, KV16_SLOTS, target_load, max_buckets)


def _pack_split(indexer) -> PackedIndex:
    """The reference's `pack_index`, with its device form (keys_tbl,
    vals_tbl, the absent key) filled in here."""
    keys, contigs, poss, dupes, max_dupe = _entries_from_indexer(indexer)
    nb = 16
    while nb * 2 < max(len(keys), 1):
        nb *= 2
    while True:
        shift = 32 - int(round(np.log2(nb)))
        table = native.pack_table(keys, contigs, poss, nb, shift, SLOTS, EMPTY)
        if table is None:
            table = _build(keys, contigs, poss, nb, shift)
        if table is not None:
            break
        nb *= 2
    # the entries are in the table now; a genome-scale panel's take GBs
    del keys, contigs, poss
    keys_tbl, sentinel = _sentinel_keys(table)
    return PackedIndex(table, dupes, nb, shift, max_dupe, keys_tbl=keys_tbl,
                       vals_tbl=table[:, :, 1:].reshape(-1, 2).copy(),
                       empty_key=sentinel)


def layout_name(packed) -> str:
    """'kv2', 'kv4', 'kv8', 'kvs', 'kv16' or 'split': the layout of a packed
    table (a 16-wide row is kv16, the `single_probe` marker kvs)."""
    if not hasattr(packed, "kv_tbl"):
        return "split"
    if getattr(packed, "single_probe", False):
        return "kvs"
    return f"kv{packed.kv_tbl.shape[1]}"


def _layout_chain(layout: str):
    """The packers `layout` tries, in order -> [(name, pack(indexer))]."""
    chain = []
    if layout == "kv16":
        chain.append(("kv16", _pack_kv16))
    if layout == "kvs":
        chain.append(("kvs", _pack_kvs))
    if layout in ("auto", "kv2"):
        chain.append(("kv2", lambda ix: _pack_kv(ix, target_load=0.5, slots=1)))
    if layout in ("auto", "kv4", "kv2"):
        chain.append(("kv4", lambda ix: _pack_kv(ix, target_load=0.6, slots=2)))
    if layout in ("auto", "kv4", "kv2", "kv16", "kvs", "kv8"):
        chain.append(("kv8", _pack_kv))
    chain.append(("split", _pack_split))
    return chain


def _pick_layout(indexer, layout: str, attempts=None):
    for name, pack in _layout_chain(layout):
        t0 = time.perf_counter()
        p = pack(indexer)
        if attempts is not None:
            attempts.append(dict(layout=name, seconds=time.perf_counter() - t0,
                                 packed=p is not None))
        if p is not None:
            return p
    raise AssertionError("the split layout always packs")


def build_packed_index(indexer, layout: str = None, attempts: list = None):
    """The device table in the preferred layout, with the fallbacks of the
    reference's `build_packed_index`: kv2 -> kv4 -> kv8 -> split. `layout`
    or GENEFUSE_TABLE_LAYOUT ('kv2' | 'kv4' | 'kv8' | 'kvs' | 'kv16' |
    'split') pins one; a pinned layout that cannot be packed falls through
    as there (kvs and kv16 to kv8, then split). The layout built is
    logged. `attempts`: a list that each layout tried is appended to, as
    {layout, seconds, packed}."""
    layout = layout or os.environ.get("GENEFUSE_TABLE_LAYOUT", "auto")
    p = _pick_layout(indexer, layout, attempts)
    log.info("table layout %s built (asked: %s), %d buckets, %.1f MB", layout_name(p),
             layout, p.n_buckets, p.nbytes / 1e6)
    return p


@dataclasses.dataclass(frozen=True)
class TorchIndex:
    """Device tables plus the static parameters of one packed panel index.

    `D` is the candidate width after dupe expansion: 1 when the panel has
    no dupe table to expand (the JAX `max_dupe <= 1` branch), else
    `max_dupe` (kv) or the dupe row width (split)."""

    split: bool
    table: torch.Tensor  # kv: (nb, 2S) rows; split: (nb, 8) keys
    vals: torch.Tensor  # split: (nb*8, 2) [contig, pos]; kv: (0, 2)
    dupes: torch.Tensor  # kv: (nd, 8) payloads; split: (nd, D, 2)
    shift: int
    max_dupe: int
    cbits: int
    pos_bias: int
    S: int  # slots per table row
    D: int
    single_probe: bool  # kvs (S=4) or kv16 (S=8) rows: h2 only past a marked h1 row
    empty_key: int = 0  # single-probe rows: the absent-key sentinel as an int32 bit pattern


def index_to_torch(packed, device) -> TorchIndex:
    """A packed table (`PackedIndex`, `PackedIndexKV`, `PackedIndexKVS`,
    `PackedIndexKV16`, this package's or the reference's) -> `TorchIndex` on
    `device`. Rows 16 wide are kv16 and the `single_probe` marker names
    kvs, as the reference's engine reads them."""
    device = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    if hasattr(packed, "kv_tbl"):
        S = packed.kv_tbl.shape[1] // 2
        nd = packed.dupes.shape[0]
        D = 1 if packed.max_dupe <= 1 or nd == 0 else packed.max_dupe
        return TorchIndex(
            split=False, table=put(packed.kv_tbl),
            vals=torch.zeros((0, 2), dtype=torch.int32, device=device),
            dupes=put(packed.dupes), shift=packed.shift,
            max_dupe=packed.max_dupe, cbits=packed.cbits,
            pos_bias=packed.pos_bias, S=S, D=D,
            single_probe=layout_name(packed) in ("kvs", "kv16"),
            empty_key=int(np.uint32(int(packed.empty_key) & 0xFFFFFFFF).view(np.int32)),
        )
    nd = packed.dupes.shape[0]
    D = 1 if packed.max_dupe <= 1 or nd == 0 else packed.dupes.shape[1]
    return TorchIndex(
        split=True, table=put(packed.keys_tbl), vals=put(packed.vals_tbl),
        dupes=put(packed.dupes), shift=packed.shift, max_dupe=packed.max_dupe,
        cbits=0, pos_bias=0, S=packed.keys_tbl.shape[1], D=D, single_probe=False,
    )
