"""Host-built k-mer hash tables (vectorized numpy), immutable.

The part of `genefuserust_tpu/ops/hashtable.py` that the port's table
builder (`ops/index.py`) uses, copied so that the port stands alone: the
entry extraction from an indexer, the payload encoding and its bit budget,
the 2-choice placement, the single-hash placement with h2 spill of the
single-probe layouts (kvs, kv16), and the four table records. The numpy
lookups `lookup_np*` are test oracles of the reference and stay there.

Each k-mer lives in bucket h1 or (on overflow) h2. Slot layout of the
split build form (int32 x 3): [key, contig, pos]
  contig >= 0 : regular entry, (contig, pos) is the GenePos
  contig = -1 : dupe entry, pos = row index into the dupe table
  contig = -2 : high-level dupe (skipped in both passes)
  contig = -3 : empty slot
Dupe table (int32 [n_dupe_rows, D, 2]): rows padded with contig -3.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

EMPTY = -3
DUPE = -1
HIGH = -2

SLOTS = 8

_H1_MUL = np.uint32(0x9E3779B1)
_H2_MUL = np.uint32(0x85EBCA6B)
_H2_ADD = np.uint32(0xC2B2AE35)


def h1_np(kmers: np.ndarray, shift: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return ((kmers.astype(np.uint32) * _H1_MUL) >> np.uint32(shift)).astype(
            np.int64
        )


def h2_np(kmers: np.ndarray, shift: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        k = kmers.astype(np.uint32)
        return (
            ((k ^ (k >> np.uint32(15))) * _H2_MUL + _H2_ADD) >> np.uint32(shift)
        ).astype(np.int64)


@dataclasses.dataclass
class PackedIndex:
    """Split layout. The port's builder fills the device form itself
    (`ops/index.py::_pack_split`), so no field is derived here."""

    table: np.ndarray  # (n_buckets, SLOTS, 3) int32 (combined; build form)
    dupes: np.ndarray  # (n_dupe_rows, D, 2) int32
    n_buckets: int
    shift: int  # 32 - log2(n_buckets)
    max_dupe: int  # D
    # device lookup form: keys separated from values so the probe only
    # reads 4-byte keys; empty slots hold a key value NOT present in the
    # panel (false "found" then resolves to an EMPTY value -> no candidates)
    keys_tbl: np.ndarray  # (n_buckets, SLOTS) int32
    vals_tbl: np.ndarray  # (n_buckets*SLOTS, 2) int32
    empty_key: int

    @property
    def nbytes(self) -> int:
        return self.keys_tbl.nbytes + self.vals_tbl.nbytes + self.dupes.nbytes


KV_SLOTS = 4  # slots per bucket in the combined key+value row layout


@dataclasses.dataclass
class PackedIndexKV:
    """Combined key+value table: one 8xint32 row per bucket holds 4 slots
    of [key | packed payload], so a lookup is TWO row gathers total (both
    candidate buckets) instead of the split layout's three (2 key probes +
    value fetch). Payload encoding (uint32):

        tag  = payload >> pbits      (cbits wide)
        val  = payload & (2^pbits-1)

        tag 0        : empty slot / invalid
        tag 1        : HIGH dupe (skipped by both passes)
        tag 2        : dupe — val = row index into `dupes`
        tag c+3      : regular — contig c, position = val + pos_bias

    `dupes` rows are 8 packed regular-coded payloads (max dupe level is 5
    per the reference's skip_key_dup_threshold). Falls back to the split
    PackedIndex when a panel's geometry exceeds the payload bit budget
    (see `ops/index.py::_pack_kv`)."""

    kv_tbl: np.ndarray  # (nb, 8) int32: [k0..k3, e0..e3]
    dupes: np.ndarray  # (nd, 8) int32 packed payloads
    n_buckets: int
    shift: int
    cbits: int
    pos_bias: int
    max_dupe: int
    empty_key: int

    @property
    def nbytes(self) -> int:
        return self.kv_tbl.nbytes + self.dupes.nbytes


KV16_SLOTS = 8  # slots per bucket in the single-gather row layout
OVF_PAYLOAD = 1  # tag 0, val 1 in payload slot 7 marks an overflowed bucket


@dataclasses.dataclass
class PackedIndexKV16:
    """Single-gather table: one 16xint32 row per bucket holds 8 slots of
    [key | packed payload] (same payload encoding as PackedIndexKV), and
    each key lives in its h1 bucket — a lookup is ONE random row gather.

    Buckets whose h1 population exceeds 8 keys keep 7 inline, carry the
    overflow marker (key slot 7 = the absent-key sentinel with payload
    OVF_PAYLOAD), and spill the rest into free slots of their h2 buckets;
    only queries that MISS a marked row take a second row load (the
    probe's single-probe variant, `csrc/probe.cu`, loads no other). Key
    equality implies hash equality, so a probe can never produce a false
    match.

    Falls back to PackedIndexKV when spill placement fails repeatedly or
    the payload bit budget is exceeded (see `ops/index.py::_pack_kv16`).

    STATUS in the reference: the JAX package measured it slower than its
    2-gather kv8 table end to end on a TPU v5e, where a row's bytes set
    the cost of a gather; the port's own measurements on the H100 are in
    PERF.md. Not the default."""

    kv_tbl: np.ndarray  # (nb, 16) int32: [k0..k7 | p0..p7]
    dupes: np.ndarray  # (nd, 8) int32 packed payloads
    n_buckets: int
    shift: int
    cbits: int
    pos_bias: int
    max_dupe: int
    empty_key: int

    @property
    def nbytes(self) -> int:
        return self.kv_tbl.nbytes + self.dupes.nbytes


@dataclasses.dataclass
class PackedIndexKVS:
    """Single-probe variant of PackedIndexKV: SAME 8xint32 rows of 4
    [key | payload] slots (32B), but keys are placed single-hash (h1) so
    the hot path is ONE random row load. Buckets whose h1 population
    exceeds 4 keys keep 3 inline, carry the overflow marker (key slot 3 =
    absent-key sentinel, payload OVF_PAYLOAD), and spill the rest to free
    slots of their h2 buckets (with one eviction rescue level: an inline
    key of the flagged bucket may move to ITS h2 to make room). Only
    queries that MISS a marked row take a second row load. Key equality
    implies hash equality, so a probe can never produce a false match.

    ~1.004 random row loads a query at target_load 1.0 (flagged-bucket
    rate P[Poisson(1) > 4] ~ 0.4%). STATUS in the reference: the JAX
    package measured it behind its 2-gather kv4 table end to end on a
    TPU v5e; the port's own measurements on the H100 are in PERF.md. Not
    the default."""

    kv_tbl: np.ndarray  # (nb, 8) int32: [k0..k3 | p0..p3]
    dupes: np.ndarray  # (nd, 8) int32 packed payloads
    n_buckets: int
    shift: int
    cbits: int
    pos_bias: int
    max_dupe: int
    empty_key: int

    single_probe = True  # the marker `ops/index.py::index_to_torch` reads

    @property
    def nbytes(self) -> int:
        return self.kv_tbl.nbytes + self.dupes.nbytes


def _encode_payload(contigs, poss, pbits: int, pos_bias: int) -> np.ndarray:
    """(contig, pos) int32 arrays -> packed uint32 payload (as int32 bit
    pattern). contig sentinels: EMPTY->tag 0, HIGH->1, DUPE->2 (val=pos=
    dupe row), else tag contig+3 (val=pos-pos_bias)."""
    tag = np.where(
        contigs == EMPTY,
        0,
        np.where(contigs == HIGH, 1, np.where(contigs == DUPE, 2, contigs + 3)),
    ).astype(np.uint32)
    val = np.where(
        contigs >= 0, poss - pos_bias, np.where(contigs == DUPE, poss, 0)
    ).astype(np.uint32) & np.uint32((1 << pbits) - 1)
    return ((tag << np.uint32(pbits)) | val).astype(np.uint32).view(np.int32)


def _kv_budget(contigs, poss, dupes, max_dupe):
    """Packed-payload bit budget shared by the KV layouts: -> (cbits,
    pbits, pos_bias), or None when the panel geometry exceeds it (too many
    contigs / too wide a position span / dupe lists longer than a row).

    The bucketing below served the JAX package's compiles; it is kept so
    that the port's tables stay bit-equal to the reference's."""
    n_contigs = int(contigs.max()) + 1 if len(contigs) else 0
    cbits = max(4, int(n_contigs + 3).bit_length())
    # Round cbits up to even: cbits/pos_bias are STATIC jit args, so
    # per-panel drift in either recompiles every scan variant (see the
    # multi-CSV compile note in _entries_from_indexer). Bucketing costs
    # at most one position bit and collapses near-identical panels onto
    # one signature.
    cbits += cbits & 1
    pbits = 32 - cbits
    n_dup = dupes.shape[0]
    reg = contigs >= 0
    all_pos = [poss[reg]]
    dvalid = dupes[:, :, 0] != EMPTY
    if dvalid.any():
        all_pos.append(dupes[:, :, 1][dvalid])
    pos_cat = np.concatenate(all_pos) if len(all_pos[0]) or len(all_pos) > 1 else np.zeros(1, np.int32)
    pos_bias = int(pos_cat.min()) if pos_cat.size else 0
    # Bias bucketing (pos_bias is a STATIC jit arg): the minimum position
    # is -(longest gene) — panels split from one CSV differ in their
    # longest gene, so a fine grid still split 16 sub-panels over three
    # bias values (round 5, 810 s of multi-CSV recompiles). Negative
    # biases round DOWN to a power of two with a -2^20 floor (genes up to
    # 1 Mbp all share one value; the wasted span is noise vs the 2^pbits
    # budget); positive biases keep the 2^18 grid.
    if pos_bias < 0:
        pos_bias = -(1 << max(20, (-pos_bias - 1).bit_length()))
    else:
        pos_bias = (pos_bias >> 18) << 18
    span = int(pos_cat.max()) - pos_bias if pos_cat.size else 0
    if span >= (1 << pbits) or n_dup >= (1 << pbits) or max_dupe > 8:
        # diagnosability (advisor round 4): the even-cbits rounding plus
        # the 2^18 pos_bias flooring cost up to 1 bit + 262143 of span —
        # a panel that only fits under the PRE-bucketing budget silently
        # falls back to the ~3-gather split layout otherwise
        raw_cbits = max(4, int(n_contigs + 3).bit_length())
        raw_pbits = 32 - raw_cbits
        raw_span = (
            int(pos_cat.max()) - int(pos_cat.min()) if pos_cat.size else 0
        )
        if (
            max_dupe <= 8
            and raw_span < (1 << raw_pbits)
            and n_dup < (1 << raw_pbits)
            and (span >= (1 << pbits) or n_dup >= (1 << pbits))
        ):
            logging.getLogger("genefuse").warning(
                "packed KV budget: panel fits the raw payload budget "
                "(cbits=%d span=%d) but not the shape-bucketed one "
                "(cbits=%d span=%d) - falling back to the split layout; "
                "expect slower scans on this panel",
                raw_cbits, raw_span, cbits, span,
            )
        return None
    return cbits, pbits, pos_bias


def _entries_from_indexer(indexer):
    """Indexer grouped arrays -> (keys u32, contigs i32, poss i32,
    dupes (nd, D, 2) i32, max_dupe). One entry per unique k-mer; dupe
    entries point at their dupe-table row; high dupes carry the HIGH
    sentinel (indexer.rs:179-241 semantics)."""
    thr = indexer.settings.skip_key_dup_threshold
    counts = indexer.group_count
    starts = indexer.group_start
    uk = indexer.uniq_keys
    se_c = indexer.se_contig
    se_p = indexer.se_pos

    is_reg = counts == 1
    is_dup = (counts > 1) & (counts <= thr)
    is_high = counts > thr

    reg_i = np.nonzero(is_reg)[0]
    dup_i = np.nonzero(is_dup)[0]
    high_i = np.nonzero(is_high)[0]
    n_reg, n_dup, n_high = len(reg_i), len(dup_i), len(high_i)

    keys = np.concatenate([uk[reg_i], uk[dup_i], uk[high_i]]).astype(np.uint32)
    contigs = np.concatenate(
        [
            se_c[starts[reg_i]],
            np.full(n_dup, DUPE, np.int32),
            np.full(n_high, HIGH, np.int32),
        ]
    )
    poss = np.concatenate(
        [
            se_p[starts[reg_i]],
            np.arange(n_dup, dtype=np.int32),
            np.zeros(n_high, np.int32),
        ]
    )

    max_dupe = int(counts[dup_i].max()) if n_dup else 1
    # Shape normalization (multi-CSV compile sharing): max_dupe is a
    # STATIC jit arg and the dupe-table row count is a traced SHAPE, so
    # any per-panel difference in either recompiles every scan variant —
    # measured 1564s of warmup for 16 equal panel splits (PERF.md round
    # 4). Bucket both: max_dupe is floored at min(8, pow2(threshold)) so
    # it is data-independent (dupe rows are stored 8-wide regardless);
    # padded columns carry the EMPTY fill the expansion already skips,
    # padded rows are never referenced (dupe row indices in table
    # payloads stay < n_dup). Data wider than 8 still propagates so the
    # KV budget check rejects it exactly as before.
    max_dupe = 1 << (max_dupe - 1).bit_length()
    # The floor applies to dupe-FREE panels too: gating it on n_dup>0 was
    # tried (advisor round 4) and breaks compile sharing whenever one
    # panel split has dupes and its siblings do not (the exact multi-CSV
    # case the normalization exists for). The cost on the default bench
    # panel is nil — its true max dupe count (5) already rounds to 8 —
    # and BENCH_r05 records the re-measurement on normalized shapes.
    max_dupe = max(max_dupe, min(8, 1 << (int(thr) - 1).bit_length()))
    # dupe-row count is a traced SHAPE: floor 4096 + even pow2 exponent —
    # real panel splits spread n_dup across 128..2048 (round 5: part of 8
    # distinct table signatures = 810 s of multi-CSV warmup); at the usual
    # max_dupe of 8 the floor's 4096 rows of (contig, pos) pairs are
    # 256 KB, held only by the split layout (the kv packers keep n_dup rows)
    nd_rows = max(4096, 1 << (max(1, n_dup) - 1).bit_length())
    if (nd_rows.bit_length() - 1) & 1:
        nd_rows *= 2
    dupes = np.full((nd_rows, max_dupe, 2), EMPTY, np.int32)
    dupes[:, :, 1] = 0
    if n_dup:
        d_off = np.arange(max_dupe)[None, :]
        src = starts[dup_i][:, None] + d_off  # (n_dup, D)
        valid = d_off < counts[dup_i][:, None]
        src_c = np.clip(src, 0, len(se_c) - 1)
        dupes[:n_dup, :, 0] = np.where(valid, se_c[src_c], EMPTY).astype(np.int32)
        dupes[:n_dup, :, 1] = np.where(valid, se_p[src_c], 0).astype(np.int32)
    return keys, contigs, poss, dupes, max_dupe


def _place(order, buckets, fill, nb, slots_per_bucket: int = SLOTS):
    """Given candidate bucket per key (and current fills), compute slot for
    keys in `order`; returns (slots, placed_mask) — vectorized rank-within-
    bucket via sort."""
    srt = np.argsort(buckets[order], kind="stable")
    ob = order[srt]
    bs = buckets[ob]
    # rank within equal-bucket runs
    first = np.concatenate([[True], bs[1:] != bs[:-1]])
    idx = np.arange(len(bs))
    run_start = np.maximum.accumulate(np.where(first, idx, -1))
    rank = idx - run_start
    slots = fill[bs] + rank
    ok = slots < slots_per_bucket
    return ob, bs, slots, ok


def _place_2choice(keys, nb, shift, slots_per_bucket, rounds: int = 8):
    """Iterative balanced 2-choice placement of unique `keys` into nb
    buckets of `slots_per_bucket`: each round sends pending keys to the
    currently-emptier of their two buckets; repeated rounds converge at
    load factors well above what single-pass overflow tolerates. A tiny
    residue falls back to a cuckoo eviction random walk.

    -> (bucket, slot) int64 arrays per key, or None if placement failed."""
    fill = np.zeros(nb, np.int64)
    out_b = np.full(len(keys), -1, np.int64)
    out_s = np.full(len(keys), -1, np.int64)
    pending = np.arange(len(keys))
    b1_all = h1_np(keys, shift)
    b2_all = h2_np(keys, shift)
    for r in range(rounds):
        if len(pending) == 0:
            break
        b1 = b1_all[pending]
        b2 = b2_all[pending]
        # alternate preference on ties/rounds to break livelock
        if r % 2 == 0:
            choose = np.where(fill[b1] <= fill[b2], b1, b2)
        else:
            choose = np.where(fill[b2] <= fill[b1], b2, b1)
        buckets = np.empty(len(keys), np.int64)
        buckets[pending] = choose
        ob, bs, slots, ok = _place(pending, buckets, fill, nb, slots_per_bucket)
        put = ob[ok]
        out_b[put] = bs[ok]
        out_s[put] = slots[ok]
        np.add.at(fill, bs[ok], 1)
        pending = ob[~ok]
    if len(pending):
        if len(pending) > 4096:
            return None
        occupant = np.full((nb, slots_per_bucket), -1, np.int64)
        placed = out_b >= 0
        occupant[out_b[placed], out_s[placed]] = np.nonzero(placed)[0]
        for i in pending.tolist():
            if not _cuckoo_place(
                occupant, fill, keys, out_b, out_s, i, shift, slots_per_bucket
            ):
                return None
    return out_b, out_s


def _cuckoo_place(occupant, fill, keys, out_b, out_s, i, shift,
                  slots_per_bucket, max_kicks: int = 500):
    """Place key index i via random-walk eviction, updating the placement
    arrays in-place."""
    rng = np.random.default_rng(np.uint32(keys[i]))
    cur = i
    bucket = int(h1_np(np.uint32(keys[cur]), shift))
    for _ in range(max_kicks):
        for b in (bucket, _alt_bucket(int(keys[cur]) & 0xFFFFFFFF, bucket, shift)):
            if fill[b] < slots_per_bucket:
                s = int(fill[b])
                occupant[b, s] = cur
                out_b[cur], out_s[cur] = b, s
                fill[b] += 1
                return True
        s = int(rng.integers(slots_per_bucket))
        victim = int(occupant[bucket, s])
        occupant[bucket, s] = cur
        out_b[cur], out_s[cur] = bucket, s
        cur = victim
        bucket = _alt_bucket(int(keys[cur]) & 0xFFFFFFFF, bucket, shift)
    return False


def _build(keys, contigs, poss, nb, shift, rounds: int = 8):
    """2-choice placement into the split [key, contig, pos] slot layout."""
    placed = _place_2choice(keys, nb, shift, SLOTS, rounds)
    if placed is None:
        return None
    pb, ps = placed
    table = np.zeros((nb, SLOTS, 3), np.int32)
    table[:, :, 1] = EMPTY
    table[pb, ps, 0] = keys.astype(np.int32)
    table[pb, ps, 1] = contigs
    table[pb, ps, 2] = poss
    return table


def _alt_bucket(key: int, bucket: int, shift: int) -> int:
    k = np.uint32(key)
    b1 = int(h1_np(k, shift))
    b2 = int(h2_np(k, shift))
    return b2 if bucket == b1 else b1


def _place_single_hash(keys: np.ndarray, nb: int, shift: int, slots: int):
    """Single-hash placement with h2 spill: -> (bucket, slot, ovf_mask) or
    None when placement fails (caller doubles nb). Buckets with more than
    `slots` keys keep slots-1 inline (the last slot carries the overflow
    marker) and spill the rest to free slots of their h2 buckets; a spill
    whose h2 bucket is full gets one eviction rescue — an inline key of
    the (already-flagged) h1 bucket moves to ITS h2 bucket, freeing an
    inline slot. Inline order within a bucket follows the deterministic
    key order from _entries_from_indexer; spills are handled in that same
    order."""
    n = len(keys)
    b1_all = h1_np(keys, shift)
    counts = np.bincount(b1_all, minlength=nb)
    ovf = counts > slots
    cap = np.where(ovf, slots - 1, slots).astype(np.int64)
    order = np.argsort(b1_all, kind="stable")
    ob = b1_all[order]
    first = np.concatenate([[True], ob[1:] != ob[:-1]]) if n else np.zeros(0, bool)
    idx = np.arange(n)
    run_start = np.maximum.accumulate(np.where(first, idx, -1)) if n else idx
    rank = idx - run_start
    inline = rank < cap[ob]
    out_b = np.full(n, -1, np.int64)
    out_s = np.full(n, -1, np.int64)
    out_b[order[inline]] = ob[inline]
    out_s[order[inline]] = rank[inline]
    used = np.minimum(counts.astype(np.int64), cap)
    spill = np.sort(order[~inline])  # deterministic: original entry order
    if not len(spill):
        return out_b, out_s, ovf
    h2_all = h2_np(keys, shift)
    # inline occupants of flagged buckets (eviction candidates)
    occ = {}
    infl = np.nonzero((out_b >= 0) & ovf[np.clip(out_b, 0, nb - 1)])[0]
    for j in infl.tolist():
        occ.setdefault(int(out_b[j]), []).append(j)
    retry = []
    for i in spill.tolist():
        b = int(h2_all[i])
        if used[b] < cap[b]:
            out_b[i] = b
            out_s[i] = used[b]
            used[b] += 1
            continue
        bh1 = int(b1_all[i])
        for j in occ.get(bh1, []):
            c = int(h2_all[j])
            if c != bh1 and used[c] < cap[c]:
                # move the victim to its h2 (its h1 bucket is flagged, so
                # queries for it will second-probe); the spill key takes
                # the freed inline slot
                out_b[i], out_s[i] = out_b[j], out_s[j]
                out_b[j], out_s[j] = c, used[c]
                used[c] += 1
                occ[bh1].remove(j)
                occ[bh1].append(i)
                break
        else:
            retry.append(i)
    if retry and not _spill_walk(
        keys, retry, b1_all, h2_all, ovf, cap, used, out_b, out_s
    ):
        return None
    return out_b, out_s, ovf


def _spill_walk(keys, retry, b1_all, h2_all, ovf, cap, used, out_b, out_s,
                max_kicks: int = 500):
    """Constrained cuckoo random walk for spills the one-level rescue
    could not place. Legal positions for a key k: its h1 bucket (always),
    or its h2 bucket IFF its h1 bucket carries the overflow flag — the
    query kernel only second-probes flagged rows, so the flag set (fixed
    at bucket-count time) bounds where keys may live. The walk evicts an
    occupant of a legal full bucket and re-places it under the same rules;
    rng is seeded per key for determinism."""
    nb = len(cap)
    occupant = np.full((nb, int(cap.max())), -1, np.int32)
    placed = out_b >= 0
    occupant[out_b[placed], out_s[placed]] = np.nonzero(placed)[0]

    def movable(o, b):
        # occupant o of bucket b can walk elsewhere: to h2(o) if its h1
        # bucket is flagged (and differs from b), or home to h1(o) if it
        # was spilled into b
        if int(b1_all[o]) == b:
            return ovf[b] and int(h2_all[o]) != b
        return True

    for start in retry:
        rng = np.random.default_rng(np.uint32(keys[start]))
        cur = int(start)
        ok = False
        for _ in range(max_kicks):
            b1c = int(b1_all[cur])
            targets = [b1c]
            if ovf[b1c]:
                b2c = int(h2_all[cur])
                if b2c != b1c:
                    targets.append(b2c)
            done = False
            for b in targets:
                if used[b] < cap[b]:
                    s = int(used[b])
                    occupant[b, s] = cur
                    out_b[cur], out_s[cur] = b, s
                    used[b] += 1
                    done = True
                    break
            if done:
                ok = True
                break
            b = targets[int(rng.integers(len(targets)))]
            cands = [
                s for s in range(int(cap[b]))
                if movable(int(occupant[b, s]), b)
            ]
            if not cands:
                for b in reversed(targets):
                    cands = [
                        s for s in range(int(cap[b]))
                        if movable(int(occupant[b, s]), b)
                    ]
                    if cands:
                        break
            if not cands:
                # every occupant of every legal bucket is pinned (its only
                # legal home is this bucket): evicting one can only thrash
                # until max_kicks, so fail fast and let the caller double
                # nb / fall back to another layout
                return False
            s = cands[int(rng.integers(len(cands)))]
            victim = int(occupant[b, s])
            occupant[b, s] = cur
            out_b[cur], out_s[cur] = b, s
            cur = victim
        if not ok:
            return False
    return True
