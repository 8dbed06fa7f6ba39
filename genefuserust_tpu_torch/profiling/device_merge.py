"""The JAX package's device-side pair merge on the card, beside the host
merge that the main path runs (the port's counterpart of the merge stage
of tools/profiling/profile_stages.py and of benches/micro.py).

    python -m genefuserust_tpu_torch.profiling.device_merge \\
        [--pairs 65536] [--seed 1] [--device cuda|cpu]

builds read pairs with utils/synthetic.gen_block on a small synthetic
panel, packs them with native.pack_pe_batch (4-bit codes and 2-bit quality
classes, the JAX package's upload) and runs on the device:
fused_pass1_chunked (the merge, kernel merge_codes, and the three lanes'
pass 1), fused_merge_chunked, the row passes (pass1_rows_merged,
pass1_rows_packed, fused_pass2_combined: kernel merge_rows, then the
probe, the vote and mask+segments) and merge_batch (kernel merge_bytes) on
the same pairs as raw bytes. It checks each against its plain version and
against the host (native.merge_pack_pe_batch's merges and codes, the
scalar fast_merge on the first pairs, the votes of TorchEngine's own
lanes), and times the kernels, the three pass-1 lanes, the host packs and
merges of the same pairs, and the two uploads. `chip_smoke.py` phase 16
runs `run` on its own pairs and table. `--device cpu` runs the plain
versions and the checks; its kernel times are then null (not measured:
a CPU run gives no time of the card).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from .. import native
from ..config import MIN_OVERLAP, PASS1_STEP, Settings
from ..core.read import SequenceRead, SequenceReadPair
from ..core.sequence import COMPLEMENT_LUT
from ..ops import cuda
from ..ops import fused as tf
from ..ops import map_read as tm
from ..ops import merge as tmg
from ..ops.pack import MAP_FROM_SEQ4, lut, unpack_seq2
from .bounds import bound
from .gather_floor import event_ms

# int32 operations counted per unit of work: a column of a merged row or
# map lane (its case and writes), a gathered code (its unpack and map); the
# overlap scan's compares are not counted (the bytes bound the merges)
OPS = dict(column=4, row_code=2)
ORACLE_PAIRS = 4096
GATE = (40, 20)  # Settings' major / minor gene key requirements


def _ms(fn, reps: int, dev):
    """The card's ms of fn (event_ms); None ("not measured") elsewhere."""
    return event_ms(fn, reps) if dev.type == "cuda" else None


def _equal(name: str, got, exp) -> None:
    gs, es = (got, exp) if isinstance(got, (tuple, list)) else ((got,), (exp,))
    for g, e in zip(gs, es):
        if isinstance(g, (tuple, list)):
            _equal(name, g, e)
        elif g.shape != e.shape or not torch.equal(g, e):
            raise RuntimeError(f"device_merge: {name} differs from its plain version")


def timed(name: str, fn, plain_fn, dev, reps: int, plain_reps: int):
    """fn and plain_fn bit-equal, then both timed -> (fn's result, ms, plain ms)."""
    got = fn()
    _equal(name, got, plain_fn())
    return got, _ms(fn, reps, dev), _ms(plain_fn, plain_reps, dev)


def byte_rows(b1, q1, l1, b2, q2, l2):
    """merge_batch's inputs from pairs as sequenced: R2 reverse-complemented
    and its qualities reversed, each within its length (numpy)."""
    L = b2.shape[1]
    j = np.arange(L)[None, :]
    src = np.clip(l2[:, None] - 1 - j, 0, L - 1)
    inside = j < l2[:, None]
    b2r = np.where(inside, COMPLEMENT_LUT[np.take_along_axis(b2, src, 1)], 0).astype(np.uint8)
    q2r = np.where(inside, np.take_along_axis(q2, src, 1), 0).astype(np.uint8)
    return b1, q1, l1.astype(np.int32), b2r, q2r, l2.astype(np.int32)


def work_lists(summary, lens2):
    """From a pass-1 summary: the merged pairs and their lengths (for
    pass1_rows_merged), the unmerged reads [pair, lane, length] (for
    pass1_rows_packed), and every lane that passed its gate [pair, lane,
    length, h1, l1, h2, l2] (for fused_pass2_combined)."""
    s = summary
    merged = s[:, 0] != 0
    idx = torch.nonzero(merged).flatten()
    un = torch.nonzero(~merged).flatten()
    work = torch.cat([torch.stack([un, torch.full_like(un, k), lens2[un, k - 1].long()], 1)
                      for k in (1, 2)])
    work = work[work[:, 2] > 0]
    w7 = []
    for k, col in ((0, 3), (1, 8), (2, 13)):
        r = torch.nonzero(s[:, col] != 0).flatten()
        ln = s[r, 2] if k == 0 else lens2[r, k - 1]
        w7.append(torch.cat([r[:, None], torch.full_like(r, k)[:, None], ln.long()[:, None],
                             s[r, col + 1 : col + 5].long()], 1))
    i32 = lambda x: x.to(torch.int32).contiguous()
    return i32(idx), i32(s[idx, 2]), i32(work), i32(torch.cat(w7))


def plain_pass1(buf, lens2, index, L: int):
    """fused_pass1_chunked with every kernel's plain version."""
    msum, m_codes, maps, lens3 = tf.merge_codes_plain(buf, lens2, L, lanes=True)
    votes = [tm.vote_plain(tm.probe_plain(c, lens3[k], PASS1_STEP, index), index, *GATE)
             for k, c in enumerate(maps)]
    return torch.cat([msum, torch.stack(votes, 1).reshape(-1, 15)], 1), m_codes


def _plain_vote_rows(codes, lens, index):
    return tm.vote_plain(tm.probe_plain(codes, lens, PASS1_STEP, index), index, *GATE)


def engine_lanes(block) -> dict:
    """TorchEngine's stage 0 on these pairs: its host merge and 2-bit lanes
    (CPU tensors)."""
    from ..parallel.engine import TorchEngine

    return TorchEngine(Settings(), device="cpu")._st0_produce(*block)


def engine_votes(sh: dict, index, dev):
    """The pass-1 vote rows of TorchEngine's lanes `sh` (engine_lanes) ->
    [(pair rows, lane: 0 merged, 1 R1, 2 R2, (n, 5) votes)], one entry a
    lane."""
    codes_l = tf.lanes_codes([b.to(dev) for b in sh["bufs_d"]], list(sh["widths"]),
                             sh["exc_d"].to(dev))
    lens_l = torch.split(sh["lens_d"].to(dev), [b.shape[0] for b in sh["bufs_d"]])
    out = []
    for meta, ci, ln in zip(sh["lane_meta"], codes_l, lens_l):
        n = meta["n"]
        if not n:
            continue
        v = tm.vote(tm.probe(ci, ln, PASS1_STEP, index), index, *GATE, ln)[:n]
        if meta["kind"] == "m":
            out.append((meta["pair_rows"], np.zeros(n, np.int64), v))
        else:
            out.append((sh["rwork"][:, 0], sh["rwork"][:, 1], v))
    return out


def _oracle_merges(block, n: int) -> dict:
    """The scalar fast_merge of the first n pairs -> {row: (seq, qual, diff)}."""
    b1, q1, l1, b2, q2, l2 = block
    out = {}
    for r in range(n):
        d = lambda x, k: x[r, :k].tobytes().decode("latin-1")
        m = SequenceReadPair(SequenceRead("@r", d(b1, l1[r]), "+", d(q1, l1[r])),
                             SequenceRead("@r", d(b2, l2[r]), "+", d(q2, l2[r]))).fast_merge()
        if m is not None:
            out[r] = (m.seq, m.quality, int(m.name.rsplit("merged_diff_", 1)[1]))
    return out


def _host_seconds(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return out


def run(block, index, reps: int = 20, plain_reps: int = 3, host_reps: int = 3,
        oracle_pairs: int = ORACLE_PAIRS, others=None) -> dict:
    """The device merge of the pairs `block` (b1, q1, l1, b2, q2, l2 numpy,
    R2 as sequenced) against `index` (a TorchIndex on the device to run
    on) -> checks, launches of the path, the kernels' records, times.
    `others`: None, or {label: a context manager factory inside which the
    port's wrappers launch another build's kernels}; merge_rows is then
    also held bit-equal and timed under each on its three uses
    (`{label}_ms`)."""
    dev = index.table.device
    b1, q1, l1, b2, q2, l2 = block
    B, L = b1.shape
    res = dict(pairs=B, L=L)
    # host: the upload pack and the main path's merge + pack of these pairs
    packed = native.pack_pe_batch(b1, q1, b2, q2, l1, l2, L, B)
    if packed is None:
        raise RuntimeError("device_merge: the native library is not available")
    buf_np, exotic = packed
    pack_s = _host_seconds(lambda: native.pack_pe_batch(b1, q1, b2, q2, l1, l2, L, B),
                           host_reps)
    host = native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L)
    merge_s = _host_seconds(lambda: native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L),
                            host_reps)
    res["host"] = dict(pack_pe_batch_s=min(pack_s), pack_pe_batch_all_s=pack_s,
                       merge_pack_pe_batch_s=min(merge_s), merge_pack_pe_batch_all_s=merge_s,
                       exotic=int(exotic.sum()))
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    buf, lens2 = put(buf_np), put(np.stack([l1, l2], 1).astype(np.int32))
    rows = tuple(put(x) for x in byte_rows(b1, q1, l1, b2, q2, l2))
    nk = tm.vote_width((2 * L - 16) // PASS1_STEP + 1, index.D)
    if nk > tm.MAX_VOTE_KEYS:
        raise RuntimeError(f"device_merge: the merged lane's vote width {nk} takes the wide vote")
    res["merged_lane_vote_width"] = nk
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # the path, once, its launches counted
    cuda.reset_launches()
    summary, m_codes = tf.fused_pass1_chunked(buf, lens2, index, L, B)
    msum, m_codes2 = tf.fused_merge_chunked(buf, lens2, L, B)
    idx, mlens, work, w7 = work_lists(summary, lens2)
    rows_m = tf.pass1_rows_merged(m_codes, idx, mlens, index, 2 * L)
    rows_p = tf.pass1_rows_packed(buf, work, index, L)
    seg = tf.fused_pass2_combined(m_codes, buf, w7, index, L)
    mb = tmg.merge_batch(*rows)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["launches"] = {k: cuda.LAUNCHES[k] for k in ("merge_codes", "merge_rows", "merge_bytes",
                                                     "probe", "vote", "mask_segments")}

    # (a) bit-equal to the plain versions
    _equal("fused_pass1_chunked", (summary, m_codes), plain_pass1(buf, lens2, index, L))
    _equal("fused_merge_chunked", (msum, m_codes2), tf.merge_codes_plain(buf, lens2, L))
    _equal("merge_batch", tuple(mb), tuple(tmg.merge_batch_plain(*rows)))
    # (d) the row passes against plain, and the pass-1 rows against the
    # summary's lanes and the votes of TorchEngine's lanes
    W2 = 2 * L - MIN_OVERLAP
    _equal("pass1_rows_merged", rows_m, _plain_vote_rows(
        tf.merge_rows_plain(m_codes, None, idx, None, tf.merged_width(2 * L), 0), mlens, index))
    _equal("pass1_rows_packed", rows_p, _plain_vote_rows(
        tf.merge_rows_plain(None, buf, work[:, 0], work[:, 1], L, L), work[:, 2].contiguous(),
        index))
    codes2 = tf.merge_rows_plain(m_codes, buf, w7[:, 0], w7[:, 1], W2, L)
    lens7 = w7[:, 2].contiguous()
    _equal("fused_pass2_combined", seg, tm.mask_segments_plain(
        tm.probe_plain(codes2, lens7, 1, index), lens7, w7[:, 3:7].contiguous(), index, 10))
    s = summary.cpu().numpy()
    col_of = {0: 3, 1: 8, 2: 13}
    check_rows = [(rows_m.cpu().numpy(), idx.cpu().numpy(), np.zeros(len(idx), np.int64)),
                  (rows_p.cpu().numpy(), work[:, 0].cpu().numpy(), work[:, 1].cpu().numpy())]
    for got, pr, lane in check_rows:
        want = np.stack([s[p, col_of[k] : col_of[k] + 5] for p, k in zip(pr, lane)]) \
            if len(pr) else np.zeros((0, 5), np.int32)
        if not (got == want).all():
            raise RuntimeError("device_merge: a row pass's votes differ from the summary's")
    ok = ~exotic
    n_engine = 0
    sh = engine_lanes(block)
    for pr, lane, v in engine_votes(sh, index, dev):
        want = np.stack([s[p, col_of[int(k)] : col_of[int(k)] + 5] for p, k in zip(pr, lane)])
        keep = ok[pr]
        if not (v.cpu().numpy()[keep] == want[keep]).all():
            raise RuntimeError("device_merge: pass-1 rows differ from TorchEngine's lane votes")
        n_engine += int(keep.sum())
    # (b) against the host merge + pack (the main path's stage 0)
    merged = s[:, 0] != 0
    if not ((merged == host["m_flag"]) | exotic).all() or not (
            (s[:, 2] == host["m_len"]) | exotic).all():
        raise RuntimeError("device_merge: merged / m_len differ from merge_pack_pe_batch's")
    hm = np.nonzero(host["m_flag"])[0]
    hcodes = unpack_seq2(torch.from_numpy(host["mbuf"]), 2 * L).numpy().copy()
    if len(host["m_exc"]):
        hcodes[host["m_exc"][:, 0], host["m_exc"][:, 1]] = 255
    dcodes = lut(MAP_FROM_SEQ4, m_codes[torch.from_numpy(hm).to(dev)]).cpu().numpy()
    inside = np.arange(2 * L)[None, :] < host["m_len"][hm][:, None]
    if not (np.where(inside, dcodes, 0) == np.where(inside, hcodes, 0)).all():
        raise RuntimeError("device_merge: merged codes differ from merge_pack_pe_batch's rows")
    # (c) merge_batch against the scalar fast_merge on the first pairs
    n_or = min(oracle_pairs, B)
    oracle = _oracle_merges(block, n_or)
    mbm, _, mbd, mbs, mbq, mbl = (x[:n_or].cpu().numpy() for x in mb)
    bad = [r for r in range(n_or) if bool(mbm[r]) != (r in oracle) or (
        r in oracle and (mbs[r, : mbl[r]].tobytes().decode("latin-1") != oracle[r][0]
                         or mbq[r, : mbl[r]].tobytes().decode("latin-1") != oracle[r][1]
                         or int(mbd[r]) != oracle[r][2]))]
    if bad:
        raise RuntimeError(f"device_merge: merge_batch differs from fast_merge at rows {bad[:8]}")
    res["checks"] = dict(
        plain="fused_pass1_chunked, fused_merge_chunked, merge_batch, pass1_rows_merged, "
              "pass1_rows_packed, fused_pass2_combined bit-equal",
        host_merge_pairs=int(ok.sum()), merged=int(merged.sum()), host_merged=len(hm),
        oracle_pairs=n_or, oracle_merged=len(oracle), engine_lane_rows=n_engine,
        gated=dict(m=int(s[:, 3].sum()), r1=int(s[:, 8].sum()), r2=int(s[:, 13].sum())),
        rows_merged=int(idx.shape[0]), rows_packed=int(work.shape[0]), rows_pass2=int(w7.shape[0]),
        segments=int(seg[:, 0].sum()))

    # (e) times
    k = {}
    _, ms, pms = timed("merge_batch", lambda: tmg.merge_batch(*rows),
                       lambda: tmg.merge_batch_plain(*rows), dev, reps, plain_reps)
    k["merge_bytes"] = dict(ms=ms, plain_ms=pms, **bound(
        4 * B * L + 8 * B + 13 * B + 2 * B * 2 * L, OPS["column"] * B * 2 * L))
    k["merge_bytes"]["shape"] = f"{B} pairs, L {L}"
    W = buf.shape[1]
    _, ms, pms = timed("merge_packed (lanes)", lambda: tf.merge_packed(buf, lens2, L, True),
                       lambda: tf.merge_codes_plain(buf, lens2, L, True), dev, reps, plain_reps)
    _, ms0, pms0 = timed("merge_packed", lambda: tf.merge_packed(buf, lens2, L),
                         lambda: tf.merge_codes_plain(buf, lens2, L), dev, reps, plain_reps)
    k["merge_codes"] = dict(ms=ms, plain_ms=pms, **bound(
        B * W + 8 * B + 12 * B + B * 2 * L + B * 4 * L + 12 * B, OPS["column"] * B * 6 * L))
    b0 = bound(B * W + 8 * B + 12 * B + B * 2 * L, OPS["column"] * B * 2 * L)
    k["merge_codes"].update(shape=f"{B} pairs, L {L}, upload rows of {W} bytes, with the three "
                                  f"map-code lanes", no_lanes_ms=ms0, no_lanes_plain_ms=pms0,
                            no_lanes_bound_ms=b0["bound_ms"])
    # merge_rows on its three uses: the merged rows of pass 1 (the record:
    # the most rows), the unmerged reads of pass 1, pass 2's gated lanes
    uses = dict(
        merged=(m_codes, None, idx, None, tf.merged_width(2 * L)),
        packed=(None, buf, work[:, 0], work[:, 1], L),
        pass2=(m_codes, buf, w7[:, 0], w7[:, 1], W2))
    rec = {}
    for use, (mc, bf, ix, ln, Wu) in uses.items():
        _, ms, pms = timed(f"merge_rows ({use})", lambda: tf.merge_rows(mc, bf, ix, ln, Wu, L),
                           lambda: tf.merge_rows_plain(mc, bf, ix, ln, Wu, L), dev, reps,
                           plain_reps)
        other_ms = {}
        for label, swapped in (others or {}).items():
            with swapped():
                _equal(f"merge_rows ({use}, {label})", tf.merge_rows(mc, bf, ix, ln, Wu, L),
                       tf.merge_rows_plain(mc, bf, ix, ln, Wu, L))
                ms_o = _ms(lambda: tf.merge_rows(mc, bf, ix, ln, Wu, L), reps, dev)
            if ms_o is not None:
                other_ms[f"{label}_ms"] = ms_o
        lanes_u = np.zeros(ix.shape[0], np.int64) if ln is None else ln.cpu().numpy()
        from_m = int((lanes_u == 0).sum()) if mc is not None else 0
        read = from_m * Wu + (ix.shape[0] - from_m) * ((L + 1) // 2)
        rec[use] = dict(rows=int(ix.shape[0]), width=Wu, ms=ms, plain_ms=pms, **bound(
            read + 8 * ix.shape[0] + ix.shape[0] * Wu, OPS["row_code"] * ix.shape[0] * Wu))
        rec[use].update(other_ms)
    k["merge_rows"] = dict(rec["merged"], shape=f"{idx.shape[0]} merged rows of pass 1 at width "
                                                f"{tf.merged_width(2 * L)}")
    for use in ("packed", "pass2"):
        k["merge_rows"].update({f"{use}_{x}": v for x, v in rec[use].items()
                                if x in ("rows", "ms", "plain_ms", "bound_ms") or x in other_ms})
    for v in k.values():
        v["err"] = 0
    res["kernels"] = k
    # the three pass-1 lanes (probe + vote each), and the whole call
    _, _, maps, lens3 = tf.merge_packed(buf, lens2, L, True)
    lanes = dict(all_ms=_ms(lambda: tf.pass1_lanes(maps, lens3, index, *GATE), reps, dev))
    for name, c, ln in zip(("m", "r1", "r2"), maps, lens3):
        lanes[f"{name}_probe_ms"] = _ms(lambda: tm.probe(c, ln, PASS1_STEP, index), reps, dev)
        pr = tm.probe(c, ln, PASS1_STEP, index)
        lanes[f"{name}_vote_ms"] = _ms(lambda: tm.vote(pr, index, *GATE, ln), reps, dev)
        lanes[f"{name}_width"] = c.shape[1]
        lanes[f"{name}_rows"] = int((ln > 0).sum())
    lanes["fused_pass1_chunked_ms"] = _ms(lambda: tf.fused_pass1_chunked(buf, lens2, index, L, B),
                                          reps, dev)
    res["pass1_lanes"] = lanes
    # the uploads: this path's 4-bit buffer, the main path's 2-bit lanes
    if dev.type == "cuda":
        lane_t = [t.pin_memory() for t in (*sh["bufs_d"], sh["lens_d"], sh["exc_d"])]
        up_t = [torch.from_numpy(buf_np).pin_memory(),
                torch.from_numpy(np.stack([l1, l2], 1).astype(np.int32)).pin_memory()]
        copy = lambda ts: [t.to(dev, non_blocking=True) for t in ts]
        res["h2d"] = dict(
            buf4_bytes=sum(t.numel() * t.element_size() for t in up_t),
            buf4_ms=event_ms(lambda: copy(up_t), reps),
            lanes2_bytes=sum(t.numel() * t.element_size() for t in lane_t),
            lanes2_ms=event_ms(lambda: copy(lane_t), reps))
    return res


def make_pairs(n: int, seed: int, workdir: str):
    """A small synthetic panel and n pairs of 150 bases from gen_block ->
    (mapper, [b1, q1, l1, b2, q2, l2])."""
    from ..core.mapper import FusionMapper
    from ..utils.synthetic import gen_block, make_panel, write_panel_files

    panel = make_panel(seed=seed)
    _, csv = write_panel_files(panel, workdir)
    mapper = FusionMapper(panel.contigs, csv, Settings())
    blk = gen_block(mapper, n, 150, seed=seed)
    return mapper, [blk.left.seq, blk.left.qual, blk.left.lens,
                    blk.right.seq, blk.right.qual, blk.right.lens]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("device_merge: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    from ..ops.index import build_packed_index, index_to_torch

    with tempfile.TemporaryDirectory() as wd:
        mapper, block = make_pairs(args.pairs, args.seed, wd)
        index = index_to_torch(build_packed_index(mapper.indexer), dev)
        if dev.type == "cuda":
            from .gather_floor import card_line

            print(f"card: {card_line()}", flush=True)
        res = run(block, index)
    print(json.dumps(res, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
