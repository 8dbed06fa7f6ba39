"""Smoke run of the PyTorch/CUDA port (genefuserust_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--probe-sweep | --gather-sweep | --profile-only |
                           --glue-sweep] [--glue-baseline DIR] [--wide-baseline DIR]

Phases, one result line each; any failure raises and exits non-zero:

  1 device   require CUDA; the card's name and power limit (nvidia-smi)
  2 build    compile the csrc/ kernels with nvcc (sm_90a)
  3 kernels  each kernel against its plain PyTorch version, on the card,
             bit-equal, at main-path shapes: the probe over a 65,536-row
             batch against a 15.2 Mbp panel's kv2 table (2^26 rows), with
             the table rows its lookup needs (32-byte sectors: one for a
             key in its h1 row, two for any other) and the rows the kernel
             counts itself loading; the vote on the same batch, mask+segments on the
             1,024 rows the scan hands it; the probe on a small panel
             packed kv4, kv8 and split. The glue of fused_scan_lanes
             (csrc/fused_glue.cu): the lanes' unpack and its exceptions
             (G1, a launch of each a batch), the survivor compaction with
             the bitmap and the survivors' code rows (G2: count, then
             place, over tiles of rows, the place launch copying the
             placed rows) on the batch's own three lanes, its votes and
             cap 1024, each kernel also alone, survivor_rows (G3, the
             rows of lanes past the place launch's 8) too;
             then on edge batches: the lanes cut to row counts that are
             not multiples of 32 with exceptions at negative columns and a
             cap below the survivors; N a multiple of the compaction tile
             (cap past N) and a tile -1 and +1; pad entries only; cap 0
             (no row placed); the lanes split into 12, more than one unpack or place launch
             takes, also through fused_scan_lanes (its survivor_rows
             launch: that kernel's path). Each beside its library call
             where one exists, and with --glue-baseline DIR beside another
             checkout's unpack and compaction with its survivor_rows
             launch. Kernel and plain times from CUDA events.
  4 golden   tests/goldens/planted.{json,html} through TorchEngine, byte
             for byte (timestamps stripped), at survivor cap 1024 and 2
  5 cli      262,144 read pairs (plus two planted fusions) through the
             port's CLI: every kernel of the scan launched (survivor_rows
             not: 3 lanes), >= 1 fusion reported; the
             edit-distance flushes it made, re-encoded, kernel bit-equal
             to plain and to host Myers; the Myers kernel timed on the
             largest of them and on the one nearest 100 jobs
  6 oracle   the first 4,096 pairs: TorchEngine's JSON equal to the host
             oracle's, with the kv2 and the split table
  7 profile  the same 262,144 pairs through a warm TorchEngine, the kv2
             table already on the card, under torch.profiler: device time
             by kernel (G1-G3 apart from the rest of torch's ops), the
             glue's device ms and share of the busy ms, the five largest
             of those other ops by name, and the device's busy share of
             the scan's wall time
  8 gather   the gather-floor probe (profiling/gather_floor.py) bit-equal
             to its plain version: (a) over the kv2 table, against the
             probe's time, reading (a1) both rows of every valid k-mer of
             phase 3's batch and (a2) the rows its lookup needs;
             (b) and (c) through its entry point at the two TPU kernels'
             shapes, int32[2^22, 128], 2^17 indices, 1 and 128 lanes
  9 edit     the Myers kernel bit-equal to its plain version on 65,536
             jobs of 100-300 bases, 2,000 of them also to host Myers
 10 rich     8,192 pairs, 1 in 8 a junction pair: TorchEngine's JSON equal
             to the host oracle's, its edit distances through the kernel;
             its flushes checked as in phase 5; over the jobs phases 5
             and 10 flushed, the sweep of flush sizes that DEVICE_MIN_JOBS
             was set from
 11 multi    panel.csv split into 3 CSVs of 10 genes, listed in a CSV-list
             file: the 262,144 pairs through the port's CLI, and on the
             first 4,096 pairs each CSV's JSON equal to the host oracle's
 12 single   R1 of the 262,144 pairs through the CLI, and the first 4,096
             reads' JSON equal to the host oracle's
 13 sharded  the contig-sharded index on 4 shards of the one card: the
             first 65,536 pairs (16 planted junction pairs among them) and
             their R1 alone through the driver with a 4-entry device list,
             the pairs also through the CLI with --mesh 1; JSON and HTML
             equal to TorchEngine's single-table scan of the same reads,
             and on the first 4,096 pairs/reads to the host oracle's; one
             shard flags launch a call (the 4 shards in one launch). The
             split probe, the vote's counts mode, the merge (the whole
             step from the shards' rows to the gate and keys, and its
             other read design), the flags and mask+segments from flags
             bit-equal to plain at the scan's largest batch, timed. Then
             the wide paths: a 4,200-base and a
             70,000-base read among 62 others, single-end and as R1 of
             pairs, through TorchEngine and the sharded engine, reports
             equal to the host oracle's; at the largest wide call of each
             engine (kv2 table; 4 split shard tables) the vote in both
             modes, mask+segments, the flags and mask+segments from flags
             bit-equal to plain, each wide kernel also with caps that send
             its long rows to global scratch, the wide paths timed with
             bounds from what the rows need (the samples and k-mers inside
             their lengths), and sharded_map_read's peak device memory
             there. Then (viii) the five wide kernels at a 4,096-row lane
             as TorchEngine builds one: the 70,000-base read among 4,095 R1
             reads of 150 bases, every row padded to 70,016 bases;
             bit-equal to plain (plain in chunks of rows) with the default
             caps and on the global route (the shard flags also ORing into
             stored words), timed; sharded_map_read of the lane on the 4
             shard tables, its peak device memory.
 14 multi-device
             data parallelism on the one card: (a) the 262,144 pairs
             through the driver with RunConfig.devices = 4 entries of
             cuda:0 (one table, 4 upload and 4 compute streams, one
             65,536-pair batch an entry): JSON and HTML equal to phase
             5's, phase 5's launches, then warm scans timed beside phase
             7's; (b) dryrun_multichip(4) on 4 entries of the card;
             (c) --mesh 2 through the CLI exits with the JAX driver's
             message, --mesh auto is the one-device engine with phase 5's
             launches and reports; (d) a world-size-1 NCCL group and one
             all_reduce on the card; (e) the probe bit-equal to plain on a
             batch of one 250,000-base row and 63 of 150 bases, strides 2
             and 1, timed with its bound and its own row count, then those
             reads with their mates through TorchEngine, reports equal to
             the CPU engine's.
 15 layouts  the single-probe table layouts on the panel of phases 3 and
             5: (a) phase 5's CLI job with GENEFUSE_TABLE_LAYOUT=kvs and
             =kv16 (unset after): HTML, JSON and stdout equal to the kv2
             job's (times masked), the variant launched and the kv probe
             not; the job's pack by the port's builder (a pack that falls
             through to another layout fails), its seconds, the share of
             the single-hash placement and of the spill walk, buckets,
             bytes, flagged buckets and spilled keys; (b) phase 3's first
             batch probed on the job's table at strides 2 and 1 through
             the probe's single-probe variant, bit-equal to plain and to
             the kv2 table's results, its own count of rows loaded equal
             to valid + need2 (a kvs row one 32-byte sector, a kv16 row
             two) and its count of the 32-byte sectors it requested
             beside those rows' whole sectors, timed beside kv2's probe
             and the gather floor (profiling/gather_floor.py) over the
             same rows in query order; the variant's registers.
 16 device merge
             the JAX package's device-side pair merge, off the main path
             (TorchEngine merges on the host): phase 3's 65,536 pairs
             packed by native.pack_pe_batch (4-bit codes, quality classes)
             and uploaded, then through profiling/device_merge.run on the
             kv2 table, its launches counted: fused_pass1_chunked (kernel
             merge_codes, then the three lanes' probe and vote),
             fused_merge_chunked, pass1_rows_merged, pass1_rows_packed and
             fused_pass2_combined (kernel merge_rows) on the work lists of
             the summary, merge_batch (kernel merge_bytes). (a) each
             bit-equal to its plain version; (b) merged, m_len and the
             merged codes equal native.merge_pack_pe_batch's on the pairs
             that are not exotic; (c) merge_batch's bytes, qualities and
             diff equal the scalar fast_merge on the first 4,096 pairs; (d)
             the row passes bit-equal to plain, each pass-1 row equal to
             the summary's lane and to the vote of TorchEngine's own lane
             for that pair; (e) the three kernels timed with their bounds,
             the three pass-1 lanes, the host's pack_pe_batch and
             merge_pack_pe_batch seconds on the same pairs, and the upload
             of the 4-bit buffer beside that of TorchEngine's 2-bit lanes.
 17 large tables
             tables past the 2^31- and 2^32-byte marks, made on the card
             from the kv2 table's entries (profiling/large_tables.py): kv2
             at 2^30 rows (8 GiB) and split at 2^28 buckets (24 GiB with
             its vals), its dupe rows from row 2^25 on (past 2^31 bytes).
             Phase 3's batch probed on each at strides 2 and 1, bit-equal
             to plain, with rows read past both marks (and vals rows past
             2^32 bytes), the probe's own count of rows loaded equal to the
             rows needed; on the split table the vote, mask+segments and
             the shard flags bit-equal to plain, with dupe rows named past
             2^31 bytes; the probe on the 8 GiB table timed beside phase
             3's table. Table bytes and the highest offsets read are
             printed.

The last three lines are the kernels' JSON record, nvidia-smi's
name/power line and the contract line {"ok": true, "device": {...}}.

--probe-sweep runs phases 1-3, then the probe's launch-shape sweep on
phase 3's batch (queries a thread x table-row cache policy x block size,
each shape a build of csrc/probe.cu with -D overrides, each held
bit-equal to plain), then the single-probe variant's on the same batch
on the panel's kvs and kv16 tables (queries a thread x block size, with
each build's registers), prints them and stops: no contract line.
--profile-only runs phase 1, packs the kv2 table and runs phase 7, then
stops (no contract line): a copy of this script beside another checkout's
genefuserust_tpu_torch profiles that checkout's warm scan.
--glue-sweep runs phases 1-3, then builds csrc/fused_glue.cu at each
compaction tile of GLUE_SWEEP_TILES and times the compaction with the
code rows on phase 3's first batch and its tile edges (each held
bit-equal to plain), prints
it and stops: no contract line. --glue-baseline DIR (another checkout's
csrc/, e.g. the parent's from `git archive`) adds that build's lane unpack
and compaction with its code rows (copied by its place launch), timed on
phase 3's batch, to phase 3's glue lines.
--wide-baseline DIR (another checkout's csrc/, e.g. the parent's) builds
its probe.cu, vote.cu, mask_segments.cu and merge.cu and times their
kernels on the same inputs, each held bit-equal to plain: phase 15's
single-probe variant at both strides (between two timings of this
checkout's), phase 16's row gather on its three row passes, phase 3's
probe, vote and
mask+segments (between two timings of this checkout's, and the machine
code of probe_kernel, vote_kernel and mask_segments_kernel against the
parent's, cuobjdump -sass), phase 13's merge, shard flags and mask
from flags at the scan's largest call, each wide
kernel at phase 13's calls and at its 4,096-row lane, and the parent's
sharded_map_read's peak device memory beside this checkout's at the wide
calls.
--gather-sweep runs phases 1-3, then the gather's launch-shape sweep
(blocks a tile x row loads a thread: at (a2) for rows narrower than 16
bytes, at (b) and at rows of 256, 512 and 1,024 int32 for rows of whole
16 bytes; each shape a build of csrc/gather_sum.cu with -D overrides,
each held bit-equal to plain), prints it and stops: no contract line.
Imports torch, numpy and the port (genefuserust_tpu_torch) only: nothing
of jax, of the JAX package (genefuserust_tpu) or of bench.py; its reads
come from the port's copy of the generator (utils/synthetic.gen_block).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PANEL_BP = 15_200_000
PANEL_GENES = 30
BATCH = 65_536
CLI_PAIRS = 4 * BATCH
ORACLE_PAIRS = 4_096
RICH_PAIRS = 8_192
ED_JOBS = 65_536
SHARDS = 4  # phase 13: shard tables of the smoke panel, all on the one card
SHARD_PAIRS = BATCH
MESH_ENTRIES = 4  # phase 14: TorchEngine entries, all on the one card
LONG_READ = 250_000  # phase 14 (e): past what staging a tile's rows whole allowed
LONG_BATCH = 64
# kernels the build compiles: probe 6 (kv2, kv4, kv8, split; the
# single-probe variant for kvs and kv16), vote 10 (the
# vote, its wide path, the shards' merge for 1 to 8 shards), mask_segments
# 10 (kv and split, each narrow and wide; the shards' flags, kv and split;
# from flags, narrow on segments of 8, 16 and 32 lanes, and wide),
# gather_sum 3 (vector widths), edit_distance 1, fused_glue 5 (unpack,
# exceptions, count, place with the code rows, survivor rows), merge 5
# (bytes, codes, rows)
N_COMPILED = 38
# the probe's launch-shape sweep (--probe-sweep): queries a thread, table-row
# cache policy (PROBE_POLICY in csrc/probe.cu), threads a block
PROBE_SWEEP_Q = (1, 2, 4, 8)
PROBE_POLICIES = ("nc", "cg", "nc_l1_no_allocate")
PROBE_SWEEP_THREADS = (128, 256, 512)
# the single-probe variant's threads a block (PROBE_SINGLE_THREADS in
# csrc/probe.cu), and its sweep (--probe-sweep): queries a thread
# (PROBE_SINGLE_Q) x threads a block
SINGLE_THREADS = 128
SINGLE_SWEEP_Q = (1, 2, 4)
SINGLE_SWEEP_THREADS = (64, 128, 256, 512)
# the gather's launch-shape sweep (--gather-sweep): blocks a tile x row
# loads a thread, for the narrow rows' shape at (a2) and for the wide rows'
# at the TPU ring tool's row widths (whole 128 int32; 128 is (b)), each on
# a 2 GiB table
GATHER_SWEEP_BLOCKS = (1, 2, 4, 8)
GATHER_SWEEP_LOADS = (4, 8, 16, 32)
GATHER_SWEEP_WIDTHS = (128, 256, 512, 1024)
GATHER_SWEEP_TABLE_BYTES = 1 << 31
# phase 3 times mask+segments again on its survivors padded to this width,
# past the engine's widest lane for 150-base pairs (Wcap 288)
MASK_WIDE = 320
# the kernels of the scan path (phases 5, 11, 12): the glue's but
# survivor_rows, which a batch of at most MAX_LANES lanes (every engine's)
# leaves to the place launch; phase 3's 12-lane scan launches it
GLUE_KERNELS = ("lane_unpack", "lane_exceptions", "compact_count", "compact_place",
                "survivor_rows")
SCAN_KERNELS = ("probe", "vote", "mask_segments", *GLUE_KERNELS[:4])
# the compaction's tiles that --glue-sweep builds and times
GLUE_SWEEP_TILES = (256, 512, 1024, 2048, 4096, 8192)
SURVIVOR_CAP = 1024  # TorchEngine's survivor cap (_surv_cap)
# phase 13's kernels of the sharded path (the split probe, the sharded
# stages) and of the wide-row paths (LAUNCHES keys)
SHARD_KERNELS = ("probe_split", "vote_counts", "merge_top2", "shard_flags", "mask_from_flags")
WIDE_KERNELS = ("vote_wide", "vote_counts_wide", "mask_segments_wide", "shard_flags_wide",
                "mask_from_flags_wide")
# phase 13's caps that send the wide paths' long rows to global scratch
# (smem_cap, bytes): below the 70,000-base row's 2,267 keys (8 bytes each)
# and its 2,188 words (16 bytes each, past the warps' 16 KB)
VOTE_CAP, MASK_CAP = 8 << 10, 16 << 10
WIDE_LANE_ROWS = 4096  # phase 13 (viii): a wide lane of one long read
SWEEP_MAX_JOBS = 4096
# bytes a random read moves from DRAM at least (one sector)
SECTOR = 32
# int32 operations counted per unit of work, read off the plain versions:
# probe, a k-mer's 2-bit shift-in per base and per valid query two hashes,
# two key compares and the payload decode; vote, a sample's decode and a
# candidate's key, compare and count; mask+segments, a candidate's two
# +-1 tests and, per base, the 16-k-mer max and the chain step; gather, an
# add per element; Myers, ~20 per text step and word (ops/edit_distance.py)
OPS = dict(probe_base=2, probe_query=16, vote_sample=2, vote_candidate=4,
           mask_candidate=4, mask_base=20, gather_element=1, myers_word_step=20,
           merge_candidate=4)
_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def max_abs_err(got, exp) -> int:
    if not exp.numel():
        return 0
    return int((got.to(exp.device).long() - exp.long()).abs().max())


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take (profiling/bounds.py's rule and
    peaks); imported here, as the port is, only once the card is found."""
    from genefuserust_tpu_torch.profiling.bounds import bound as card_bound

    return card_bound(nbytes, ops)


def dupe_row_bytes(pr, index) -> int:
    """Bytes of the dupe-row slots that the DUPE samples of `pr` name."""
    from genefuserust_tpu_torch.ops.hashtable import DUPE

    return int((pr[..., 0] == DUPE).sum()) * index.D * (8 if index.split else 4)


def probe_rows(km, ok, index) -> dict:
    """The table rows a lookup of the valid k-mers `km[ok]` needs, from the
    plain version's buckets and the table alone: one row for a key that
    lies in its h1 row, two for any other (a hit in h2, or a miss). Also
    the hits and the hits found at h1, and each row's bytes in 32-byte
    DRAM sectors (a table ten times the L2 moves whole sectors)."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm

    k = km[ok]
    b1, b2 = tm.buckets(k, index.shift)
    ki = tm._i32(k)[:, None]
    in_h1 = (index.table[b1][:, : index.S] == ki).any(1)
    c, _ = tm.lookup(index, k, torch.ones_like(in_h1))
    hit = c != tm.EMPTY
    row_bytes = 4 * index.table.shape[1]
    return dict(valid=int(k.shape[0]), in_h1=int(in_h1.sum()), hits=int(hit.sum()),
                hits_at_h1=int((hit & in_h1).sum()),
                rows=int(2 * k.shape[0] - in_h1.sum()),
                sector_bytes_per_row=-(-row_bytes // SECTOR) * SECTOR,
                b1=b1, b2=b2, in_h1_mask=in_h1)


def quiet(data: dict):
    """Send a scan's console report (the fusion listing) to the run's log
    file, so that the phase lines stay at the end of the output."""
    return contextlib.redirect_stdout(data["log"])


def strip_json(text: str) -> str:
    return "\n".join(l for l in _TS.sub("<ts>", text).splitlines()
                     if not l.startswith('\t"time"'))


def strip_stdout(text: str) -> str:
    """The CLI's stdout with its timestamps and time-used seconds masked."""
    return re.sub(r"time used: \S+ seconds", "time used: <s> seconds", _TS.sub("<ts>", text))


@contextlib.contextmanager
def captured_flushes():
    """Record the (query, ref) jobs of every EdBatcher flush made inside the
    block, in order; the flushes themselves run unchanged."""
    from genefuserust_tpu_torch.parallel.ed_batch import EdBatcher

    flushes, flush = [], EdBatcher.flush

    def recording(self):
        flushes.append([(q, r) for q, r, _ in self._jobs])
        flush(self)

    EdBatcher.flush = recording
    try:
        yield flushes
    finally:
        EdBatcher.flush = flush


def check_flushes(name: str, flushes) -> dict:
    """Encode each flush that reached DEVICE_MIN_JOBS as the batcher did and
    require the Myers kernel on the card bit-equal to its plain version on
    those tensors, and both equal to host Myers -> what was checked."""
    import torch

    from genefuserust_tpu_torch.core.edit_distance import edit_distance
    from genefuserust_tpu_torch.ops import edit_distance as ted
    from genefuserust_tpu_torch.parallel import ed_batch

    big = [f for f in flushes if len(f) >= ed_batch.DEVICE_MIN_JOBS]
    check(big, f"{name}: no edit-distance flush reached DEVICE_MIN_JOBS")
    widths, jobs, err, encoded = [], 0, 0, []
    for pairs in big:
        host, arrays = ed_batch.encode_jobs(pairs)
        if arrays is None:
            continue
        args = [torch.from_numpy(a).cuda() for a in arrays]
        W = args[0].shape[1] // 32
        got = ted.edit_distance_batch(*args, W)
        ref = ted.edit_distance_plain(*args, W)
        err = max(err, max_abs_err(got, ref))
        check(torch.equal(got, ref),
              f"{name}: Myers kernel differs from its plain version on a scan flush (W={W})")
        exp = [edit_distance(q, r) for (q, r), h in zip(pairs, host) if not h]
        check(got.cpu().tolist() == exp, f"{name}: Myers kernel differs from host Myers")
        widths.append((len(exp), W, args[2].shape[1]))
        encoded.append((args, ref))
        jobs += len(exp)
    return dict(flush_sizes=[len(f) for f in flushes], checked_flushes=len(widths),
                checked_jobs=jobs, batch_W_Lt=widths, err=err, encoded=encoded)


def myers_bound(args) -> dict:
    """Each job's pattern and text bytes and two lengths in, a distance
    out; a text step per text base over the pattern's words."""
    pl, tl = args[1].long(), args[3].long()
    return bound(int((pl + tl).sum()) + 12 * pl.shape[0],
                 OPS["myers_word_step"] * int((tl * ((pl + 31) // 32)).sum()))


def time_flushes(encoded) -> list:
    """The Myers kernel and its plain version timed on two of a scan's
    flushes, as the scan encoded them: the largest, and the one nearest
    100 jobs -> one record each."""
    from genefuserust_tpu_torch.ops import edit_distance as ted

    sizes = [a[1].shape[0] for a, _ in encoded]
    picks = [("largest", max(range(len(sizes)), key=lambda i: sizes[i])),
             ("nearest_100", min(range(len(sizes)), key=lambda i: abs(sizes[i] - 100)))]
    out = []
    for which, i in picks:
        args, ref = encoded[i]
        W = args[0].shape[1] // 32
        _, err, ms, pms = _timed_pair(f"Myers ({which} flush)",
                                      lambda: ted.edit_distance_batch(*args, W),
                                      lambda: ted.edit_distance_plain(*args, W), exp=ref,
                                      plain_reps=1)
        out.append(dict(flush=which, jobs=sizes[i], W=W, Lt=args[2].shape[1],
                        ms=round(ms, 6), plain_ms=round(pms, 6), **myers_bound(args)))
        out[-1]["bound_ms"] = round(out[-1]["bound_ms"], 6)
    return out


# ---------------- data ----------------


def write_panel(workdir: str, seed: int):
    """A 15.2 Mbp panel: 30 random genes on their own contigs, 20 exons of
    300 bp every span/21 -> (ref.fa, panel.csv, exon starts per gene)."""
    rng = np.random.default_rng(seed)
    span = PANEL_BP // PANEL_GENES
    step = span // 21
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa, csv = os.path.join(workdir, "ref.fa"), os.path.join(workdir, "panel.csv")
    exons = []
    with open(fa, "w") as ffa, open(csv, "w") as fcsv:
        for g in range(PANEL_GENES):
            seq = bases[rng.integers(0, 4, span + 100)].tobytes().decode()
            ffa.write(f">c{g:02d}\n")
            ffa.write("\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
            fcsv.write(f">G{g:02d},c{g:02d}:50-{50 + span}\n")
            starts = [50 + 60 + e * step for e in range(20)]
            for e, s in enumerate(starts):
                fcsv.write(f"{e + 1},{s},{s + 300}\n")
            exons.append(starts)
    return fa, csv, exons


def plant_fusions(contigs, exons, b1, q1, b2, q2, n_per=8, read_len=150):
    """Overwrite pairs spread over the first ORACLE_PAIRS with junction
    pairs of two fusions (exon starts of G03->G17 and G11->G24), as
    utils.synthetic plants them, so both the CLI run and the oracle
    comparison report fusions."""
    from genefuserust_tpu_torch.core.sequence import reverse_complement

    rows = np.linspace(0, ORACLE_PAIRS - 1, 2 * n_per).astype(np.int64)
    k = 0
    for ga, gb, ea, eb in ((3, 17, 5, 9), (11, 24, 12, 3)):
        lb, rb = exons[ga][ea] - 1, exons[gb][eb] - 1  # 1-based CSV -> 0-based
        fused = (contigs[f"c{ga:02d}"][lb - 400 : lb + 1]
                 + contigs[f"c{gb:02d}"][rb : rb + 400])
        for j in range(n_per):
            off = 400 - read_len + 25 + 7 * j
            r1 = fused[off : off + read_len]
            r2 = reverse_complement(fused[off + 40 : off + 40 + read_len])
            i = rows[k]
            b1[i] = np.frombuffer(r1.encode(), np.uint8)
            b2[i] = np.frombuffer(r2.encode(), np.uint8)
            q1[i] = q2[i] = ord("I")
            k += 1


def write_fastq(path: str, seq: np.ndarray, qual: np.ndarray, tag: str) -> None:
    """Fixed-width records '@<tag><row:08d>' / seq / '+' / qual."""
    n, L = seq.shape
    names = np.array([f"@{tag}{i:08d}\n" for i in range(n)], dtype=f"S{len(tag) + 10}")
    rec = np.empty((n, len(tag) + 10 + 2 * L + 4), np.uint8)
    w = len(tag) + 10
    rec[:, :w] = names.view(np.uint8).reshape(n, w)
    rec[:, w : w + L] = seq
    rec[:, w + L : w + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + L + 3 : w + 2 * L + 3] = qual
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


# ---------------- phases ----------------


def phase_device():
    import torch

    from genefuserust_tpu_torch.profiling.gather_floor import card_line

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi_line = card_line()
    say("1 device", kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), nvidia_smi=repr(smi_line),
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi_line


def phase_build():
    from genefuserust_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    lib = cuda.build()
    cuda.library()
    secs = time.perf_counter() - t0
    log = open(lib + ".log").read()
    regs = re.findall(r"Used (\d+) registers", log)
    check(len(regs) == N_COMPILED,
          f"expected {N_COMPILED} compiled kernels, ptxas reported {len(regs)}")
    say("2 build", seconds=f"{secs:.2f}", lib=os.path.relpath(lib, REPO),
        registers_per_kernel=",".join(regs))


def _timed_pair(name, kernel_fn, plain_fn, exp=None, reps=20, plain_reps=3):
    """Run kernel and plain once, require bit equality, time both (mean
    device ms after a warm-up, CUDA events). The functions may return a
    tuple or list of tensors, each compared with its counterpart."""
    import torch

    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    got = kernel_fn()
    ref = plain_fn() if exp is None else exp
    torch.cuda.synchronize()
    many = isinstance(got, (tuple, list))
    gs, rs = (got, ref) if many else ((got,), (ref,))
    check(len(gs) == len(rs) and all(g.shape == r.shape for g, r in zip(gs, rs)),
          f"{name}: kernel and plain version differ in shape")
    err = max(max_abs_err(g, r) for g, r in zip(gs, rs))
    check(all(torch.equal(g, r) for g, r in zip(gs, rs)),
          f"{name}: kernel differs from its plain version (max_abs_err {err})")
    return got, err, event_ms(kernel_fn, reps), event_ms(plain_fn, plain_reps)


def pack_kv2(data: dict):
    """The panel's kv2 table -> (packed, pack seconds, native placement
    seconds); kept in data["packed_kv2"]."""
    from genefuserust_tpu_torch import native
    from genefuserust_tpu_torch.ops.index import build_packed_index

    # time the native placement apart from the rest of the pack
    native_s = []
    native_pack = native.pack_table

    def timed_native_pack(*args):
        t = time.perf_counter()
        out = native_pack(*args)
        native_s.append(time.perf_counter() - t)
        return out

    native.pack_table = timed_native_pack
    t0 = time.perf_counter()
    try:
        packed = build_packed_index(data["mapper"].indexer)
    finally:
        native.pack_table = native_pack
    pack_s = time.perf_counter() - t0
    shape = packed.kv_tbl.shape if hasattr(packed, "kv_tbl") else "split"
    check(shape == (1 << 26, 2), f"the panel should pack as kv2 with 2^26 rows: {shape}")
    data["packed_kv2"] = packed
    return packed, pack_s, native_s


def phase_kernels(data: dict) -> dict:
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP, Settings
    from genefuserust_tpu_torch.core.indexer import Indexer
    from genefuserust_tpu_torch.core.sequence import encode_bases
    from genefuserust_tpu_torch.models.fusion import Fusion
    from genefuserust_tpu_torch.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.fused import lane_codes
    from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch
    from genefuserust_tpu_torch.parallel.engine import TorchEngine
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms
    from genefuserust_tpu_torch.utils.synthetic import vote_edge_rows

    dev = torch.device("cuda")
    packed, pack_s, native_s = pack_kv2(data)
    index = index_to_torch(packed, dev)
    # the main path's lanes for the first batch: host merge + pack (engine
    # stage 0), then the merged-short lane topped up with unmerged reads
    b1, q1, l1, b2, q2, l2 = (a[:BATCH] for a in data["block"])
    sh = TorchEngine(Settings(), device="cpu")._st0_produce(b1, q1, l1, b2, q2, l2)
    W = sh["widths"][0]
    lens_l = torch.split(sh["lens_d"], [b.shape[0] for b in sh["bufs_d"]])
    lanes = []
    for li in (0, 2):
        c = lane_codes(sh["bufs_d"][li], sh["widths"][li], sh["exc_d"], sh["offs"][li])
        full = torch.full((c.shape[0], W), 255, dtype=torch.uint8)
        full[:, : c.shape[1]] = c
        lanes.append((full, lens_l[li]))
    codes = torch.cat([c for c, _ in lanes])[:BATCH].contiguous().to(dev)
    lens = torch.cat([n for _, n in lanes])[:BATCH].contiguous().to(dev)
    say("3 kernels", tolerance="0 (integer outputs, bit-equal)", panel_bp=PANEL_BP,
        kv2_table=tuple(packed.kv_tbl.shape),
        table_mb=packed.nbytes // 2**20, pack_s=f"{pack_s:.1f}",
        native_pack_table_s=",".join(f"{s:.1f}" for s in native_s),
        batch=f"{codes.shape[0]}x{codes.shape[1]}",
        lane_widths=sh["widths"], merged=sh["n_m"], unmerged_rows=sh["n_u"])
    rec = {}
    pr, err, ms, pms = _timed_pair(
        "probe", lambda: tm.probe(codes, lens, PASS1_STEP, index),
        lambda: tm.probe_plain(codes, lens, PASS1_STEP, index))
    B, W = codes.shape
    km, kok = tm.compute_kmers(codes, lens)
    rows = probe_rows(km[:, ::PASS1_STEP], kok[:, ::PASS1_STEP], index)
    del km, kok
    # codes and lengths in, one 32-byte sector per table row the lookup
    # needs, the results out
    rec["probe"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        B * W + 4 * B + rows["rows"] * rows["sector_bytes_per_row"] + pr.numel() * 4,
        OPS["probe_base"] * B * W + OPS["probe_query"] * rows["valid"]))
    # the table rows the kernel loads, counted by the kernel itself: it
    # loads h2 only for keys not in h1, so exactly the rows needed
    loaded = probe_row_loads(codes, lens, index, pr)
    check(loaded == rows["rows"],
          f"probe: the kernel loaded {loaded} table rows, the lookup needs {rows['rows']}")
    rec["probe"].update(shape=f"kv2 table {tuple(index.table.shape)}, {B}x{W} codes, stride "
                              f"{PASS1_STEP}", rows_needed=rows["rows"], rows_loaded=loaded,
                        h1_hit_share=round(rows["hits_at_h1"] / max(1, rows["hits"]), 6))
    data["probe_batch"] = dict(rows=rows, index=index, ms=ms)
    data["probe_codes"] = (codes, lens)
    base = wide_base(data)
    if base:
        # the parent's probe between two timings of this checkout's
        rec["probe"]["parent_ms"] = parent_ms(
            "probe", lambda: base.probe(codes, lens, PASS1_STEP, index), pr, 20)
        rec["probe"]["again_ms"] = event_ms(lambda: tm.probe(codes, lens, PASS1_STEP, index), 20)
        say("3 kernels", kernel="probe", baseline=base.csrc, ms=f"{ms:.4f}",
            parent_ms=f"{rec['probe']['parent_ms']:.4f}",
            again_ms=f"{rec['probe']['again_ms']:.4f}", equal=True)
    if data["probe_sweep"]:
        sweep = sweep_probe(codes, lens, index, pr)
        best = min(sweep, key=sweep.get)
        say("3 kernels", kernel="probe",
            sweep="queries a thread, row cache policy, threads a block",
            sweep_ms=json.dumps({k: round(v, 4) for k, v in sweep.items()},
                                separators=(",", ":")),
            best=repr(best), best_ms=f"{sweep[best]:.4f}", equal=True)
    say("3 kernels", kernel="probe", layout="kv2", shape=tuple(pr.shape), stride=PASS1_STEP,
        hits=int((pr[..., 0] >= 0).sum()), valid_queries=rows["valid"],
        lookup_hits=rows["hits"], hits_at_h1=rows["hits_at_h1"],
        h1_hit_share=f"{rec['probe']['h1_hit_share']:.4f}", rows_needed=rows["rows"],
        rows_loaded=rec["probe"]["rows_loaded"], ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", bound_ms=f"{rec['probe']['bound_ms']:.4f}",
        bound_by=rec["probe"]["bound_by"], bound_share=f"{rec['probe']['bound_ms'] / ms:.4f}",
        max_abs_err=err)
    v, err, ms, pms = _timed_pair(
        "vote", lambda: tm.vote(pr, index, 40, 20),
        lambda: tm.vote_plain(pr, index, 40, 20))
    n_cand = tm.vote_candidates(pr, index)
    # probe results and the named dupe rows in, (B, 5) out
    rec["vote"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        pr.numel() * 4 + dupe_row_bytes(pr, index) + v.numel() * 4,
        OPS["vote_sample"] * pr.shape[0] * pr.shape[1]
        + OPS["vote_candidate"] * int(n_cand.sum())))
    rec["vote"]["shape"] = f"{pr.shape[0]}x{pr.shape[1]} samples, D {index.D}"
    if base:
        # the parent's vote between two timings of this checkout's
        rec["vote"]["parent_ms"] = parent_ms("vote", lambda: base.vote(pr, index, 40, 20), v, 20)
        rec["vote"]["again_ms"] = event_ms(lambda: tm.vote(pr, index, 40, 20), 20)
        say("3 kernels", kernel="vote", baseline=base.csrc, ms=f"{ms:.4f}",
            parent_ms=f"{rec['vote']['parent_ms']:.4f}",
            again_ms=f"{rec['vote']['again_ms']:.4f}", equal=True)
    ok = v[:, 0] != 0
    say("3 kernels", kernel="vote", rows=v.shape[0], samples=pr.shape[1], D=index.D,
        candidate_slots=pr.shape[1] * index.D,
        valid_candidates_mean=f"{n_cand.double().mean().item():.2f}",
        valid_candidates_max=int(n_cand.max()),
        block_path_rows=int((n_cand > tm.VOTE_WARP_KEYS).sum()), survivors=int(ok.sum()),
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", bound_ms=f"{rec['vote']['bound_ms']:.4f}",
        bound_by=rec["vote"]["bound_by"], max_abs_err=err)
    # hand-built rows: every register width of the warp path, the block path
    for layout in ("kv2", "split"):
        epr, epacked, names = vote_edge_rows(data["seed"], layout=layout)
        eidx = index_to_torch(epacked, dev)
        epr = epr.to(dev)
        got, exp = tm.vote(epr, eidx, 40, 20), tm.vote_plain(epr, eidx, 40, 20)
        err = max_abs_err(got, exp)
        bad = [names[i] for i in torch.nonzero((got != exp).any(1)).flatten().tolist()]
        check(not bad, f"vote kernel differs from vote_plain on edge rows ({layout}): {bad}")
        en = tm.vote_candidates(epr, eidx)
        rec["vote"]["err"] = max(rec["vote"]["err"], err)
        say("3 kernels", kernel="vote", rows="vote_edge_rows", layout=layout,
            n_rows=len(names), valid_candidates_max=int(en.max()),
            block_path_rows=int((en > tm.VOTE_WARP_KEYS).sum()), equal=True, max_abs_err=err)
    # the rows pass 2 gets in the scan: survivors first (row order), cap 1024
    N = ok.shape[0]
    iota = torch.arange(N, device=dev)
    sidx = torch.argsort(torch.where(ok, iota, N + iota))[:1024]
    slens = torch.where(ok[sidx], lens[sidx], 0).to(torch.int32)
    scodes = codes[sidx].contiguous()
    gp = v[sidx, 1:5].contiguous()
    pr1, _, _, _ = _timed_pair("probe (pass 2)", lambda: tm.probe(scodes, slens, 1, index),
                               lambda: tm.probe_plain(scodes, slens, 1, index), reps=5)
    seg, err, ms, pms = _timed_pair(
        "mask_segments", lambda: tm.mask_segments(pr1, slens, gp, index, 10),
        lambda: tm.mask_segments_plain(pr1, slens, gp, index, 10))
    cand2 = int(tm.expand(index, pr1[..., 0], pr1[..., 1])[2].sum())
    # probe results, lengths, the vote's keys and the named dupe rows in
    rec["mask_segments"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        pr1.numel() * 4 + slens.numel() * 4 + gp.numel() * 4 + dupe_row_bytes(pr1, index)
        + seg.numel() * 4,
        OPS["mask_candidate"] * cand2 + OPS["mask_base"] * int(slens.long().sum())))
    rec["mask_segments"]["shape"] = f"{seg.shape[0]} survivors, width {scodes.shape[1]}"
    if base:
        rec["mask_segments"]["parent_ms"] = parent_ms(
            "mask_segments", lambda: base.mask(pr1, slens, gp, index, 10), seg, 20)
        rec["mask_segments"]["again_ms"] = event_ms(
            lambda: tm.mask_segments(pr1, slens, gp, index, 10), 20)
        say("3 kernels", kernel="mask_segments", baseline=base.csrc, ms=f"{ms:.4f}",
            parent_ms=f"{rec['mask_segments']['parent_ms']:.4f}",
            again_ms=f"{rec['mask_segments']['again_ms']:.4f}", equal=True)
        # the three kernels' machine code against the parent's, instruction
        # for instruction (the sources of two of them were edited elsewhere)
        for k in ("probe", "vote", "mask_segments"):
            sass = base.sass(f"{k}_kernel")
            rec[k]["sass"] = dict(
                equal=sass["this"] == sass["parent"] and bool(sass["this"]),
                instructions=[len(v) for v in sass["this"].values()],
                parent_instructions=[len(v) for v in sass["parent"].values()])
            say("3 kernels", kernel=k, baseline=base.csrc,
                sass=json.dumps(rec[k]["sass"], separators=(",", ":")))
    say("3 kernels", kernel="mask_segments", rows=seg.shape[0], width=scodes.shape[1],
        two_segment_rows=int((seg[:, 0] & seg[:, 1]).sum()), ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", bound_ms=f"{rec['mask_segments']['bound_ms']:.5f}",
        bound_by=rec["mask_segments"]["bound_by"], max_abs_err=err)
    # the same survivors, their code rows padded with 255 to MASK_WIDE: the
    # k-mers past a read are invalid, so the rows equal width 192's
    wide = torch.full((scodes.shape[0], MASK_WIDE), 255, dtype=torch.uint8, device=dev)
    wide[:, : scodes.shape[1]] = scodes
    prw = tm.probe(wide, slens, 1, index)
    segw, errw, msw, pmsw = _timed_pair(
        f"mask_segments (width {MASK_WIDE})", lambda: tm.mask_segments(prw, slens, gp, index, 10),
        lambda: tm.mask_segments_plain(prw, slens, gp, index, 10))
    check(torch.equal(segw, seg), f"mask_segments at width {MASK_WIDE} differs from width 192's")
    rec["mask_segments"]["err"] = max(err, errw)
    rec["mask_segments"]["wide"] = dict(width=MASK_WIDE, ms=round(msw, 6), plain_ms=round(pmsw, 6))
    say("3 kernels", kernel="mask_segments", rows=segw.shape[0], width=MASK_WIDE, ms=f"{msw:.4f}",
        plain_ms=f"{pmsw:.4f}", equal_to_width_192=True, max_abs_err=errw)
    del wide, prw
    rec.update(glue_kernels(sh, index, data))

    # the other table layouts, on a small panel
    panel = make_panel(seed=data["seed"])
    small = os.path.join(data["workdir"], "small")
    os.makedirs(small)
    _, csv = write_panel_files(panel, small)
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv), Settings())
    ix.make_index()
    reads = [p.left.seq for p in plant_fusion_pairs(panel, 20, 4076, seed=data["seed"])]
    sc = np.full((len(reads), 192), 255, np.uint8)
    for i, r in enumerate(reads):
        sc[i, : len(r)] = encode_bases(r)
    sc_d = torch.from_numpy(sc).to(dev)
    sl_d = torch.tensor([len(r) for r in reads], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(data["seed"])
    q = np.concatenate([rng.choice(np.asarray(ix.uniq_keys), BATCH // 2),
                        rng.integers(0, 2**32, BATCH // 2, dtype=np.uint64)])
    q_d = torch.from_numpy(q.astype(np.uint32).view(np.int32)).to(dev)
    qv_d = torch.ones(BATCH, dtype=torch.bool, device=dev)
    for layout in ("kv4", "kv8", "split"):
        p = build_packed_index(ix, layout=layout)
        check((p.kv_tbl.shape[1] == int(layout[2:])) if hasattr(p, "kv_tbl")
              else layout == "split", f"small panel does not pack as {layout}")
        sidx_ = index_to_torch(p, dev)
        out, err, ms, pms = _timed_pair(
            f"probe {layout}", lambda: tm.probe(sc_d, sl_d, 1, sidx_),
            lambda: tm.probe_plain(sc_d, sl_d, 1, sidx_))
        flat, ferr, fms, fpms = _timed_pair(
            f"probe_kmers {layout}", lambda: tm.probe_kmers(q_d, qv_d, sidx_),
            lambda: torch.stack(tm.lookup(sidx_, q_d.long() & tm.M32, qv_d), dim=-1))
        say("3 kernels", kernel="probe", layout=layout, shape=tuple(out.shape),
            hits=int((out[..., 0] >= 0).sum()), ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            flat_queries=BATCH, flat_hits=int((flat[:, 0] != -3).sum()),
            flat_ms=f"{fms:.4f}", flat_plain_ms=f"{fpms:.4f}", max_abs_err=max(err, ferr))
    return rec


def glue_kernels(sh, index, data) -> dict:
    """The kernels of csrc/fused_glue.cu against their plain versions,
    bit-equal and timed. (i) The batch's own lanes as fused_scan_lanes
    runs them: the unpack and its exceptions (`lanes_codes`, one launch of
    each for the three lanes), the compaction with the survivors' code
    rows on their votes at cap SURVIVOR_CAP (`compact`: count, then place,
    which copies the placed rows); then each kernel alone on the same
    inputs, survivor_rows (the launch of the rows of lanes past the place
    launch's) too. (ii)
    Edge batches built from those lanes: cut to row counts that are not
    multiples of 32 with entries at negative columns and a cap of half the
    survivors; cut so that N is a multiple of the compaction tile with a
    cap past N (c spans every tile), and to a tile - 1 and + 1; the
    exceptions replaced by pad entries only; a cap of 0; the lanes split
    into 12, more than one unpack or place launch takes (the rows of lanes
    8-11 through survivor_rows), also as a whole fused_scan_lanes call
    with the launch counts set to 0 before it: survivor_rows' path. With
    data["glue_baseline"], another checkout's csrc/ (the parent's
    unpack, count, place and survivor_rows launches), that build's kernels
    are timed on (i)'s inputs. Keeps (label, v, lens, cap, code lanes) of
    (i) and of the tile edges for the compaction's tile sweep. -> the
    kernels' records."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import fused as tf
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.pack import unpack_seq2
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    dev = index.table.device
    tile = cuda.compact_tile()
    data["glue_batches"] = []

    def plain_rows(v, L, cap, codes, Wmax):
        res = tf.compact_plain(v, L, cap)
        return (*res, tf.survivor_rows_plain(codes, res[0][: res[1].shape[0], 0], Wmax))

    def run(bufs, widths, lens, exc, cap, label, reps=5, plain_reps=1):
        codes, err1, ms1, pms1 = _timed_pair(
            f"lanes_codes ({label})", lambda: tf.lanes_codes(bufs, widths, exc),
            lambda: tf.lanes_codes_plain(bufs, widths, exc), reps=reps, plain_reps=plain_reps)
        v = torch.cat([tm.vote(tm.probe(ci, ln, PASS1_STEP, index), index, 40, 20)
                       for ci, ln in zip(codes, lens)])
        L = torch.cat(lens)
        N = v.shape[0]
        Wmax = max(widths)
        (out, slens, gp, okw, rows), err2, ms2, pms2 = _timed_pair(
            f"compact with rows ({label})", lambda: tf.compact(v, L, cap, codes, Wmax),
            lambda: plain_rows(v, L, cap, codes, Wmax), reps=reps, plain_reps=plain_reps)
        c = slens.shape[0]
        sidx = out[:c, 0]
        _, err3, ms3, pms3 = _timed_pair(
            f"survivor_rows ({label})", lambda: tf.survivor_rows(codes, sidx, Wmax),
            lambda: tf.survivor_rows_plain(codes, sidx, Wmax), exp=rows, reps=reps,
            plain_reps=plain_reps)
        S = int(out[cap, 0])
        say("3 kernels", kernel="fused_glue", batch=label, lanes=len(bufs),
            lane_rows=",".join(str(b.shape[0]) for b in bufs), N=N, N_mod_32=N % 32,
            tiles=-(-N // tile), N_mod_tile=N % tile, exceptions=exc.shape[0],
            pad_entries=int((exc[:, 0] >= N).sum()), negative_cols=int((exc[:, 1] < 0).sum()),
            cap=cap, survivors=S, rows_placed=c, lanes_codes_ms=f"{ms1:.4f}",
            lanes_codes_plain_ms=f"{pms1:.4f}", compact_with_rows_ms=f"{ms2:.4f}",
            compact_with_rows_plain_ms=f"{pms2:.4f}", survivor_rows_ms=f"{ms3:.4f}",
            survivor_rows_plain_ms=f"{pms3:.4f}", equal=True,
            max_abs_err=max(err1, err2, err3))
        return dict(bufs=bufs, widths=widths, exc=exc, codes=codes, v=v, L=L, cap=cap, out=out,
                    slens=slens, gp=gp, okw=okw, sidx=sidx, rows=rows, S=S, c=c, N=N,
                    err=max(err1, err2, err3), ms=(ms1, ms2, ms3), pms=(pms1, pms2, pms3))

    widths = list(sh["widths"])
    bufs = [b.to(dev) for b in sh["bufs_d"]]
    lens = [n.to(dev) for n in torch.split(sh["lens_d"], [b.shape[0] for b in bufs])]
    exc = sh["exc_d"].to(dev)
    offs = sh["offs"][: len(bufs)]
    real = run(bufs, widths, lens, exc, SURVIVOR_CAP, f"first {BATCH} pairs", 20, 3)
    data["glue_batches"].append(("first batch", real["v"], real["L"], SURVIVOR_CAP,
                                 real["codes"]))

    # (ii) the edge batches, built from the same lanes
    def cut_lanes(cut):
        """The lanes cut to `cut` rows each, their exceptions moved with
        them (the others to a row past every lane: dropped)."""
        eoffs = [sum(cut[:i]) for i in range(len(cut))]
        x = exc.long()
        new_row = torch.full_like(x[:, 0], sum(cut) + 1)
        for o, eo, n in zip(offs, eoffs, cut):
            inside = (x[:, 0] >= o) & (x[:, 0] < o + n)
            new_row = torch.where(inside, x[:, 0] - o + eo, new_row)
        x = torch.stack([new_row, x[:, 1]], 1)
        return ([b[:n].contiguous() for b, n in zip(bufs, cut)],
                [ln[:n].contiguous() for ln, n in zip(lens, cut)], x, eoffs)

    cut = [max(1, b.shape[0] - k) for b, k in zip(bufs, (7, 3, 13))]
    ebufs, elens, x, eoffs = cut_lanes(cut)
    rng = np.random.default_rng(data["seed"])
    extra = []
    for eo, n, W in zip(eoffs, cut, widths):
        for r in rng.choice(n, min(n, 64), replace=False).tolist():
            extra += [(eo + r, col) for col in (-1, -W, -W - 1)]
        for r in rng.choice(n, min(n, 16), replace=False).tolist():
            extra += [(eo + r, j - W) for j in range(24)]
    eexc = torch.cat([x.cpu(), torch.tensor(extra, dtype=torch.int64)]).to(torch.int32).to(dev)
    ecap = max(1, real["S"] // 2)
    edge = run(ebufs, widths, elens, eexc, ecap, "edge")
    check(edge["N"] % 32 and edge["S"] > ecap, "the edge batch is not an edge case")
    edges = [edge]
    # N a multiple of the tile (cap past N: c spans every tile), and a tile
    # -1 and +1, cut from the first lane
    k = real["N"] // tile
    for extra_rows, cap, label in ((0, k * tile + 7, "N = k tiles, cap N + 7"),
                                   (-1, SURVIVOR_CAP, "N = k tiles - 1"),
                                   (1, SURVIVOR_CAP, "N = k tiles + 1")):
        drop = real["N"] - k * tile - extra_rows
        tb, tl, tx, _ = cut_lanes([bufs[0].shape[0] - drop] + [b.shape[0] for b in bufs[1:]])
        e = run(tb, widths, tl, tx.to(torch.int32).contiguous(), cap, label)
        check(e["N"] % tile == extra_rows % tile and (cap < e["N"] or e["c"] == e["N"] > tile),
              f"the batch '{label}' is not the edge case it names")
        edges.append(e)
        data["glue_batches"].append((label, e["v"], e["L"], cap, e["codes"]))
    # exceptions that are the engine's pad entries only (row N)
    pad = torch.tensor([[real["N"], max(widths)]] * 32, dtype=torch.int32, device=dev)
    e = run(bufs, widths, lens, pad, SURVIVOR_CAP, "pad entries only")
    check(e["N"] == real["N"], "the pad-only batch changed its lanes")
    edges.append(e)
    # cap 0: no row is placed, so the place launch copies none (its rows
    # tensor is empty)
    e = run(bufs, widths, lens, exc, 0, "cap 0")
    check(e["c"] == 0 and e["rows"].shape == (0, max(widths)), "cap 0 placed rows")
    edges.append(e)
    # more lanes than one unpack or place launch takes: each lane in 4 row
    # ranges (the concatenated row space, so the exceptions, stay as they
    # are)
    mbufs, mwidths, mlens = [], [], []
    for b, ln, W in zip(bufs, lens, widths):
        cuts = np.linspace(0, b.shape[0], 5).astype(int).tolist()
        for lo, hi in zip(cuts, cuts[1:]):
            mbufs.append(b[lo:hi].contiguous())
            mlens.append(ln[lo:hi].contiguous())
            mwidths.append(W)
    check(len(mbufs) > cuda.MAX_LANES, "the split batch fits one unpack launch")
    e = run(mbufs, mwidths, mlens, exc, SURVIVOR_CAP, f"{len(mbufs)} lanes")
    check(torch.equal(e["out"], real["out"]) and torch.equal(e["rows"], real["rows"]),
          "the split lanes' compaction differs from the batch's")
    edges.append(e)
    # survivor_rows' path: the 12 lanes through fused_scan_lanes, equal to
    # the batch's 3 (the same rows in the same order)
    scan3 = tf.fused_scan_lanes(bufs, torch.cat(lens), exc, index, widths=widths,
                                cap=SURVIVOR_CAP)
    cuda.reset_launches()
    scan12 = tf.fused_scan_lanes(mbufs, torch.cat(mlens), exc, index, widths=mwidths,
                                 cap=SURVIVOR_CAP)
    torch.cuda.synchronize()
    rows_path = dict(cuda.LAUNCHES)
    check(all(torch.equal(a, b) for a, b in zip(scan12, scan3)),
          "fused_scan_lanes over 12 lanes differs from the same rows in 3")
    check(rows_path["survivor_rows"] == 1 and rows_path["compact_place"] == 1,
          f"12 lanes: {rows_path['survivor_rows']} survivor_rows launches (1 expected)")
    data["rows_path_launches"] = rows_path
    say("3 kernels", kernel="survivor_rows", path=f"fused_scan_lanes, {len(mbufs)} lanes",
        launches=json.dumps({k: rows_path[k] for k in SCAN_KERNELS + ("survivor_rows",)},
                            separators=(",", ":")), equal_to_3_lanes=True)

    # each kernel alone on (i)'s inputs, beside the plain version of its step
    outs = [torch.empty((b.shape[0], W), dtype=torch.uint8, device=dev)
            for b, W in zip(bufs, widths)]
    unpacked = [unpack_seq2(b, W).contiguous() for b, W in zip(bufs, widths)]

    def unpack():
        cuda.launch_lanes_unpack(bufs, widths, offs, outs)
        return outs

    def exceptions():
        cuda.launch_lane_exceptions(bufs, widths, offs, outs, exc)
        return outs

    one = {}
    one["lane_unpack"] = _timed_pair(
        "lane_unpack", unpack, lambda: [unpack_seq2(b, W).contiguous()
                                        for b, W in zip(bufs, widths)])
    one["lane_exceptions"] = _timed_pair(
        "lane_exceptions", exceptions, lambda: [tf.lane_exceptions_plain(u, exc, o)
                                                for u, o in zip(unpacked, offs)])
    v, L, N, c, codes = real["v"], real["L"], real["N"], real["c"], real["codes"]
    Wmax = max(widths)
    okw = torch.empty((N + 31) // 32, dtype=torch.int32, device=dev)
    tcnt = torch.empty(-(-N // tile), dtype=torch.int32, device=dev)
    out = torch.empty_like(real["out"])
    slens = torch.empty(c, dtype=torch.int32, device=dev)
    gp = torch.empty((c, 4), dtype=torch.int32, device=dev)
    rows = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)

    def count():
        cuda.launch_compact_count(v, okw, tcnt)
        return okw, tcnt

    def place():
        cuda.launch_compact_place(v, L, SURVIVOR_CAP, okw, tcnt, out, slens, gp, codes, offs,
                                  rows)
        return out, slens, gp, rows

    one["compact_count"] = _timed_pair("compact_count", count,
                                       lambda: tf.compact_count_plain(v, tile))
    # the plain version of the place step is the whole compaction's (it
    # also builds the bitmap) with the survivor rows'
    one["compact_place"] = _timed_pair(
        "compact_place", place,
        lambda: (lambda p: p[:3] + p[4:])(plain_rows(v, L, SURVIVOR_CAP, codes, Wmax)))
    # the parent design on the same inputs (another checkout's build)
    before = {}
    if data.get("glue_baseline"):
        before = glue_baseline(data["glue_baseline"], real)

    # the bounds, at (i)'s inputs: the unpack reads the 2-bit rows and
    # writes the codes; the exceptions read the list and write the entries
    # that land; the count reads the vote rows (their gate column spans
    # every sector) and writes the words and the tile counts; the place
    # step reads those, the placed rows' lengths, keys and code rows (each
    # at its lane's width) and writes `out`, slens, gp and the (c, Wmax)
    # code rows; survivor_rows reads the sidx column and the same code rows
    # and writes the same (c, Wmax) rows
    r, col = exc[:, 0].long(), exc[:, 1].long()
    landed = 0
    for o, b, W in zip(offs, bufs, widths):
        cc = torch.where(col < 0, col + W, col)
        landed += int(((r >= o) & (r < o + b.shape[0]) & (cc >= 0) & (cc < W)).sum())
    codes_bytes = sum(ci.numel() for ci in codes)
    lane_w = torch.tensor([W for W, b in zip(widths, bufs) for _ in range(b.shape[0])],
                          device=dev)
    rows_bytes = int(lane_w[real["sidx"].long()].sum()) + real["rows"].numel()
    nbytes = dict(
        lane_unpack=sum(b.numel() for b in bufs) + codes_bytes,
        lane_exceptions=exc.numel() * 4 + landed,
        compact_count=v.numel() * 4 + okw.numel() * 4 + tcnt.numel() * 4,
        compact_place=(okw.numel() * 4 + tcnt.numel() * 4 + c * 20 + out.numel() * 4 + c * 4
                       + c * 16 + rows_bytes),
        survivor_rows=c * 4 + rows_bytes)
    pair_bytes = dict(lane_unpack=sum(b.numel() for b in bufs) + exc.numel() * 4 + codes_bytes,
                      compact=v.numel() * 4 + c * 4 + out.numel() * 4 + c * 4 + c * 16
                      + okw.numel() * 4 + rows_bytes)
    # the library calls: the compaction's argsort of its keys alone; the
    # survivor rows' index_select from the whole (N, Wmax) matrix of the
    # lanes, built beforehand, and the same with the matrix's build
    ok = v[:, 0] != 0
    iota = torch.arange(N, device=dev)
    keys = torch.where(ok, iota, N + iota)
    lib_sort = event_ms(lambda: torch.argsort(keys), 20)
    sidx64 = real["sidx"].long()

    def padded_matrix():
        m = torch.full((N, Wmax), 255, dtype=torch.uint8, device=dev)
        at = 0
        for ci in codes:
            m[at : at + ci.shape[0], : ci.shape[1]] = ci
            at += ci.shape[0]
        return m

    allcodes = padded_matrix()
    lib_select = event_ms(lambda: torch.index_select(allcodes, 0, sidx64), 20)
    lib_build_select = event_ms(lambda: torch.index_select(padded_matrix(), 0, sidx64), 20)
    lanes_shape = " + ".join(f"{b.shape[0]}x{W}" for b, W in zip(bufs, widths))
    shapes = dict(
        lane_unpack=f"{len(bufs)} lanes ({lanes_shape} codes), one launch",
        lane_exceptions=f"{exc.shape[0]} exceptions, {landed} in the lanes, one launch",
        compact_count=f"N {N} vote rows, {tcnt.numel()} tiles of {tile}",
        compact_place=f"N {N}, cap {SURVIVOR_CAP}, {real['S']} survivors, {c} code rows of "
                      f"width {Wmax} copied",
        survivor_rows=f"{c} rows of width {Wmax} from {len(bufs)} lanes, alone (the scan's "
                      f"are the place launch's)")
    pairs = dict(lane_unpack=("lane_unpack", "lane_exceptions", 0),
                 compact=("compact_count", "compact_place", 1))
    rec = {}
    for name in GLUE_KERNELS:
        if name == "survivor_rows":
            err, ms, pms = real["err"], real["ms"][2], real["pms"][2]
        else:
            _, err, ms, pms = one[name]
        rec[name] = dict(err=max(err, max(e["err"] for e in edges)), ms=ms, plain_ms=pms,
                         library_ms=lib_select if name == "survivor_rows" else None,
                         shape=shapes[name], **bound(nbytes[name], 0))
        if name == "survivor_rows":
            rec[name].update(edge_ms=round(edge["ms"][2], 6),
                             library_with_build_ms=round(lib_build_select, 6))
    for pair, (first, second, k) in pairs.items():
        pb = bound(pair_bytes[pair], 0)
        rec[first]["pair"] = dict(
            kernels=f"{first}+{second}", ms=round(real["ms"][k], 6),
            plain_ms=round(real["pms"][k], 6), bound_ms=round(pb["bound_ms"], 6),
            edge_ms=round(edge["ms"][k], 6),
            before_ms=None if pair not in before else round(before[pair], 6),
            library_ms=None if pair == "lane_unpack" else round(lib_sort, 6))
        say("3 kernels", pair=pair, kernels=f"{first}+{second}", ms=f"{real['ms'][k]:.4f}",
            plain_ms=f"{real['pms'][k]:.4f}", bound_ms=f"{pb['bound_ms']:.5f}",
            bound_share=f"{pb['bound_ms'] / real['ms'][k]:.4f}",
            before_ms="null" if pair not in before else f"{before[pair]:.4f}",
            library_ms="null" if pair == "lane_unpack" else f"{lib_sort:.4f}")
    for name in GLUE_KERNELS:
        say("3 kernels", kernel=name, ms=f"{rec[name]['ms']:.4f}",
            plain_ms=f"{rec[name]['plain_ms']:.4f}", bound_ms=f"{rec[name]['bound_ms']:.5f}",
            bound_by=rec[name]["bound_by"], bytes=rec[name]["bytes"],
            library_ms="null" if rec[name]["library_ms"] is None
            else f"{rec[name]['library_ms']:.4f}",
            **({"library_with_build_ms": f"{lib_build_select:.4f}"}
               if name == "survivor_rows" else {}),
            max_abs_err=rec[name]["err"])
    return rec


def glue_baseline(csrc: str, real: dict) -> dict:
    """Another checkout's glue (the parent's), built from its csrc/, on the
    inputs of phase 3's batch: its unpack and exceptions, and its
    compaction with the survivors' code rows, count then place (the place
    launch copying the rows of the first cuda.MAX_LANES lanes:
    `gf_compact_place`'s 17 arguments), through this checkout's wrappers
    with that build; each bit-equal to plain, timed -> {"lane_unpack": ms,
    "compact": ms} for the batch."""
    import torch

    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import fused as tf

    lib = cuda.load(cuda.build(("fused_glue.cu",), csrc=os.path.abspath(csrc)))
    bufs, widths, exc, codes = real["bufs"], real["widths"], real["exc"], real["codes"]
    v, L, cap, N, c = real["v"], real["L"], real["cap"], real["N"], real["c"]
    check(len(codes) <= cuda.MAX_LANES, f"the baseline places at most {cuda.MAX_LANES} lanes")
    Wmax = max(widths)
    dev = v.device
    offs = [sum(b.shape[0] for b in bufs[:i]) for i in range(len(bufs))]

    def unpack():
        outs = [torch.empty((b.shape[0], W), dtype=torch.uint8, device=dev)
                for b, W in zip(bufs, widths)]
        cuda.launch_lanes_unpack(bufs, widths, offs, outs, lib=lib)
        cuda.launch_lane_exceptions(bufs, widths, offs, outs, exc, lib=lib)
        return outs

    def compact_rows():
        out = torch.empty((cap + 1, 13), dtype=torch.int32, device=dev)
        slens = torch.empty(c, dtype=torch.int32, device=dev)
        gp = torch.empty((c, 4), dtype=torch.int32, device=dev)
        okw = torch.empty((N + 31) // 32, dtype=torch.int32, device=dev)
        tcnt = torch.empty(-(-N // cuda.compact_tile(lib)), dtype=torch.int32, device=dev)
        rows = torch.empty((c, Wmax), dtype=torch.uint8, device=dev)
        cuda.launch_compact_count(v, okw, tcnt, lib=lib)
        cuda.launch_compact_place(v, L, cap, okw, tcnt, out, slens, gp, codes, offs, rows,
                                  lib=lib)
        return out, slens, gp, okw, rows

    exp = tuple(real[k] for k in ("out", "slens", "gp", "okw", "rows"))
    ms1 = parent_ms("lane_unpack (baseline)", unpack,
                    tuple(tf.lanes_codes_plain(bufs, widths, exc)), 20)
    ms2 = parent_ms("compact with rows (baseline)", compact_rows, exp, 20)
    say("3 kernels", baseline=csrc, lane_unpack_ms=f"{ms1:.4f}",
        compact_with_rows_ms=f"{ms2:.4f}", equal=True)
    return {"lane_unpack": ms1, "compact": ms2}


def sweep_glue(data: dict, reps: int = 40) -> dict:
    """The compaction's tile (GLUE_COMPACT_TILE) swept over
    GLUE_SWEEP_TILES, each a build of csrc/fused_glue.cu, on phase 3's
    first batch and its tile edges: count + place with the code rows
    bit-equal to plain, then timed -> {batch label: {tile: ms}}."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import fused as tf
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(GLUE_SWEEP_TILES)) as ex:
        paths = list(ex.map(lambda t: cuda.build(("fused_glue.cu",), (f"GLUE_COMPACT_TILE={t}",)),
                            GLUE_SWEEP_TILES))
    say("3 kernels", kernel="compact", sweep_builds=len(paths),
        build_s=f"{time.perf_counter() - t0:.1f}")
    res = {}
    for label, v, L, cap, codes in data["glue_batches"]:
        Wmax = max(ci.shape[1] for ci in codes)
        offs = [sum(ci.shape[0] for ci in codes[:k]) for k in range(len(codes))]
        exp = tf.compact_plain(v, L, cap)
        exp = (*exp, tf.survivor_rows_plain(codes, exp[0][: exp[1].shape[0], 0], Wmax))
        res[label] = {}
        for T, path in zip(GLUE_SWEEP_TILES, paths):
            lib = cuda.load(path)
            check(cuda.compact_tile(lib) == T, f"the build for tile {T} has another tile")
            N, c = v.shape[0], min(cap, v.shape[0])

            def run():
                out = torch.empty((cap + 1, 13), dtype=torch.int32, device=v.device)
                slens = torch.empty(c, dtype=torch.int32, device=v.device)
                gp = torch.empty((c, 4), dtype=torch.int32, device=v.device)
                okw = torch.empty((N + 31) // 32, dtype=torch.int32, device=v.device)
                tcnt = torch.empty(-(-N // T), dtype=torch.int32, device=v.device)
                rows = torch.empty((c, Wmax), dtype=torch.uint8, device=v.device)
                cuda.launch_compact_count(v, okw, tcnt, lib=lib)
                cuda.launch_compact_place(v, L, cap, okw, tcnt, out, slens, gp, codes, offs, rows,
                                          lib=lib)
                return out, slens, gp, okw, rows

            got = run()
            check(all(torch.equal(g, e) for g, e in zip(got, exp)),
                  f"compact with tile {T} differs from plain ({label})")
            res[label][T] = event_ms(run, reps)
    return res


def probe_row_loads(codes, lens, index, exp, stride=None, sectors=False):
    """One launch of the probe of a batch on `index`'s table (default
    stride: pass 1's) with the kernel's row counter on, held bit-equal to
    `exp` -> the table rows it loaded; with `sectors` (single-probe
    tables) -> (rows, the 32-byte sectors it requested)."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import cuda

    B, W = codes.shape
    NQ = exp.shape[1]
    out = torch.empty_like(exp)
    loads = torch.zeros(2, dtype=torch.int64, device=exp.device)
    cuda.launch_probe(codes, lens, None, None, B * NQ, W, stride or PASS1_STEP, NQ, index, out,
                      row_loads=loads[:1], sector_loads=loads[1:] if sectors else None)
    check(torch.equal(out, exp), "probe with its row counter differs from plain")
    rows, secs = loads.tolist()
    return (rows, secs) if sectors else rows


def sweep_probe(codes, lens, index, exp, reps=40) -> dict:
    """The kv2 probe of phase 3's batch at every launch shape of the sweep
    (queries a thread x row cache policy x block size), each a build of
    csrc/probe.cu with -D overrides, all built at once, each held
    bit-equal to `exp` -> {"q,policy,threads": mean ms}."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    shapes = [(q, pol, t) for q in PROBE_SWEEP_Q for pol in range(len(PROBE_POLICIES))
              for t in PROBE_SWEEP_THREADS]

    def build(shape):
        q, pol, t = shape
        return cuda.build(("probe.cu",), (f"PROBE_Q={q}", f"PROBE_POLICY={pol}",
                                          f"PROBE_THREADS={t}"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        paths = list(ex.map(build, shapes))
    say("3 kernels", kernel="probe", sweep_builds=len(paths),
        build_s=f"{time.perf_counter() - t0:.1f}")
    B, W = codes.shape
    NQ = exp.shape[1]
    out = torch.empty_like(exp)
    res = {}
    for (q, pol, t), path in zip(shapes, paths):
        lib = cuda.load(path)

        def run():
            cuda.launch_probe(codes, lens, None, None, B * NQ, W, PASS1_STEP, NQ, index, out,
                              lib=lib)

        out.fill_(0)
        run()
        torch.cuda.synchronize()
        check(torch.equal(out, exp), f"probe at shape {(q, pol, t)} differs from plain")
        res[f"{q},{PROBE_POLICIES[pol]},{t}"] = event_ms(run, reps)
    return res


def sweep_probe_single(data: dict, reps=20) -> dict:
    """The single-probe variant on phase 3's batch (stride 2) on the
    panel's kvs and kv16 tables at every launch shape of SINGLE_SWEEP_Q x
    SINGLE_SWEEP_THREADS, each a build of csrc/probe.cu with -D overrides,
    all built at once, each held bit-equal to plain -> {layout: {"q,threads":
    [mean ms, registers]}}."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.index import build_packed_index, index_to_torch, layout_name
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    shapes = [(q, t) for q in SINGLE_SWEEP_Q for t in SINGLE_SWEEP_THREADS]

    def build(shape):
        q, t = shape
        return cuda.build(("probe.cu",), (f"PROBE_SINGLE_Q={q}", f"PROBE_SINGLE_THREADS={t}"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        paths = list(ex.map(build, shapes))
    say("15 layouts", kernel="probe_single", sweep_builds=len(paths),
        build_s=f"{time.perf_counter() - t0:.1f}")
    codes, lens = data["probe_codes"]
    B, W = codes.shape
    res = {}
    for layout, S in (("kvs", 4), ("kv16", 8)):
        packed = build_packed_index(data["mapper"].indexer, layout)
        check(layout_name(packed) == layout, f"sweep: the {layout} pack fell through")
        index = index_to_torch(packed, torch.device("cuda"))
        del packed
        exp = tm.probe_plain(codes, lens, PASS1_STEP, index)
        NQ = exp.shape[1]
        out = torch.empty_like(exp)
        res[layout] = {}
        for (q, t), path in zip(shapes, paths):
            lib = cuda.load(path)

            def run():
                cuda.launch_probe(codes, lens, None, None, B * NQ, W, PASS1_STEP, NQ, index,
                                  out, lib=lib)

            out.fill_(0)
            run()
            torch.cuda.synchronize()
            check(torch.equal(out, exp), f"probe_{layout} at shape {(q, t)} differs from plain")
            regs = [n for k, n in variant_registers("probe_single_kernel", path).items()
                    if k.startswith(f"_ZN2gf19probe_single_kernelILi{S}E")]
            res[layout][f"{q},{t}"] = [round(event_ms(run, reps), 4), regs[0] if regs else None]
        del index, exp, out
        torch.cuda.empty_cache()
    return res


def probe_gather_rows(pb) -> dict:
    """Phase 3's batch (stride 2) on the kv2 table, in query order, as
    gather rows: (a1) h1 and h2 of every valid k-mer, what a probe that
    loads both rows reads; (a2) the rows the lookup needs, h1 of every
    valid k-mer and h2 only where the key is not in h1. The last tile is
    topped up with the first rows -> {case: (indices, rows)}."""
    import torch

    from genefuserust_tpu_torch.profiling import gather_floor as gf

    r = pb["rows"]
    h2 = torch.where(r["in_h1_mask"], -1, r["b2"])
    out = {}
    for case, pairs in (("a1 both rows", torch.stack([r["b1"], r["b2"]], 1)),
                        ("a2 rows needed", torch.stack([r["b1"], h2], 1))):
        rows = pairs.reshape(-1)
        rows = rows[rows >= 0].to(torch.int32)
        n_rows = rows.shape[0]
        check(n_rows == (2 * r["valid"] if case[:2] == "a1" else r["rows"]),
              f"gather ({case}): row count differs from phase 3's")
        out[case] = torch.cat([rows, rows[: (-n_rows) % gf.TILE]]).contiguous(), n_rows
    return out


def sweep_gather(data: dict, reps=40) -> dict:
    """The gather at every launch shape of the sweep (blocks a tile x row
    loads a thread), each a build of csrc/gather_sum.cu with -D overrides,
    all built at once, each held bit-equal to the plain version: the narrow
    rows' shape at (a2), the wide rows' at (b) and the wider rows ->
    {case: {"blocks,loads": mean ms}}."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.profiling import gather_floor as gf
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    shapes = {kind: [(f"{c},{u}", (f"GATHER_{kind}_BLOCKS={c}", f"GATHER_{kind}_LOADS={u}"))
                     for c in GATHER_SWEEP_BLOCKS for u in GATHER_SWEEP_LOADS]
              for kind in ("NARROW", "WIDE")}
    builds = [d for kind in shapes.values() for _, d in kind]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        paths = dict(zip(builds, ex.map(lambda d: cuda.build(("gather_sum.cu",), d), builds)))
    say("8 gather", sweep_builds=len(paths), build_s=f"{time.perf_counter() - t0:.1f}")
    pb = data["probe_batch"]
    inputs = {"a2": ("NARROW", lambda: (probe_gather_rows(pb)["a2 rows needed"][0],
                                        pb["index"].table))}
    for w in GATHER_SWEEP_WIDTHS:  # (b), as phase 8 makes it, at W 128
        inputs["b" if w == 128 else f"W {w}"] = ("WIDE", lambda w=w: gf.random_inputs(
            GATHER_SWEEP_TABLE_BYTES // (4 * w), w, 1 << 17, seed=1))
    res = {}
    for case, (kind, make) in inputs.items():
        idx, tbl = make()
        exp = gf.tile_row_sums(idx, tbl)
        out = torch.empty_like(exp)
        res[case] = {}
        for name, defines in shapes[kind]:
            lib = cuda.load(paths[defines])

            def run():
                cuda.launch_gather_tile_sums(idx, tbl, 1, out, lib=lib)

            out.fill_(0)
            run()
            torch.cuda.synchronize()
            check(torch.equal(out, exp), f"gather ({case}) at shape {name} differs from plain")
            res[case][name] = event_ms(run, reps)
        del idx, tbl, exp, out
        torch.cuda.empty_cache()
    return res


def phase_golden(data: dict) -> None:
    import torch

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.scanner import Scanner
    from genefuserust_tpu_torch.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    gdir = os.path.join(REPO, "tests", "goldens")
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "genefuserust_tpu_torch", "build")) as td:
        panel = make_panel(seed=33)
        pairs = plant_fusion_pairs(panel, n_support=7, n_background=80, seed=9)
        _, csv = write_panel_files(panel, td)
        for cap in (1024, 2):
            eng = TorchEngine(Settings(), batch_size=64, device="cuda")
            eng._surv_cap = cap
            h, j = os.path.join(td, "g.html"), os.path.join(td, "g.json")
            with quiet(data):
                Scanner(csv, panel.contigs, h, j, Settings(), engine=eng,
                        command="golden-run").scan_pairs(pairs)
            torch.cuda.synchronize()
            check(_TS.sub("<ts>", open(j).read()) == open(os.path.join(gdir, "planted.json")).read(),
                  f"golden JSON differs (cap {cap})")
            check(_TS.sub("<ts>", open(h).read()) == open(os.path.join(gdir, "planted.html")).read(),
                  f"golden HTML differs (cap {cap})")
            say("4 golden", cap=cap, json="equal", html="equal",
                ed_jobs=eng.ed_stats["jobs"])


def phase_cli(data: dict, smi_line: str) -> dict:
    import torch

    from genefuserust_tpu_torch import native
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.ops import cuda

    check(native.available(), "the native host library did not build")
    wd = data["workdir"]
    b1, q1, _, b2, q2, _ = data["block"]
    r1, r2 = os.path.join(wd, "R1.fq"), os.path.join(wd, "R2.fq")
    write_fastq(r1, b1, q1, "p")
    write_fastq(r2, b2, q2, "p")
    data["r1"], data["r2"] = r1, r2
    html, js = os.path.join(wd, "out.html"), os.path.join(wd, "out.json")
    # the engine's opt-in wall-time split of host stages (TorchEngine._timed)
    os.environ["GENEFUSE_STAGE_TIMERS"] = "1"
    cuda.reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), captured_flushes() as flushes:
        engine = cli.run(["-1", r1, "-2", r2, "-f", data["csv"], "-r", data["fa"],
                          "-h", html, "-j", js])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    data["log"].write(out.getvalue())
    launches = dict(cuda.LAUNCHES)
    data["cli_reports"] = (_TS.sub("<ts>", open(html).read()), strip_json(open(js).read()))
    data["cli_stdout"] = strip_stdout(out.getvalue())
    data["cli_wall_s"], data["cli_launches"] = wall, launches
    n_fusions = len(json.load(open(js))["fusions"])
    for k in SCAN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the CLI run")
    # the engine's 3 lanes: the place launch copies the survivors' rows
    check(launches["survivor_rows"] == 0,
          f"the CLI run launched survivor_rows {launches['survivor_rows']} times (0 expected)")
    check(n_fusions >= 1, "the CLI run reported no fusion")
    # a cold job: its wall time holds the host build and upload of the kv2
    # table, which phase 3 already paid once for the same panel
    index_s = engine.table_seconds
    say("5 cli", pairs=len(b1), wall_s=f"{wall:.2f}", index_s=f"{index_s:.2f}",
        index_share=f"{index_s / wall:.3f}",
        cold_job_pairs_per_s_incl_index=f"{len(b1) / wall:.0f}",
        pairs_per_s_excl_index=f"{len(b1) / (wall - index_s):.0f}",
        fusions=n_fusions, launches=json.dumps(launches, separators=(",", ":")),
        ed_jobs=engine.ed_stats["jobs"],
        ed_jobs_in_device_sized_batches=engine.ed_stats["device_sized"],
        ed_jobs_batched=engine.ed_stats["device"],
        host_stage_s=json.dumps({k: round(v[0], 3) for k, v in engine._timers.items()},
                                separators=(",", ":")),
        card=repr(smi_line))
    ed = check_flushes("cli", flushes)
    data["ed_flushes"] = flushes
    data["ed_err"] = ed["err"]
    say("5 cli", ed_flush_sizes=ed["flush_sizes"], checked_flushes=ed["checked_flushes"],
        checked_jobs=ed["checked_jobs"],
        jobs_W_Lt=json.dumps(ed["batch_W_Lt"], separators=(",", ":")),
        kernel_vs_plain="equal", kernel_vs_host="equal", max_abs_err=ed["err"])
    # the Myers kernel at the main path's own shapes
    data["ed_main"] = time_flushes(ed["encoded"])
    for r in data["ed_main"]:
        say("5 cli", kernel="edit_distance", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                                 for k, v in r.items()})
    return launches


def phase_oracle(data: dict) -> None:
    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu_torch.core.scanner import HostEngine, Scanner
    from genefuserust_tpu_torch.ops.index import build_packed_index
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    b1, q1, _, b2, q2, _ = (a[:ORACLE_PAIRS] for a in data["block"])

    def read(name, s, q):
        return SequenceRead(name, s.tobytes().decode(), "+", q.tobytes().decode())

    pairs = [SequenceReadPair(read(f"@p{i:08d}", b1[i], q1[i]), read(f"@p{i:08d}", b2[i], q2[i]))
             for i in range(ORACLE_PAIRS)]
    data["oracle_pairs"] = pairs
    contigs = data["mapper"].contigs

    def scan(engine, name):
        j = os.path.join(data["workdir"], name)
        with quiet(data):
            mapper = Scanner(data["csv"], contigs, "", j, Settings(), engine=engine,
                             command="oracle").scan_pairs(pairs)
        return strip_json(open(j).read()), mapper

    t0 = time.perf_counter()
    host, m_host = scan(HostEngine(), "host.json")
    host_s = time.perf_counter() - t0
    data["oracle_host_json"] = host
    for layout in ("kv2", "split"):
        eng = TorchEngine(Settings(), device="cuda")
        eng.use_packed(data["packed_kv2"] if layout == "kv2" else
                       build_packed_index(data["mapper"].indexer, layout="split"))
        got, m = scan(eng, f"{layout}.json")
        check(got == host, f"TorchEngine ({layout}) JSON differs from the host oracle's")
        kind = "kv" if hasattr(eng._tables[id(m)]["packed"], "kv_tbl") else "split"
        check(kind == ("kv" if layout == "kv2" else "split"), f"{layout} table not used")
        say("6 oracle", layout=layout, pairs=ORACLE_PAIRS, json="equal",
            fusions=len(m.fusion_results), host_s=f"{host_s:.1f}")


def _device_kind(name: str) -> str:
    for kernel, sym in (("probe", "probe_kernel"), ("vote", "vote_kernel"),
                        ("mask_segments", "mask_segments_kernel"),
                        ("gather_sum", "gather_tile_sums_kernel"),
                        ("edit_distance", "edit_distance_kernel"),
                        ("lane_unpack", "lanes_unpack_kernel"),
                        ("lane_exceptions", "lane_exceptions_kernel"),
                        ("compact_count", "compact_count_kernel"),
                        ("compact_place", "compact_place_kernel"),
                        ("survivor_rows", "survivor_rows_kernel"),
                        # the one-launch-a-lane unpack and one-block
                        # compaction of a checkout before the batched ones
                        # (--profile-only beside another checkout)
                        ("lane_unpack", "lane_unpack_kernel"), ("compact", "compact_kernel")):
        if sym in name:
            return kernel
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    return "torch_other"


def phase_profile(data: dict) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    mapper, blk = data["mapper"], data["blk"]
    eng = TorchEngine(Settings(), device="cuda")
    eng.use_packed(data["packed_kv2"], mapper=mapper)

    def scan() -> float:
        t0 = time.perf_counter()
        eng.scan_pair_block(mapper, blk)
        eng.flush(mapper)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    scan()  # the engine's first batches: pinned buffers, streams, allocator
    warm = [scan() for _ in range(2)]
    data["warm_1"] = warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_s = scan()
    spans, by_kind, other = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            kind = _device_kind(e.name)
            us = e.time_range.elapsed_us()
            by_kind[kind] = by_kind.get(kind, 0.0) + us
            if kind == "torch_other":
                n, t = other.get(e.name, (0, 0.0))
                other[e.name] = (n + 1, t + us)
    check(spans, "the profiler saw no device activity in the warm scan")
    # busy = the union of device intervals (the upload stream may overlap)
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    say("7 profile", pairs=len(blk.left.seq),
        warm_scan_s=",".join(f"{w:.3f}" for w in warm), profiled_scan_s=f"{prof_s:.3f}",
        device_events=len(spans), device_busy_ms=f"{busy_us / 1e3:.2f}",
        device_busy_share=f"{busy_us / 1e6 / prof_s:.4f}",
        device_ms=json.dumps({k: round(v / 1e3, 3) for k, v in
                              sorted(by_kind.items(), key=lambda kv: -kv[1])},
                             separators=(",", ":")))
    glue = sum(by_kind.get(k, 0.0) for k in (*GLUE_KERNELS, "compact"))
    say("7 profile", glue_kernels=",".join(k for k in (*GLUE_KERNELS, "compact") if k in by_kind),
        glue_ms=f"{glue / 1e3:.4f}", glue_share_of_busy=f"{glue / busy_us:.4f}")
    # the largest of torch's own ops: [name (its first 100 characters),
    # launches, device ms]
    top = sorted(other.items(), key=lambda kv: -kv[1][1])[:5]
    say("7 profile", torch_other_top5=json.dumps(
        [[name[:100], n, round(us / 1e3, 4)] for name, (n, us) in top], separators=(",", ":")))


def phase_gather(data: dict) -> dict:
    import torch

    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.profiling import gather_floor as gf

    # (a) phase 3's batch (stride 2) on the kv2 table, in query order: (a1)
    # h1 and h2 of every valid k-mer, what a probe that loads both rows
    # reads; (a2) the rows the lookup needs, h1 of every valid k-mer and h2
    # only where the key is not in h1. The last tile is topped up with the
    # first rows.
    pb = data.pop("probe_batch")
    r = pb["rows"]
    tbl = pb["index"].table
    for case, (rows, n_rows) in probe_gather_rows(pb).items():
        a = gf.measure(rows, tbl)
        say("8 gather", case=case, table=tuple(tbl.shape), rows=n_rows,
            valid_kmers=r["valid"], tiles=rows.shape[0] // gf.TILE, floor_ms=f"{a['ms']:.4f}",
            plain_ms=f"{a['plain_ms']:.4f}", probe_ms=f"{pb['ms']:.4f}",
            floor_over_probe=f"{a['ms'] / pb['ms']:.4f}",
            ns_per_row=f"{a['ns_per_row']:.4f}", rows_per_s=f"{a['rows_per_s']:.4g}",
            requested_GBps=f"{a['requested_bytes_per_s'] / 1e9:.2f}",
            sector_GBps=f"{a['sector_bytes_per_s'] / 1e9:.2f}", max_abs_err=a["max_abs_err"])
    del pb, r, rows, tbl
    # (b), (c): the entry point at the TPU kernels' shapes, on the card;
    # every launch counted is one this path made
    cuda.reset_launches()
    res = {}
    for case, lanes, seed in (("b", 1, 1), ("c", 128, 2)):
        r = gf.run(["--rows", str(1 << 22), "--width", "128", "--queries", str(1 << 17),
                    "--lanes", str(lanes), "--seed", str(seed)])
        res[case] = r
        say("8 gather", case=f"{case} tpu kernel {2 if lanes == 1 else 3} shape",
            table=(1 << 22, 128), queries=r["rows"], lanes=lanes, ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}", ns_per_row=f"{r['ns_per_row']:.4f}",
            requested_GBps=f"{r['requested_bytes_per_s'] / 1e9:.2f}",
            sector_GBps=f"{r['sector_bytes_per_s'] / 1e9:.2f}", max_abs_err=r["max_abs_err"])
    launches = cuda.LAUNCHES["gather_sum"]
    check(launches > 0, "the gather-floor entry point launched no gather_sum kernel")
    torch.cuda.empty_cache()
    b = res["b"]
    tiles = b["rows"] // gf.TILE
    # the indices and the rows they name in, one int32 a tile out
    return dict(launches=launches, err=0, ms=b["ms"], plain_ms=b["plain_ms"], **bound(
        b["rows"] * (4 + 4 * b["width"]) + 4 * tiles,
        OPS["gather_element"] * b["rows"] * b["width"]))


def phase_edit(data: dict) -> dict:
    import torch

    from genefuserust_tpu_torch.core.edit_distance import edit_distance
    from genefuserust_tpu_torch.ops import edit_distance as ted
    from genefuserust_tpu_torch.parallel import ed_batch
    from genefuserust_tpu_torch.profiling.ed_ab import ed_jobs

    t0 = time.perf_counter()
    jobs = ed_jobs(ED_JOBS, data["seed"])
    gen_s = time.perf_counter() - t0
    host, arrays = ed_batch.encode_jobs(jobs)
    check(not host.any(), "edit_distance: a synthetic job was routed to the host")
    args = [torch.from_numpy(x).cuda() for x in arrays]
    W = args[0].shape[1] // 32
    got, err, ms, pms = _timed_pair(
        "edit_distance", lambda: ted.edit_distance_batch(*args, W),
        lambda: ted.edit_distance_plain(*args, W), reps=10, plain_reps=1)
    ref = [edit_distance(a, b) for a, b in jobs[:2000]]
    check(got[:2000].cpu().tolist() == ref, "edit_distance: kernel differs from host Myers")
    rec = dict(err=err, ms=ms, plain_ms=pms, **myers_bound(args))
    rec["shape"] = f"{ED_JOBS} synthetic jobs of 100-300 bases, W {W}"
    say("9 edit", jobs=ED_JOBS, pattern_width=args[0].shape[1], text_width=args[2].shape[1],
        W=W, mean_distance=f"{got.double().mean().item():.3f}", host_checked=len(ref),
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", bound_ms=f"{rec['bound_ms']:.4f}",
        bound_by=rec["bound_by"], max_abs_err=err, jobs_s=f"{gen_s:.1f}")
    return rec


def sweep_threshold(pool) -> dict:
    """Wall time of a flush of n of the scan's own jobs, n = 1, 2, 4 ...:
    host Myers against the batched path (encode, upload, kernel, download,
    setters), median of 5 -> {n: (host ms, batched ms)} and the crossover,
    the smallest n from which the batched path wins at every larger n."""
    import statistics

    import torch

    from genefuserust_tpu_torch.core.edit_distance import edit_distance
    from genefuserust_tpu_torch.parallel import ed_batch

    dev = torch.device("cuda")

    def host_flush(sub):
        out = [0] * len(sub)
        for i, (a, b) in enumerate(sub):
            out[i] = edit_distance(a, b)

    def batched_flush(sub):
        out = [0] * len(sub)
        ed_batch.evaluate_batched(
            [(a, b, lambda v, i=i: out.__setitem__(i, v)) for i, (a, b) in enumerate(sub)], dev)

    def wall(fn, sub):
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            fn(sub)
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e3

    # the scans flush fewer jobs than the largest size: repeat them
    pool = (pool * -(-SWEEP_MAX_JOBS // len(pool)))[:SWEEP_MAX_JOBS]
    batched_flush(pool)
    sweep, n = {}, 1
    while n <= SWEEP_MAX_JOBS:
        sweep[n] = (wall(host_flush, pool[:n]), wall(batched_flush, pool[:n]))
        n *= 2
    wins = [n for n, (h, b) in sweep.items() if b < h]
    crossover = next((n for n in sweep if all(m in wins for m in sweep if m >= n)), None)
    return dict(sweep=sweep, crossover=crossover)


def phase_rich(data: dict) -> dict:
    import torch

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu_torch.core.scanner import HostEngine, Scanner
    from genefuserust_tpu_torch.core.sequence import reverse_complement
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.parallel import ed_batch
    from genefuserust_tpu_torch.parallel.engine import TorchEngine
    from genefuserust_tpu_torch.utils.synthetic import gen_block

    contigs = data["mapper"].contigs
    blk = gen_block(data["mapper"], RICH_PAIRS, 150, seed=data["seed"] + 10)
    rng = np.random.default_rng(data["seed"] + 10)
    fusions = []
    for ga, gb, ea, eb in ((3, 17, 5, 9), (11, 24, 12, 3)):
        lb, rb = data["exons"][ga][ea] - 1, data["exons"][gb][eb] - 1
        fusions.append(contigs[f"c{ga:02d}"][lb - 400 : lb + 1]
                       + contigs[f"c{gb:02d}"][rb : rb + 400])

    def read(name, s, q):
        return SequenceRead(name, s, "+", q)

    pairs = []
    for i in range(RICH_PAIRS):
        name = f"@f{i:08d}"
        if i % 8 == 0:
            # the junction lies before base 401: R1 [off, off+150) and R2's
            # span [off+40, off+190) both cross it by at least 20 bases
            fused = fusions[(i // 8) % 2]
            off = int(rng.integers(271, 342))
            r1, r2 = fused[off : off + 150], reverse_complement(fused[off + 40 : off + 190])
            pairs.append(SequenceReadPair(read(name, r1, "I" * 150), read(name, r2, "I" * 150)))
        else:
            pairs.append(SequenceReadPair(*(
                read(name, side.seq[i, : side.lens[i]].tobytes().decode(),
                     side.qual[i, : side.lens[i]].tobytes().decode())
                for side in (blk.left, blk.right))))

    def scan(engine, name):
        j = os.path.join(data["workdir"], name)
        with quiet(data):
            m = Scanner(data["csv"], contigs, "", j, Settings(), engine=engine,
                        command="rich").scan_pairs(pairs)
        return strip_json(open(j).read()), m

    t0 = time.perf_counter()
    host, m_host = scan(HostEngine(), "rich_host.json")
    host_s = time.perf_counter() - t0
    eng = TorchEngine(Settings(), device="cuda")
    eng.use_packed(data["packed_kv2"])
    cuda.reset_launches()
    t0 = time.perf_counter()
    with captured_flushes() as flushes:
        got, m = scan(eng, "rich_torch.json")
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    check(got == host, "fusion-rich: TorchEngine JSON differs from the host oracle's")
    check(launches["edit_distance"] > 0 and eng.ed_stats["device"] > 0,
          f"fusion-rich: no edit distance went through the kernel ({eng.ed_stats})")
    say("10 rich", pairs=RICH_PAIRS, junction_pairs=RICH_PAIRS // 8, json="equal",
        fusions=len(m.fusion_results),
        supporting_reads=sum(len(f.matches) for f in m.fusion_results),
        ed_jobs=eng.ed_stats["jobs"], ed_device=eng.ed_stats["device"],
        launches=json.dumps(launches, separators=(",", ":")), torch_s=f"{torch_s:.2f}",
        host_s=f"{host_s:.1f}")
    ed = check_flushes("fusion-rich", flushes)
    data["ed_err"] = max(data["ed_err"], ed["err"])
    say("10 rich", ed_flush_sizes=ed["flush_sizes"], checked_flushes=ed["checked_flushes"],
        checked_jobs=ed["checked_jobs"],
        jobs_W_Lt=json.dumps(ed["batch_W_Lt"], separators=(",", ":")),
        kernel_vs_plain="equal", kernel_vs_host="equal", max_abs_err=ed["err"])
    # the sweep over the jobs the two scans flushed, fusion-rich first
    pool = [job for f in flushes + data.pop("ed_flushes") for job in f]
    sw = sweep_threshold(pool)
    say("10 rich", sweep_jobs="phase 10 and phase 5 flushes",
        mean_job_len=f"{np.mean([len(q) + len(r) for q, r in pool]) / 2:.1f}",
        sweep_ms=json.dumps({n: [round(h, 3), round(b, 3)] for n, (h, b) in
                             sw["sweep"].items()}, separators=(",", ":")),
        crossover_jobs=sw["crossover"], device_min_jobs=ed_batch.DEVICE_MIN_JOBS)
    return launches


def phase_multi(data: dict, smi_line: str) -> None:
    import torch

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.mapper import FusionMapper
    from genefuserust_tpu_torch.core.scanner import HostEngine, Scanner, finish_scan
    from genefuserust_tpu_torch.io.fastq_block import read_pair_block
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    wd = data["workdir"]
    lines = open(data["csv"]).read().splitlines(keepends=True)
    per_gene = 1 + 20  # a '>' header line, then 20 exon lines
    genes = [lines[g * per_gene : (g + 1) * per_gene] for g in range(PANEL_GENES)]
    # 3 CSVs of 10 genes; each planted fusion (G03->G17, G11->G24) stays in
    # one CSV, and the third CSV holds neither
    order = [g for g in range(PANEL_GENES) if g not in (17, 24)]
    order.insert(order.index(3) + 1, 17)
    order.insert(order.index(11) + 1, 24)
    csvs = []
    for k in range(3):
        path = os.path.join(wd, f"part{k}.csv")
        with open(path, "w") as f:
            for g in order[k * 10 : (k + 1) * 10]:
                f.writelines(genes[g])
        csvs.append(path)
    lst = os.path.join(wd, "parts.txt")
    with open(lst, "w") as f:
        f.write("".join(c + "\n" for c in csvs))
    mdir = os.path.join(wd, "multi")
    os.makedirs(mdir)
    cuda.reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        engine = cli.run(["-1", data["r1"], "-2", data["r2"], "-f", lst, "-r", data["fa"],
                          "-h", os.path.join(mdir, "o.html"), "-j", os.path.join(mdir, "o.json")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    data["log"].write(out.getvalue())
    check("#Fusion:" not in out.getvalue(), "multi-CSV printed #Fusion: blocks on stdout")
    for k in SCAN_KERNELS:
        check(launches[k] > 0, f"multi-CSV: kernel {k} was not launched")
    n_fus = []
    for k in range(3):
        for ext in ("html", "json"):
            check(os.path.exists(os.path.join(mdir, f"o_part{k}.{ext}")),
                  f"multi-CSV: report o_part{k}.{ext} missing")
        n_fus.append(len(json.load(open(os.path.join(mdir, f"o_part{k}.json")))["fusions"]))
    say("11 multi", csvs=3, genes_per_csv=10, pairs=CLI_PAIRS, wall_s=f"{wall:.2f}",
        index_s=f"{engine.table_seconds:.2f}", fusions_per_csv=n_fus,
        launches=json.dumps(launches, separators=(",", ":")), card=repr(smi_line))

    # (ii) the first 4,096 pairs, one pass for the three panels, against the
    # host oracle per CSV; the CLI run's tables, in CSV order, are reused
    packs = [e["packed"] for e in engine._tables.values()]
    check(len(packs) == 3, f"multi-CSV: the CLI built {len(packs)} tables, expected 3")
    b4 = os.path.join(wd, "b4")
    os.makedirs(b4)
    r1, r2 = os.path.join(b4, "R1.fq"), os.path.join(b4, "R2.fq")
    b1, q1, _, b2, q2, _ = (a[:ORACLE_PAIRS] for a in data["block"])
    write_fastq(r1, b1, q1, "p")
    write_fastq(r2, b2, q2, "p")
    contigs = data["mapper"].contigs
    eng = TorchEngine(Settings(), device="cuda")
    mappers = [FusionMapper(contigs, c, Settings(), multi_csv_mode=True) for c in csvs]
    for m, p in zip(mappers, packs):
        eng.use_packed(p, mapper=m)
    with quiet(data):
        eng.scan_pair_block_multi(mappers, read_pair_block(r1, r2))
        eng.flush()
        for k, m in enumerate(mappers):
            finish_scan(m, "", os.path.join(b4, f"t{k}.json"), "multi", Settings())
            Scanner(csvs[k], contigs, "", os.path.join(b4, f"h{k}.json"), Settings(),
                    engine=HostEngine(), multi_csv_mode=True,
                    command="multi").scan_pairs(data["oracle_pairs"])
    for k in range(3):
        t, h = (strip_json(open(os.path.join(b4, f"{x}{k}.json")).read()) for x in "th")
        check(t == h, f"multi-CSV: part{k} JSON differs from the host oracle's")
    fus = [len(m.fusion_results) for m in mappers]
    check(fus[0] > 0 and fus[1] > 0, f"multi-CSV: a planted fusion was not found ({fus})")
    say("11 multi", pairs=ORACLE_PAIRS, csvs=3, json="equal", fusions=fus)


def phase_single(data: dict, smi_line: str) -> None:
    import torch

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.scanner import HostEngine, Scanner
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    wd = data["workdir"]
    html, js = os.path.join(wd, "se.html"), os.path.join(wd, "se.json")
    cuda.reset_launches()
    t0 = time.perf_counter()
    with quiet(data):
        engine = cli.run(["-1", data["r1"], "-f", data["csv"], "-r", data["fa"],
                          "-h", html, "-j", js])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for k in SCAN_KERNELS:
        check(launches[k] > 0, f"single-end: kernel {k} was not launched")
    say("12 single", reads=CLI_PAIRS, wall_s=f"{wall:.2f}",
        index_s=f"{engine.table_seconds:.2f}",
        fusions=len(json.load(open(js))["fusions"]),
        launches=json.dumps(launches, separators=(",", ":")), card=repr(smi_line))
    reads = [p.left for p in data["oracle_pairs"]]
    contigs = data["mapper"].contigs

    def scan(engine, name):
        j = os.path.join(wd, name)
        with quiet(data):
            m = Scanner(data["csv"], contigs, "", j, Settings(), engine=engine,
                        command="single").scan_singles(reads)
        return strip_json(open(j).read()), m

    host, _ = scan(HostEngine(), "se_host.json")
    data["single_host_json"] = host
    eng = TorchEngine(Settings(), device="cuda")
    eng.use_packed(data["packed_kv2"])
    got, m = scan(eng, "se_torch.json")
    check(got == host, "single-end: TorchEngine JSON differs from the host oracle's")
    say("12 single", reads=ORACLE_PAIRS, json="equal", fusions=len(m.fusion_results))


@contextlib.contextmanager
def largest_sharded_call():
    """Record the inputs (cloned) of the largest sharded_map_read call that
    the sharded engine makes inside the block -> a list that holds, after
    the block, one (codes, lengths, indexes); the calls run unchanged."""
    from genefuserust_tpu_torch.parallel import sharded_engine

    calls, fn = [], sharded_engine.sharded_map_read

    def keep_largest(codes, lengths, indexes, *args):
        if not calls or codes.numel() > calls[0][0].numel():
            calls[:] = [(codes.clone(), lengths.clone(), indexes)]
        return fn(codes, lengths, indexes, *args)

    sharded_engine.sharded_map_read = keep_largest
    try:
        yield calls
    finally:
        sharded_engine.sharded_map_read = fn


@contextlib.contextmanager
def largest_wide_launches():
    """Record the inputs (cloned) of the largest launch of the gated vote
    and of mask+segments on their wide-row paths made inside the block ->
    {"vote": (pr, index, major_req, minor_req), "vote_lengths": the vote's
    lengths (or None), "mask_segments": (pr, lengths, gp, index,
    mismatch_thr)}; the launches run unchanged."""
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import map_read as tm

    got, vote, mask = {}, cuda.launch_vote, cuda.launch_mask_segments

    def keep(name, args):
        if name not in got or args[0].numel() > got[name][0].numel():
            got[name] = args
            return True
        return False

    def vote_rec(pr, B, NS, index, step, major_req, minor_req, P2, out, counts=False,
                 wide=None, lengths=None):
        if wide is not None and not counts and keep("vote", (pr.clone(), index, major_req,
                                                            minor_req)):
            got["vote_lengths"] = None if lengths is None else lengths.clone()
        vote(pr, B, NS, index, step, major_req, minor_req, P2, out, counts, wide, lengths)

    def mask_rec(pr, lengths, gp, B, NK, index, mismatch_thr, out, scratch=None, smem_cap=0):
        if NK + 15 > tm.MASK_MAX_WIDTH:
            keep("mask_segments", (pr.clone(), lengths.clone(), gp.clone(), index, mismatch_thr))
        mask(pr, lengths, gp, B, NK, index, mismatch_thr, out, scratch, smem_cap)

    cuda.launch_vote, cuda.launch_mask_segments = vote_rec, mask_rec
    try:
        yield got
    finally:
        cuda.launch_vote, cuda.launch_mask_segments = vote, mask


class WideBaseline:
    """Another checkout's csrc/probe.cu, csrc/vote.cu, csrc/mask_segments.cu
    and csrc/merge.cu (the parent's), built from that csrc/ and run on the
    same inputs as this checkout's kernels. Their entry points take this
    checkout's arguments (gf_merge_top2 too: the shards' rows by value),
    so the parent's kernels run through this checkout's wrappers with the
    parent's library in the port's place (`active`), the single-probe
    variant too (its gf_probe_single)."""

    def __init__(self, csrc: str):
        from genefuserust_tpu_torch.ops import cuda

        self.path = cuda.build(("probe.cu", "vote.cu", "mask_segments.cu", "merge.cu"),
                               csrc=os.path.abspath(csrc))
        self.lib = cuda.load(self.path)
        self.csrc = csrc

    @contextlib.contextmanager
    def active(self):
        """The port's wrappers launch the parent's kernels inside the block."""
        from genefuserust_tpu_torch.ops import cuda

        saved = cuda.library()
        cuda._lib = self.lib
        try:
            yield
        finally:
            cuda._lib = saved

    def probe(self, codes, lengths, stride, index):
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return tm.probe(codes, lengths, stride, index)

    def merge_step(self, votes):
        """The parent's merge launch on the shards' (B, 6) rows -> (ok, gp)."""
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return tm.merge_top2(votes, 40, 20)

    def vote(self, pr, index, major_req, minor_req, counts=False, lengths=None):
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return (tm.vote_counts(pr, index, lengths) if counts
                    else tm.vote(pr, index, major_req, minor_req, lengths))

    def mask(self, pr, lengths, gp, index, mismatch_thr):
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return tm.mask_segments(pr, lengths, gp, index, mismatch_thr)

    def mask_from_flags(self, words, lengths, gp, NK, mismatch_thr):
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return tm.mask_from_flags(words, lengths, gp, NK, mismatch_thr)

    def shard_flags(self, prs, lengths, gp, indexes):
        from genefuserust_tpu_torch.ops import map_read as tm

        with self.active():
            return tm.shard_flags(prs, lengths, gp, indexes)

    def sharded_map_read(self, codes, lens, indexes):
        """The parent's sharded_map_read on one device, for its peak memory:
        this checkout's with the parent's kernels -> the (B, 10) rows."""
        import torch

        from genefuserust_tpu_torch.parallel import sharded_index as tsi

        with self.active():
            r = tsi.sharded_map_read(codes, lens, indexes)
        return torch.cat([r.seg_valid.int(), r.seg_start, r.seg_end, r.seg_contig, r.seg_pos], 1)

    def sass(self, name: str) -> dict:
        """{function: its instructions} of the kernels whose mangled name
        holds `name`, in this checkout's library and in the parent's
        (cuobjdump -sass; addresses and encodings dropped)."""
        from genefuserust_tpu_torch.ops import cuda

        return dict(this=sass_of(cuda.build(), name), parent=sass_of(self.path, name))


def sass_of(lib: str, name: str) -> dict:
    """{mangled function: [instructions]} of `lib`'s kernels whose name
    holds `name`, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur and m:
            funcs[cur].append(m.group(1))
    return funcs


def wide_base(data: dict):
    """The --wide-baseline checkout's kernels (built once), or None."""
    if data.get("wide_baseline") and "wide_base" not in data:
        data["wide_base"] = WideBaseline(data["wide_baseline"])
    return data.get("wide_base")


def parent_ms(name: str, fn, exp, reps: int) -> float:
    """The parent's kernel on the same inputs: bit-equal to `exp`, timed
    (mean device ms, CUDA events)."""
    import torch

    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    got = fn()
    torch.cuda.synchronize()
    gs, es = (got, exp) if isinstance(got, (tuple, list)) else ((got,), (exp,))
    check(all(torch.equal(g, e) for g, e in zip(gs, es)),
          f"{name}: the parent's kernel differs from plain")
    return event_ms(fn, reps)


def _chunked(fn, rows, n, *args):
    """fn over chunks of n rows of the `rows` tensors, concatenated: plain
    versions whose padded intermediates at a whole wide batch would not
    fit on the card."""
    import torch

    B = rows[0].shape[0]
    return torch.cat([fn(*(r[a : a + n] for r in rows), *args) for a in range(0, B, n)])


def vote_need(pr, lens, index, chunk=256) -> dict:
    """What a vote of (B, NS, 2) probe results with their rows' lengths
    needs (the samples past a row's length are misses, and a row-bounded
    walk never reads them): the samples inside the rows, their DUPE
    samples' dupe rows, the lengths; its valid keys -> counts and bytes."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.hashtable import DUPE

    NS = pr.shape[1]
    ns = torch.where(lens < 16, 0, ((lens.long() - 16) // 2 + 1).clamp(max=NS))
    inside = torch.arange(NS, device=pr.device)[None, :] < ns[:, None]
    dupes = int(((pr[..., 0] == DUPE) & inside).sum())
    keys = sum(int(tm.vote_candidates(pr[a : a + chunk], index).sum())
               for a in range(0, pr.shape[0], chunk))
    return dict(samples=int(ns.sum()), keys=keys,
                bytes=int(ns.sum()) * 8 + dupes * index.D * (8 if index.split else 4)
                + lens.numel() * 4)


def mask_need(pr1, lens, index, chunk=64) -> dict:
    """What mask+segments of (B, NK, 2) probe results needs: the k-mers
    inside each row, their DUPE k-mers' dupe rows, lengths and the vote's
    keys; its candidates and in-bounds bases."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.hashtable import DUPE

    NK = pr1.shape[1]
    nk = (lens.long() - 15).clamp(min=0, max=NK)
    inside = torch.arange(NK, device=pr1.device)[None, :] < nk[:, None]
    dupes = int(((pr1[..., 0] == DUPE) & inside).sum())
    cand = sum(int(tm.expand(index, pr1[a : a + chunk, :, 0], pr1[a : a + chunk, :, 1])[2].sum())
               for a in range(0, pr1.shape[0], chunk))
    return dict(cand=cand, bases=int(lens.long().clamp(max=NK + 15).sum()),
                bytes=int(nk.sum()) * 8 + dupes * index.D * (8 if index.split else 4)
                + lens.numel() * 4 + 16 * lens.numel())


def flags_need(lens, NK) -> int:
    """Bytes mask+segments from flag words needs: each row's words up to
    its length (two int32 each), its length and the vote's four keys."""
    return 8 * int(-(-lens.long().clamp(max=NK + 15) // 32).sum()) + 20 * lens.numel()


def shard_flags_need(pr1s, lens, indexes, words) -> dict:
    """What the shard flags of the shards' (B, NK, 2) probe results need:
    each row's k-mers inside its length (the probe makes the rest EMPTY,
    and the kernel never reads them) with the dupe rows their DUPE k-mers
    name, the lengths and the vote's keys once, the words written once
    (every word, zero past a row's own); and the padded rows' bytes."""
    import torch

    from genefuserust_tpu_torch.ops.hashtable import DUPE

    B, NK = pr1s[0].shape[:2]
    nk = (lens.long() - 15).clamp(min=0, max=NK)
    inside = torch.arange(NK, device=lens.device)[None, :] < nk[:, None]
    dupe = sum(int(((pr[..., 0] == DUPE) & inside).sum()) * ix.D * (8 if ix.split else 4)
               for pr, ix in zip(pr1s, indexes))
    fixed = B * 20 + words.numel() * 4
    return dict(bytes=len(pr1s) * int(nk.sum()) * 8 + dupe + fixed,
                padded_bytes=sum(pr.numel() * 4 + dupe_row_bytes(pr, ix)
                                 for pr, ix in zip(pr1s, indexes)) + fixed)


def or_plain(pr1s, gp, indexes):
    """shard_flags_plain of each shard, ORed: the words' plain version."""
    from genefuserust_tpu_torch.ops import map_read as tm

    words = tm.shard_flags_plain(pr1s[0], gp, indexes[0])
    for pr1, ix in zip(pr1s[1:], indexes[1:]):
        words |= tm.shard_flags_plain(pr1, gp, ix)
    return words


def sharded_kernels(codes, lens, indexes, reps=20, plain_reps=3, base=None):
    """Each kernel of sharded_map_read against its plain version at one
    call's inputs, timed, with its bound (the shard flags' from what the
    rows need, the padded rows' beside it), the shard flags and mask from
    flags also beside the parent's kernels (`base`, a WideBaseline), the
    merge also beside the parent's step ->
    (records probe_split, vote_counts, merge_top2, shard_flags,
    mask_from_flags; the per-shard stride-2 and stride-1 probe results, the
    merged gp and the segments)."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import map_read as tm

    S = len(indexes)
    B, W = codes.shape
    NK = W - 15
    rec = {}
    km, kok = tm.compute_kmers(codes, lens)
    cpu_rows = [probe_rows(km[:, ::PASS1_STEP], kok[:, ::PASS1_STEP], ix) for ix in indexes]
    del km, kok
    prs, err, ms, pms = _timed_pair(
        f"probe (split, {S} shards, {B}x{W})",
        lambda: torch.stack([tm.probe(codes, lens, PASS1_STEP, ix) for ix in indexes]),
        lambda: torch.stack([tm.probe_plain(codes, lens, PASS1_STEP, ix) for ix in indexes]),
        reps=reps, plain_reps=plain_reps)
    NS = prs.shape[2]
    rows = sum(r["rows"] for r in cpu_rows)
    hits = sum(r["hits"] for r in cpu_rows)
    # per shard: codes, lengths, one sector a table row needed and one a
    # hit's vals, the results
    rec["probe_split"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        S * (B * W + 4 * B + B * NS * 8) + (rows + hits) * SECTOR,
        S * OPS["probe_base"] * B * W + OPS["probe_query"] * sum(r["valid"] for r in cpu_rows)))
    rec["probe_split"].update(
        shape=f"{S} split shards of {tuple(indexes[0].table.shape)} keys, {B}x{W} codes, "
              f"stride {PASS1_STEP}", rows_needed=rows, hits=hits)
    votes, err, ms, pms = _timed_pair(
        f"vote_counts ({B}x{NS})",
        lambda: torch.stack([tm.vote_counts(pr, ix, lens) for pr, ix in zip(prs, indexes)]),
        lambda: torch.stack([tm.vote_counts_plain(pr, ix) for pr, ix in zip(prs, indexes)]),
        reps=reps, plain_reps=plain_reps)
    cands = [tm.vote_candidates(pr, ix) for pr, ix in zip(prs, indexes)]
    rec["vote_counts"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        sum(pr.numel() * 4 + dupe_row_bytes(pr, ix) for pr, ix in zip(prs, indexes))
        + votes.numel() * 4,
        OPS["vote_sample"] * S * B * NS + OPS["vote_candidate"] * sum(int(c.sum()) for c in cands)))
    rec["vote_counts"]["shape"] = (f"{S} shards x {B}x{NS} samples, D {indexes[0].D}, "
                                   f"most valid keys a row {max(int(c.max()) for c in cands)}")
    # the merge: the whole step from the shards' rows, where the vote wrote
    # them, to what pass 2 takes (ok, gp); the parent's merge beside it
    vl = list(votes)
    (ok, gp), err, ms, pms = _timed_pair(
        f"merge_top2 ({B} rows)", lambda: tm.merge_top2(vl, 40, 20),
        lambda: tm.merge_top2_plain(vl, 40, 20), reps=reps, plain_reps=plain_reps)
    rec["merge_top2"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        votes.numel() * 4 + gp.numel() * 4 + ok.numel(), OPS["merge_candidate"] * 2 * S * B))
    rec["merge_top2"]["shape"] = f"{S} shards' ({B}, 6) counts rows -> ok ({B},), gp ({B}, 4)"
    if base:
        rec["merge_top2"]["parent_ms"] = parent_ms(
            f"merge_top2 ({B} rows, the parent's)", lambda: base.merge_step(vl), (ok, gp),
            reps)
    pr1s = [tm.probe(codes, lens, 1, ix) for ix in indexes]

    # the whole call from the shards' probe results to the words: one
    # launch over the 4 shards
    words, err, ms, pms = _timed_pair(
        f"shard_flags ({S} shards, {B}x{NK})", lambda: tm.shard_flags(pr1s, lens, gp, indexes),
        lambda: or_plain(pr1s, gp, indexes), reps=reps, plain_reps=plain_reps)
    cand2 = sum(int(tm.expand(ix, pr1[..., 0], pr1[..., 1])[2].sum())
                for pr1, ix in zip(pr1s, indexes))
    need = shard_flags_need(pr1s, lens, indexes, words)
    ops = OPS["mask_candidate"] * cand2
    rec["shard_flags"] = dict(err=err, ms=ms, plain_ms=pms, **bound(need["bytes"], ops))
    rec["shard_flags"].update(shape=f"{S} shards x {B}x{NK} k-mers, one launch",
                              padded_bound_ms=bound(need["padded_bytes"], ops)["bound_ms"])
    if base:
        rec["shard_flags"]["parent_ms"] = parent_ms(
            f"shard_flags ({B}x{NK})", lambda: base.shard_flags(pr1s, lens, gp, indexes), words,
            reps)
    seg, err, ms, pms = _timed_pair(
        f"mask_from_flags ({B}x{W})", lambda: tm.mask_from_flags(words, lens, gp, NK, 10),
        lambda: tm.mask_from_flags_plain(words, lens, gp, NK, 10), reps=reps,
        plain_reps=plain_reps)
    rec["mask_from_flags"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        words.numel() * 4 + lens.numel() * 4 + gp.numel() * 4 + seg.numel() * 4,
        OPS["mask_base"] * int(lens.long().sum())))
    rec["mask_from_flags"]["shape"] = f"{B} rows, width {W}"
    if base:
        rec["mask_from_flags"]["parent_ms"] = parent_ms(
            f"mask_from_flags ({B}x{W})", lambda: base.mask_from_flags(words, lens, gp, NK, 10),
            seg, reps)
    return rec, dict(prs=prs, pr1s=pr1s, gp=gp, seg=seg, words=words)


def say_kernel(rec: dict, k: str) -> None:
    r = rec[k]
    say("13 sharded", kernel=k, shape=repr(r["shape"]), ms=f"{r['ms']:.4f}",
        plain_ms=f"{r['plain_ms']:.4f}", bound_ms=f"{r['bound_ms']:.5f}",
        bound_by=r["bound_by"], bound_share=f"{r['bound_ms'] / r['ms']:.4f}",
        max_abs_err=r["err"], **{x: f"{r[x]:.4f}" for x in ("global_ms", "device_ms", "parent_ms")
                                 if x in r},
        **{x: f"{r[x]:.5f}" for x in ("padded_bound_ms",) if x in r})


def sharded_peaks(label: str, codes, lens, indexes, base) -> dict:
    """The peak device memory of sharded_map_read at one call, over what was
    allocated before it, and of the parent's flow beside it (`base`; its
    rows must equal): a device's shard flags may hold up to
    FLAGS_GROUP_BYTES of probe results more than the parent's one shard's
    at a time."""
    import torch

    from genefuserust_tpu_torch.parallel import sharded_index as tsi

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - before

    r, mine = peak(lambda: tsi.sharded_map_read(codes, lens, indexes))
    rows = torch.cat([r.seg_valid.int(), r.seg_start, r.seg_end, r.seg_contig, r.seg_pos], 1)
    B, W = codes.shape
    out = dict(peak_mb=round(mine / 2**20, 1), cap_mb=round(tsi.FLAGS_GROUP_BYTES / 2**20, 1),
               shard_results_mb=round(B * (W - 15) * 8 / 2**20, 1),
               launches=len(tsi.flag_groups(len(indexes), B * (W - 15) * 8)))
    if base:
        prows, theirs = peak(lambda: base.sharded_map_read(codes, lens, indexes))
        check(torch.equal(prows, rows), f"{label}: the parent's sharded_map_read differs")
        out["parent_peak_mb"] = round(theirs / 2**20, 1)
        check(mine - theirs <= tsi.FLAGS_GROUP_BYTES,
              f"{label}: sharded_map_read's peak {mine} B passes the parent's {theirs} B by "
              "more than the shard flags' cap")
    say("13 sharded", peak_memory=repr(label), rows=B, width=W, **out)
    return out


def phase_sharded(data: dict, smi_line: str) -> dict:
    import torch

    from genefuserust_tpu_torch import driver
    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu_torch.core.scanner import HostEngine, Scanner
    from genefuserust_tpu_torch.core.sequence import reverse_complement
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.io.fastq_block import stream_fastq_blocks, stream_pair_blocks
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.parallel.engine import TorchEngine
    from genefuserust_tpu_torch.parallel.sharded_engine import ShardedIndexEngine
    from genefuserust_tpu_torch.utils.synthetic import long_reads

    wd = os.path.join(data["workdir"], "sharded")
    os.makedirs(wd)
    b1, q1, _, b2, q2, _ = (a[:SHARD_PAIRS] for a in data["block"])
    r1, r2 = os.path.join(wd, "R1.fq"), os.path.join(wd, "R2.fq")
    write_fastq(r1, b1, q1, "p")
    write_fastq(r2, b2, q2, "p")
    contigs = data["mapper"].contigs
    devices = ["cuda:0"] * SHARDS

    def report(name):
        return (_TS.sub("<ts>", open(os.path.join(wd, f"{name}.html")).read()),
                strip_json(open(os.path.join(wd, f"{name}.json")).read()))

    def config(name, paired, **kw):
        return driver.RunConfig(r1_file=r1, r2_file=r2 if paired else "", fusion_file=data["csv"],
                                html=os.path.join(wd, f"{name}.html"),
                                json=os.path.join(wd, f"{name}.json"), ref_file=data["fa"],
                                **kw)

    # (i) the main path: 4 shards on the card, through the driver; its
    # largest sharded map_read is kept for the kernel checks of (vi)
    cuda.reset_launches()
    t0 = time.perf_counter()
    with largest_sharded_call() as calls, quiet(data):
        eng = driver.scan(config("sh4", True, engine="sharded-index", devices=devices),
                          "sharded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for k in ("probe", "vote_counts", "merge_top2", "shard_flags", "mask_from_flags"):
        check(launches[k] > 0, f"sharded: kernel {k} was not launched by the scan")
    check(launches["vote"] == launches["mask_segments"] == 0,
          "sharded: the single-table vote or mask+segments ran in the sharded scan")
    # the 4 shards on the one card: one shard flags launch a call
    check(launches["shard_flags"] == launches["merge_top2"] == launches["mask_from_flags"],
          f"sharded: {launches['shard_flags']} shard flags launches for "
          f"{launches['merge_top2']} calls")
    n_fus = len(json.load(open(os.path.join(wd, "sh4.json")))["fusions"])
    check(n_fus >= 1, "sharded: the scan reported no fusion")
    say("13 sharded", shards=SHARDS, devices=",".join(devices), pairs=SHARD_PAIRS,
        table_bytes=eng.table_bytes, table_mb=f"{eng.table_bytes / 2**20:.1f}",
        pack_s=f"{eng.table_seconds:.2f}", wall_s=f"{wall:.2f}",
        pairs_per_s_excl_tables=f"{SHARD_PAIRS / (wall - eng.table_seconds):.0f}",
        fusions=n_fus, launches=json.dumps(launches, separators=(",", ":")),
        ed_jobs=eng.ed_stats["jobs"], card=repr(smi_line))
    # (ii) the real CLI, one shard; (iii) the single-table TorchEngine
    t0 = time.perf_counter()
    with quiet(data):
        cli.run(["-1", r1, "-2", r2, "-f", data["csv"], "-r", data["fa"], "--engine",
                 "sharded-index", "--mesh", "1", "-h", os.path.join(wd, "sh1.html"),
                 "-j", os.path.join(wd, "sh1.json")])
    cli_s = time.perf_counter() - t0

    def torch_scan(name, paired):
        teng = TorchEngine(Settings(), device="cuda")
        teng.use_packed(data["packed_kv2"])
        with quiet(data):
            sc = Scanner(data["csv"], contigs, os.path.join(wd, f"{name}.html"),
                         os.path.join(wd, f"{name}.json"), Settings(), engine=teng,
                         command="sharded")
            if paired:
                sc.scan_pair_stream(stream_pair_blocks(r1, r2))
            else:
                sc.scan_single_stream(stream_fastq_blocks(r1))
        torch.cuda.synchronize()

    torch_scan("t", True)
    ref = report("t")
    for name in ("sh4", "sh1"):
        # the CLI's reports name its command line, the others "sharded"
        got = tuple(t.replace(" ".join(sys.argv), "sharded") for t in report(name))
        check(got[1] == ref[1], f"sharded ({name}): JSON differs from TorchEngine's")
        check(got[0] == ref[0], f"sharded ({name}): HTML differs from TorchEngine's")
    # (iv) single-end: R1 alone, 4 shards through the driver
    t0 = time.perf_counter()
    with quiet(data):
        se_eng = driver.scan(config("se4", False, engine="sharded-index", devices=devices),
                             "sharded")
    torch.cuda.synchronize()
    se_wall = time.perf_counter() - t0
    torch_scan("tse", False)
    got, ref_se = report("se4"), report("tse")
    check(got == ref_se, "sharded single-end: reports differ from TorchEngine's")
    say("13 sharded", pairs=SHARD_PAIRS, json_html_vs_torch_engine="equal",
        cli_mesh_1="equal", cli_mesh_1_s=f"{cli_s:.2f}", single_end_reads=SHARD_PAIRS,
        single_end_wall_s=f"{se_wall:.2f}", single_end_pack_s=f"{se_eng.table_seconds:.2f}",
        single_end="equal")
    # (v) the host oracle's subsets (phases 6 and 12 scanned them), on the
    # main path's shard tables
    sub = ShardedIndexEngine(Settings(), devices=devices)
    sub.use_tables(eng._indexes)

    def oracle(name, items, paired):
        # phase 6's command for pairs, phase 12's for reads
        j = os.path.join(wd, name)
        with quiet(data):
            sc = Scanner(data["csv"], contigs, "", j, Settings(), engine=sub,
                         command="oracle" if paired else "single")
            (sc.scan_pairs if paired else sc.scan_singles)(items)
        return strip_json(open(j).read())

    check(oracle("o4.json", data["oracle_pairs"], True) == data["oracle_host_json"],
          "sharded: the 4,096-pair JSON differs from the host oracle's")
    check(oracle("o4se.json", [p.left for p in data["oracle_pairs"]], False)
          == data["single_host_json"], "sharded: the 4,096-read JSON differs from the host's")
    say("13 sharded", oracle_pairs=ORACLE_PAIRS, oracle_reads=ORACLE_PAIRS, json="equal")

    # (vi) each kernel of the path against its plain version, at the
    # scan's largest batch
    rec, aux = sharded_kernels(*calls[0], base=wide_base(data))
    del aux, calls[:]
    for k in SHARD_KERNELS:
        say_kernel(rec, k)
    launches["probe_split"] = launches["probe"]

    # (vii) the wide paths: a 4,200-base and a 70,000-base read from the
    # junction of the first planted fusion (G03 exon 6 -> G17 exon 10)
    lb, rb = data["exons"][3][5] - 1, data["exons"][17][9] - 1
    # (a seed apart from the panel's: the same generator stream would
    # repeat a gene's bases in the read's random middle)
    span, wide = long_reads(contigs["c03"][lb - 2200 : lb + 1], contigs["c17"][rb : rb + 2200],
                            seed=data["seed"] + 1000)
    planted = np.linspace(0, ORACLE_PAIRS - 1, 16).astype(np.int64).tolist()
    base = [data["oracle_pairs"][i] for i in planted] + data["oracle_pairs"][1:47]
    se_items = [p.left for p in base]
    pe_items = list(base)
    for k, r in enumerate((span, wide)):
        read = SequenceRead(f"@long{k}", r, "+", "I" * len(r))
        mate = SequenceRead(f"@long{k}", reverse_complement(r[-300:-150]), "+", "I" * 150)
        se_items.insert(1 + 20 * k, read)
        pe_items.insert(1 + 20 * k, SequenceReadPair(read, mate))
    cuda.reset_launches()
    with largest_wide_launches() as kv_calls, largest_sharded_call() as sh_calls:
        for paired, items in ((False, se_items), (True, pe_items)):
            reps = {}
            for name, engine in (("host", HostEngine()),
                                 ("torch", TorchEngine(Settings(), device="cuda")),
                                 ("sharded", ShardedIndexEngine(Settings(), devices=devices))):
                if name == "torch":
                    engine.use_packed(data["packed_kv2"])
                elif name == "sharded":
                    engine.use_tables(eng._indexes)
                with quiet(data):
                    sc = Scanner(data["csv"], contigs, os.path.join(wd, f"w{name}.html"),
                                 os.path.join(wd, f"w{name}.json"), Settings(), engine=engine,
                                 command="wide")
                    (sc.scan_pairs if paired else sc.scan_singles)(items)
                torch.cuda.synchronize()
                reps[name] = report(f"w{name}")
            for name in ("torch", "sharded"):
                check(reps[name] == reps["host"],
                      f"wide reads ({'paired' if paired else 'single-end'}): {name} reports "
                      "differ from the host oracle's")
    wide_launches = dict(cuda.LAUNCHES)
    for k in WIDE_KERNELS:
        check(wide_launches[k] > 0, f"wide reads: kernel {k} was not launched")
    say("13 sharded", wide_reads="4200,70000", single_end="equal", paired="equal",
        engines="TorchEngine,ShardedIndexEngine", vs="host oracle",
        launches=json.dumps(wide_launches, separators=(",", ":")))
    # the wide kernels at the wide scans' largest calls: TorchEngine's on
    # the kv2 table, the sharded engine's on the 4 split shard tables; each
    # also on the global route (caps below the long rows' keys and words)
    # and beside the parent's kernels (--wide-baseline)
    base = wide_base(data)
    pr, kv2, major_req, minor_req = kv_calls["vote"]
    vlens = kv_calls["vote_lengths"]
    check(vlens is not None, "wide rows: TorchEngine's wide vote was given no lengths")
    v, err, ms, pms = _timed_pair("vote (wide rows, kv2)",
                                  lambda: tm.vote(pr, kv2, major_req, minor_req, vlens),
                                  lambda: tm.vote_plain(pr, kv2, major_req, minor_req),
                                  reps=5, plain_reps=1)
    need = vote_need(pr, vlens, kv2)
    wn = tm.vote_candidates(pr, kv2)
    rec["vote_wide"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        need["bytes"] + v.numel() * 4,
        OPS["vote_sample"] * need["samples"] + OPS["vote_candidate"] * need["keys"]))
    rec["vote_wide"].update(
        shape=f"kv2, {pr.shape[0]}x{pr.shape[1]} samples, D {kv2.D}, most valid keys a row "
              f"{int(wn.max())}, {need['samples']} samples inside the rows",
        padded_bound_ms=bound(pr.numel() * 4 + dupe_row_bytes(pr, kv2) + v.numel() * 4,
                              0)["bound_ms"],
        global_ms=wide_global("vote (wide rows, kv2, global route)",
                              lambda: tm.vote(pr, kv2, major_req, minor_req, vlens, VOTE_CAP), v),
        device_ms=wide_vote_device_ms(pr, kv2, vlens, False, v))
    if base:
        rec["vote_wide"]["parent_ms"] = parent_ms(
            "vote (wide rows, kv2)", lambda: base.vote(pr, kv2, major_req, minor_req,
                                                       lengths=vlens), v, 5)
    vc = tm.vote_counts_plain(pr, kv2)
    check(torch.equal(tm.vote_counts(pr, kv2, vlens), vc)
          and torch.equal(tm.vote_counts(pr, kv2, vlens, VOTE_CAP), vc),
          "wide rows: the vote's counts mode differs from plain on the kv2 table")
    pr1, wlens, wgp, kv2, thr = kv_calls["mask_segments"]
    wseg, err, ms, pms = _timed_pair(
        "mask_segments (wide rows, kv2)", lambda: tm.mask_segments(pr1, wlens, wgp, kv2, thr),
        lambda: tm.mask_segments_plain(pr1, wlens, wgp, kv2, thr), reps=5, plain_reps=1)
    check(int(wseg[:, 4:6].max()) > tm.MASK_MAX_WIDTH, "wide rows: no chain ends past 65,535")
    mneed = mask_need(pr1, wlens, kv2)
    rec["mask_segments_wide"] = dict(err=err, ms=ms, plain_ms=pms, **bound(
        mneed["bytes"] + wseg.numel() * 4,
        OPS["mask_candidate"] * mneed["cand"] + OPS["mask_base"] * mneed["bases"]))
    rec["mask_segments_wide"].update(
        shape=f"kv2, {pr1.shape[0]} rows, width {pr1.shape[1] + 15}",
        padded_bound_ms=bound(pr1.numel() * 4 + wlens.numel() * 4 + wgp.numel() * 4
                              + dupe_row_bytes(pr1, kv2) + wseg.numel() * 4, 0)["bound_ms"],
        global_ms=wide_global("mask_segments (wide rows, kv2, global route)",
                              lambda: tm.mask_segments(pr1, wlens, wgp, kv2, thr, MASK_CAP),
                              wseg))
    if base:
        rec["mask_segments_wide"]["parent_ms"] = parent_ms(
            "mask_segments (wide rows, kv2)", lambda: base.mask(pr1, wlens, wgp, kv2, thr), wseg,
            5)
    # the one table's flags, then mask from flags: equal to mask+segments
    words = tm.shard_flags([pr1], wlens, wgp, [kv2])
    check(torch.equal(words, tm.shard_flags_plain(pr1, wgp, kv2)),
          "wide rows: shard_flags differs from plain on the kv2 table")
    for cap in (None, MASK_CAP):
        check(torch.equal(tm.mask_from_flags(words, wlens, wgp, pr1.shape[1], thr, cap), wseg),
              "wide rows: mask_from_flags differs from mask+segments on the kv2 table")
    del pr, v, vc, pr1, wlens, wgp, wseg, words, kv_calls
    codes, lens, indexes = sh_calls[0]
    srec, aux = sharded_kernels(codes, lens, indexes, reps=5, plain_reps=1, base=base)
    check(int(aux["seg"][:, 4:6].max()) > tm.MASK_MAX_WIDTH,
          "wide rows (shards): no chain ends past 65,535")
    # the gated vote and mask+segments on each split shard at those rows,
    # with the default caps and on the global route
    for spr, spr1, ix in zip(aux["prs"], aux["pr1s"], indexes):
        vp = tm.vote_plain(spr, ix, 40, 20)
        mp = tm.mask_segments_plain(spr1, lens, aux["gp"], ix, 10)
        for vcap, mcap in ((None, None), (VOTE_CAP, MASK_CAP)):
            check(torch.equal(tm.vote(spr, ix, 40, 20, lens, vcap), vp),
                  "wide rows: the gated vote differs from plain on a split shard table")
            check(torch.equal(tm.mask_segments(spr1, lens, aux["gp"], ix, 10, mcap), mp),
                  "wide rows: mask+segments differs from plain on a split shard table")
    # the sharded records' bounds from what the rows need
    prs, pr1s = aux["prs"], aux["pr1s"]
    vneeds = [vote_need(p, lens, ix) for p, ix in zip(prs, indexes)]
    srec["vote_counts"].update(bound(
        sum(n["bytes"] for n in vneeds) + len(indexes) * lens.numel() * 24,
        OPS["vote_sample"] * sum(n["samples"] for n in vneeds)
        + OPS["vote_candidate"] * sum(n["keys"] for n in vneeds)))
    vplain = torch.stack([tm.vote_counts_plain(p, ix) for p, ix in zip(prs, indexes)])
    srec["vote_counts"]["global_ms"] = wide_global(
        "vote_counts (wide rows, 4 shards, global route)",
        lambda: torch.stack([tm.vote_counts(p, ix, lens, VOTE_CAP) for p, ix in zip(prs, indexes)]),
        vplain)
    srec["vote_counts"]["device_ms"] = sum(
        wide_vote_device_ms(p, ix, lens, True, e) for p, ix, e in zip(prs, indexes, vplain))
    NK = pr1s[0].shape[1]
    words = aux["words"]
    seg = aux["seg"]
    srec["mask_from_flags"].update(bound(flags_need(lens, NK) + seg.numel() * 4,
                                         OPS["mask_base"] * int(lens.long().sum())))
    srec["mask_from_flags"]["global_ms"] = wide_global(
        "mask_from_flags (wide rows, global route)",
        lambda: tm.mask_from_flags(words, lens, aux["gp"], NK, 10, MASK_CAP), seg)
    if base:
        srec["vote_counts"]["parent_ms"] = parent_ms(
            "vote_counts (wide rows, 4 shards)",
            lambda: torch.stack([base.vote(p, ix, 0, 0, True, lens)
                                 for p, ix in zip(prs, indexes)]), vplain, 5)
    del aux, prs, pr1s, words, seg, vplain
    rec["vote_counts_wide"] = srec["vote_counts"]
    rec["shard_flags_wide"] = srec["shard_flags"]
    rec["mask_from_flags_wide"] = srec["mask_from_flags"]
    rec["shard_flags_wide"]["peak"] = sharded_peaks("the sharded wide call", codes, lens,
                                                    indexes, base)
    del sh_calls[:]
    # (viii) the same kernels at a 4,096-row lane as TorchEngine builds one
    rows4096 = wide_lane(data, kv2, wide, base, indexes)
    for k in WIDE_KERNELS:
        rec[k]["rows4096"] = rows4096[k]
        say_kernel(rec, k)
    say("13 sharded", wide_checked="vote,vote_counts,mask_segments,shard_flags,mask_from_flags",
        tables="kv2,split", routes="shared,global", equal=True)
    launches.update({k: wide_launches[k] for k in WIDE_KERNELS})
    return dict(rec=rec, launches=launches)


def wide_vote_device_ms(pr, index, lens, counts: bool, exp, reps: int = 20) -> float:
    """The wide vote's two launches alone (vote_kernel listing the long rows,
    vote_wide_kernel's shared-memory pass), enqueued back to back without
    the wrapper's wait for the count of keys past shared memory: its
    device ms (CUDA events), where no row is past it. Bit-equal to `exp`."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    B, NS, _ = pr.shape
    out = torch.empty((B, 6 if counts else 5), dtype=torch.int32, device=pr.device)
    wide = torch.zeros(3 + 3 * B, dtype=torch.int64, device=pr.device)
    args = (pr, B, NS, index, PASS1_STEP, 0 if counts else 40, 0 if counts else 20)

    def run():
        wide[:3].zero_()
        cuda.launch_vote(*args, tm.vote_width(NS, index.D), out, counts, wide, lens)
        cuda.launch_vote_wide(*args, counts, wide, lens, tm.WIDE_SMEM_BYTES // 8, out)
        return out

    run()
    check(int(wide[1]) == 0 and torch.equal(out, exp),
          "the wide vote's launches alone differ from plain (or a row is past shared memory)")
    return event_ms(run, reps)


def wide_global(name: str, fn, exp, reps: int = 5) -> float:
    """A wide kernel with a cap that sends its long rows to global scratch:
    bit-equal to `exp` (plain's rows), timed -> ms."""
    import torch

    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    got = fn()
    torch.cuda.synchronize()
    check(torch.equal(got, exp), f"{name}: kernel differs from its plain version")
    return event_ms(fn, reps)


def wide_lane(data: dict, kv2, wide_read: str, base, shards=None, reps: int = 5) -> dict:
    """The five wide kernels on a 4,096-row lane as TorchEngine builds one
    for a batch with one long read: the 70,000-base read (row 1,000) among
    4,095 R1 reads of 150 bases from gen_block, every row padded to 70,016
    bases (codes 287 MB, pass-1 results 1.15 GB, pass-2 results 2.29 GB).
    Each kernel bit-equal to its plain version (plain in chunks of rows:
    its intermediates at the whole lane would not fit on the card), with
    the default caps and on the global route (shard flags: one launch, and
    a second ORing into the first's words), timed, beside the parent's
    kernels where given, with its bound from what the rows need ->
    {kernel: record}. `shards`: split shard tables whose sharded_map_read
    of the lane has its peak memory read beside the parent's."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.core.sequence import BASE_CODE_LUT
    from genefuserust_tpu_torch.ops import map_read as tm

    dev = kv2.table.device
    B = WIDE_LANE_ROWS
    long_row = min(1000, B // 2)
    W = -(-len(wide_read) // 32) * 32
    short = torch.from_numpy(BASE_CODE_LUT[data["block"][0][: B - 1]])
    codes = torch.full((B, W), 255, dtype=torch.uint8, device=dev)
    rows = torch.cat([torch.arange(long_row), torch.arange(long_row + 1, B)]).to(dev)
    codes[rows, : short.shape[1]] = short.to(dev)
    codes[long_row, : len(wide_read)] = torch.from_numpy(
        BASE_CODE_LUT[np.frombuffer(wide_read.encode(), np.uint8)]).to(dev)
    lens = torch.full((B,), short.shape[1], dtype=torch.int32, device=dev)
    lens[rows] = torch.from_numpy(data["block"][2][: B - 1].astype(np.int32)).to(dev)
    lens[long_row] = len(wide_read)
    pr = tm.probe(codes, lens, PASS1_STEP, kv2)
    recs = {}

    def record(name, key, fn, plain_fn, need_bytes, ops, global_fn, parent_fn):
        got, err, ms, pms = _timed_pair(f"{name} (4,096-row lane)", fn, plain_fn, reps=reps,
                                        plain_reps=1)
        r = dict(err=err, ms=ms, plain_ms=pms, **bound(need_bytes, ops),
                 shape=f"kv2, {B} rows of width {W}")
        if global_fn is not None:
            r["global_ms"] = wide_global(f"{name} (4,096-row lane, global route)", global_fn,
                                         got)
        if key in ("vote_wide", "vote_counts_wide"):
            r["device_ms"] = wide_vote_device_ms(pr, kv2, lens, key == "vote_counts_wide", got)
        if parent_fn is not None:
            r["parent_ms"] = parent_ms(f"{name} (4,096-row lane)", parent_fn, got, reps)
        recs[key] = r
        say("13 sharded", kernel=key, lane=f"{B}x{W}", ms=f"{ms:.4f}",
            plain_ms=f"{r['plain_ms']:.1f}", bound_ms=f"{r['bound_ms']:.5f}",
            bound_by=r["bound_by"],
            global_ms=f"{r['global_ms']:.4f}" if "global_ms" in r else "-",
            device_ms=f"{r['device_ms']:.4f}" if "device_ms" in r else "-",
            parent_ms=f"{r['parent_ms']:.4f}" if "parent_ms" in r else "not run",
            max_abs_err=err)
        return got

    need = vote_need(pr, lens, kv2)
    vops = OPS["vote_sample"] * need["samples"] + OPS["vote_candidate"] * need["keys"]
    v = record("vote", "vote_wide", lambda: tm.vote(pr, kv2, 40, 20, lens),
               lambda: _chunked(tm.vote_plain, [pr], 256, kv2, 40, 20), need["bytes"] + B * 20,
               vops, lambda: tm.vote(pr, kv2, 40, 20, lens, VOTE_CAP),
               base and (lambda: base.vote(pr, kv2, 40, 20, lengths=lens)))
    record("vote_counts", "vote_counts_wide", lambda: tm.vote_counts(pr, kv2, lens),
           lambda: _chunked(tm.vote_counts_plain, [pr], 256, kv2), need["bytes"] + B * 24, vops,
           lambda: tm.vote_counts(pr, kv2, lens, VOTE_CAP),
           base and (lambda: base.vote(pr, kv2, 0, 0, True, lens)))
    del pr
    gp = v[:, 1:5].contiguous()
    pr1 = tm.probe(codes, lens, 1, kv2)
    NK = pr1.shape[1]
    mneed = mask_need(pr1, lens, kv2)
    seg = record("mask_segments", "mask_segments_wide",
                 lambda: tm.mask_segments(pr1, lens, gp, kv2, 10),
                 lambda: _chunked(tm.mask_segments_plain, [pr1, lens, gp], 64, kv2, 10),
                 mneed["bytes"] + B * 40,
                 OPS["mask_candidate"] * mneed["cand"] + OPS["mask_base"] * mneed["bases"],
                 lambda: tm.mask_segments(pr1, lens, gp, kv2, 10, MASK_CAP),
                 base and (lambda: base.mask(pr1, lens, gp, kv2, 10)))
    words = tm.shard_flags([pr1], lens, gp, [kv2])
    fneed = shard_flags_need([pr1], lens, [kv2], words)
    fops = OPS["mask_candidate"] * mneed["cand"]
    record("shard_flags", "shard_flags_wide", lambda: tm.shard_flags([pr1], lens, gp, [kv2]),
           lambda: _chunked(tm.shard_flags_plain, [pr1, gp], 64, kv2), fneed["bytes"], fops,
           None, base and (lambda: base.shard_flags([pr1], lens, gp, [kv2])))
    recs["shard_flags_wide"]["padded_bound_ms"] = bound(fneed["padded_bytes"], fops)["bound_ms"]
    # a later group's launch ORs into the words of the first: here into the
    # even rows' words, the odd rows' zeroed
    half = torch.where((torch.arange(B, device=dev) % 2 == 0)[:, None, None], words, 0)
    check(torch.equal(tm.shard_flags([pr1], lens, gp, [kv2], half), words),
          "4,096-row lane: shard_flags ORing into stored words differs from plain")
    del pr1, half
    fseg = record("mask_from_flags", "mask_from_flags_wide",
                  lambda: tm.mask_from_flags(words, lens, gp, NK, 10),
                  lambda: _chunked(lambda w, n, g: tm.mask_from_flags_plain(w, n, g, NK, 10),
                                   [words, lens, gp], 256),
                  flags_need(lens, NK) + B * 40, OPS["mask_base"] * int(lens.long().sum()),
                  lambda: tm.mask_from_flags(words, lens, gp, NK, 10, MASK_CAP),
                  base and (lambda: base.mask_from_flags(words, lens, gp, NK, 10)))
    check(torch.equal(fseg, seg), "4,096-row lane: mask from flags differs from mask+segments")
    check(int(seg[long_row, 4:6].max()) > tm.MASK_MAX_WIDTH,
          "4,096-row lane: the long row's chains end before 65,535")
    del words, gp, v, seg, fseg
    if shards:
        recs["shard_flags_wide"]["peak"] = sharded_peaks("the 4,096-row lane", codes, lens,
                                                         shards, base)
    del codes
    torch.cuda.empty_cache()
    return recs


def probe_long_rows(data: dict, codes, lens, reps=10, plain_reps=1) -> dict:
    """The probe on a batch with a row past what staging a tile's rows whole
    allowed, bit-equal to plain at strides 2 and 1, timed with its bound ->
    the stride-2 record (the stride-1 ms beside it)."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.index import index_to_torch

    index = index_to_torch(data["packed_kv2"], codes.device)
    rec = {}
    for stride in (2, 1):
        pr, err, ms, pms = _timed_pair(
            f"probe ({codes.shape[1]}-base rows, stride {stride})",
            lambda: tm.probe(codes, lens, stride, index),
            lambda: tm.probe_plain(codes, lens, stride, index), reps=reps, plain_reps=plain_reps)
        km, kok = tm.compute_kmers(codes, lens)
        rows = probe_rows(km[:, ::stride], kok[:, ::stride], index)
        del km, kok
        B, W = codes.shape
        rec[stride] = dict(err=err, ms=ms, plain_ms=pms, **bound(
            B * W + 4 * B + rows["rows"] * rows["sector_bytes_per_row"] + pr.numel() * 4,
            OPS["probe_base"] * B * W + OPS["probe_query"] * rows["valid"]))
        rec[stride]["shape"] = (f"kv2 table {tuple(index.table.shape)}, {B}x{W} codes (one "
                                f"row of {int(lens.max())} bases, {B - 1} of 150), stride {stride}")
        loaded = probe_row_loads(codes, lens, index, pr, stride)
        check(loaded == rows["rows"], f"probe (long rows, stride {stride}): the kernel loaded "
              f"{loaded} table rows, the lookup needs {rows['rows']}")
        say("14 multi-device", kernel="probe", rows=f"1x{int(lens.max())}+{B - 1}x150",
            width=W, stride=stride, valid_queries=rows["valid"], rows_needed=rows["rows"],
            rows_loaded=loaded, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            bound_ms=f"{rec[stride]['bound_ms']:.5f}", bound_by=rec[stride]["bound_by"],
            bound_share=f"{rec[stride]['bound_ms'] / ms:.4f}", max_abs_err=err)
        del pr
    del index
    torch.cuda.empty_cache()
    return dict(rec[2], err=max(rec[2]["err"], rec[1]["err"]), stride1_ms=rec[1]["ms"],
                stride1_bound_ms=rec[1]["bound_ms"])


def phase_multi_device(data: dict, smi_line: str) -> dict:
    """Phase 14: TorchEngine over a device list of 4 entries of the card,
    the multi-device dry run, --mesh through the CLI, a world-size-1 NCCL
    group, and the probe on a 250,000-base row -> the long-row probe's
    record and its launches."""
    import socket

    import torch
    import torch.distributed as dist

    from genefuserust_tpu_torch import cli, driver
    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu_torch.core.scanner import Scanner
    from genefuserust_tpu_torch.core.sequence import encode_bases, reverse_complement
    from genefuserust_tpu_torch.entry import dryrun_multichip
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.parallel import distributed
    from genefuserust_tpu_torch.parallel.engine import TorchEngine
    from genefuserust_tpu_torch.utils.synthetic import long_reads

    wd = os.path.join(data["workdir"], "multi_device")
    os.makedirs(wd)
    devices = ["cuda:0"] * MESH_ENTRIES

    def report(name):
        return (_TS.sub("<ts>", open(os.path.join(wd, f"{name}.html")).read()),
                strip_json(open(os.path.join(wd, f"{name}.json")).read()))

    # (a) the 262,144 pairs through the driver on 4 entries of the card: one
    # table, 4 upload and 4 compute streams, one 65,536-pair batch an entry
    cuda.reset_launches()
    t0 = time.perf_counter()
    with quiet(data):
        eng = driver.scan(driver.RunConfig(
            r1_file=data["r1"], r2_file=data["r2"], fusion_file=data["csv"],
            html=os.path.join(wd, "mesh.html"), json=os.path.join(wd, "mesh.json"),
            ref_file=data["fa"], devices=devices), " ".join(sys.argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for k in SCAN_KERNELS:
        check(launches[k] == data["cli_launches"][k],
              f"multi-device: kernel {k} launched {launches[k]} times, phase 5 "
              f"{data['cli_launches'][k]}")
    check(len(eng.devices) == MESH_ENTRIES and len(eng._tables) == 1
          and all(len(t["indexes"]) == 1 for t in eng._tables.values()),
          "multi-device: expected 4 entries and one table copy on the card")
    check(eng.entry_batches == [1] * MESH_ENTRIES,
          f"multi-device: batches per entry {eng.entry_batches}, expected one each")
    got = report("mesh")
    check(got[1] == data["cli_reports"][1], "multi-device: JSON differs from phase 5's")
    check(got[0] == data["cli_reports"][0], "multi-device: HTML differs from phase 5's")
    # warm: the kv2 table already on the card, as in phase 7
    mapper, blk = data["mapper"], data["blk"]
    weng = TorchEngine(Settings(), devices=devices)
    weng.use_packed(data["packed_kv2"], mapper=mapper)

    def scan() -> float:
        t = time.perf_counter()
        weng.scan_pair_block(mapper, blk)
        weng.flush(mapper)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    scan()
    warm = [scan() for _ in range(2)]
    n = len(blk.left.seq)
    say("14 multi-device", entries=",".join(devices), pairs=n, json="equal", html="equal",
        vs="phase 5 (one device)", wall_s=f"{wall:.2f}",
        phase5_wall_s=f"{data['cli_wall_s']:.2f}", index_s=f"{eng.table_seconds:.2f}",
        batches_per_entry=",".join(map(str, eng.entry_batches)),
        launches=json.dumps({k: launches[k] for k in SCAN_KERNELS}, separators=(",", ":")),
        warm_scan_s=",".join(f"{w:.3f}" for w in warm),
        warm_pairs_per_s=",".join(f"{n / w:.0f}" for w in warm),
        phase7_warm_scan_s=",".join(f"{w:.3f}" for w in data["warm_1"]),
        phase7_warm_pairs_per_s=",".join(f"{n / w:.0f}" for w in data["warm_1"]),
        card=repr(smi_line))
    del weng, eng
    torch.cuda.empty_cache()

    # (b) the dry run of the four multi-device paths on 4 entries of the card
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(MESH_ENTRIES)
    torch.cuda.synchronize()
    check(f"dryrun_multichip({MESH_ENTRIES}): ok" in out.getvalue(),
          "multi-device: dryrun_multichip did not report ok")
    say("14 multi-device", dryrun_multichip=MESH_ENTRIES, paths="pe,se,sharded-index,multi-csv",
        equal=True, seconds=f"{time.perf_counter() - t0:.1f}")

    # (c) --mesh through the CLI: 2 on a one-card machine exits with the JAX
    # driver's message; auto is the single-device engine with its launches
    args = ["-1", data["r1"], "-2", data["r2"], "-f", data["csv"], "-r", data["fa"],
            "-h", os.path.join(wd, "auto.html"), "-j", os.path.join(wd, "auto.json")]
    if torch.cuda.device_count() == 1:
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                cli.run([*args, "--mesh", "2"])
            check(False, "multi-device: --mesh 2 on one card did not exit")
        except SystemExit:
            pass
        # the CLI's command header, then the JAX driver's message
        check(out.getvalue().strip().splitlines()[-1] == "ERROR: --mesh 2 requested but only 1 "
              "devices are available, quit now", f"multi-device: --mesh 2 said {out.getvalue()!r}")
    cuda.reset_launches()
    with quiet(data):
        aeng = cli.run([*args, "--mesh", "auto"])
    torch.cuda.synchronize()
    auto = dict(cuda.LAUNCHES)
    check(len(aeng.devices) == 1 and aeng._entries[0].stream is None,
          "multi-device: --mesh auto on one card is not the single-device engine")
    check(all(auto[k] == data["cli_launches"][k] for k in SCAN_KERNELS),
          f"multi-device: --mesh auto launches differ from phase 5's: {auto}")
    check(report("auto") == data["cli_reports"], "multi-device: --mesh auto reports differ")
    say("14 multi-device", cli_mesh_2="exits with the JAX driver's message"
        if torch.cuda.device_count() == 1 else "not checked (more than one card)",
        cli_mesh_auto="one device", launches=json.dumps(
            {k: auto[k] for k in SCAN_KERNELS}, separators=(",", ":")))
    del aeng

    # (d) a world-size-1 NCCL group and one all_reduce on the card
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    check(distributed.init(init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                           backend="nccl"), "multi-device: distributed.init made no group")
    try:
        x = torch.arange(8, dtype=torch.int64, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        check(x.tolist() == list(range(8)), f"multi-device: all_reduce gave {x.tolist()}")
        mesh = distributed.make_mesh()
        say("14 multi-device", nccl_world_size=dist.get_world_size(),
            backend=dist.get_backend(), all_reduce="equal", mesh=repr(mesh.shape))
    finally:
        dist.destroy_process_group()

    # (e) a 250,000-base read (2,000 bases each side of the first planted
    # junction around a random middle) and 63 reads of 150 bases: the probe
    # against plain, then the pairs through TorchEngine on the card and on
    # the CPU
    contigs = mapper.contigs
    lb, rb = data["exons"][3][5] - 1, data["exons"][17][9] - 1
    _, longr = long_reads(contigs["c03"][lb - 2200 : lb + 1], contigs["c17"][rb : rb + 2200],
                          seed=data["seed"] + 2000, wide=LONG_READ)
    base = data["oracle_pairs"][: LONG_BATCH - 1]
    W = -(-LONG_READ // 32) * 32
    codes = np.full((LONG_BATCH, W), 255, np.uint8)
    codes[0, :LONG_READ] = encode_bases(longr)
    for i, p in enumerate(base):
        codes[i + 1, : len(p.left.seq)] = encode_bases(p.left.seq)
    lens = np.array([LONG_READ] + [len(p.left.seq) for p in base], np.int32)
    rec = probe_long_rows(data, torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda())
    read = SequenceRead("@long250k", longr, "+", "I" * LONG_READ)
    mate = SequenceRead("@long250k", reverse_complement(longr[-300:-150]), "+", "I" * 150)
    items = [SequenceReadPair(read, mate)] + base
    reps = {}
    for name in ("cpu", "cuda"):
        leng = TorchEngine(Settings(), device=name)
        leng.use_packed(data["packed_kv2"])
        if name == "cuda":
            cuda.reset_launches()
        with quiet(data):
            Scanner(data["csv"], contigs, os.path.join(wd, f"l{name}.html"),
                    os.path.join(wd, f"l{name}.json"), Settings(), engine=leng,
                    command="long").scan_pairs(items)
        torch.cuda.synchronize()
        reps[name] = report(f"l{name}")
    long_launches = dict(cuda.LAUNCHES)
    check(reps["cuda"] == reps["cpu"],
          "multi-device: the 250,000-base scan's reports differ from --device cpu's")
    check(long_launches["probe"] > 0, "multi-device: the long-read scan launched no probe")
    say("14 multi-device", long_read=LONG_READ, pairs=len(items), reports_vs_cpu="equal",
        launches=json.dumps(long_launches, separators=(",", ":")))
    return dict(rec=rec, launches=long_launches["probe"])


# ---------------- phase 15: the single-probe layouts ----------------


@contextlib.contextmanager
def pack_timers():
    """Inside the block, time the port's table builder as the engine calls
    it, its single-hash placement (the vectorised h1 pass, the rescue loop
    and the walk) and the walk alone -> {"pack_s", "place_s", "walk_s",
    "walks"}, filled as they run."""
    from genefuserust_tpu_torch.ops import hashtable as th
    from genefuserust_tpu_torch.ops import index as tindex
    from genefuserust_tpu_torch.parallel import engine as teng

    spent = dict(pack_s=0.0, place_s=0.0, walk_s=0.0, walks=0)
    saved = teng.build_packed_index, tindex._place_single_hash, th._spill_walk

    def timed(fn, key):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
                spent["walks"] += key == "walk_s"
        return run

    teng.build_packed_index = timed(saved[0], "pack_s")
    tindex._place_single_hash = timed(saved[1], "place_s")
    th._spill_walk = timed(saved[2], "walk_s")
    try:
        yield spent
    finally:
        teng.build_packed_index, tindex._place_single_hash, th._spill_walk = saved


def single_table_stats(index) -> dict:
    """A single-probe table's flagged rows and spilled keys (keys in a row
    other than their h1 bucket's), counted on the card."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.hashtable import OVF_PAYLOAD

    S, nb = index.S, index.table.shape[0]
    flagged = index.table[:, 2 * S - 1] == OVF_PAYLOAD
    spilled = 0
    for r0 in range(0, nb, 1 << 22):
        rows = index.table[r0 : r0 + (1 << 22)]
        keys, pay = rows[:, :S], rows[:, S:]
        live = (pay != 0) & ~((pay == OVF_PAYLOAD) & (torch.arange(S, device=pay.device) == S - 1))
        b1, _ = tm.buckets(keys.to(torch.int64) & tm.M32, index.shift)
        home = torch.arange(r0, r0 + rows.shape[0], device=rows.device)[:, None]
        spilled += int((live & (b1 != home)).sum())
    return dict(flagged=int(flagged.sum()), flagged_share=float(flagged.double().mean()),
                spilled_keys=spilled)


def single_rows(km, ok, index) -> dict:
    """The rows a single-probe lookup of the valid k-mers `km[ok]` needs,
    from the plain version's buckets and the table: one each, and a second
    (need2) where the h1 row is flagged and no slot matched with a nonzero
    payload sum; each row's whole 32-byte sectors (kvs one, kv16 two); and
    those rows in query order (h1, then h2 where needed) as gather rows,
    the last tile topped up with the first rows."""
    import torch

    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.hashtable import OVF_PAYLOAD
    from genefuserust_tpu_torch.profiling import gather_floor as gf

    k = km[ok]
    b1, b2 = tm.buckets(k, index.shift)
    r1 = index.table[b1]
    need2 = (r1[:, -1] == OVF_PAYLOAD) & (tm._row_payload(r1, tm._i32(k)) == 0)
    rows = torch.stack([b1, torch.where(need2, b2, -1)], 1).reshape(-1)
    rows = rows[rows >= 0].to(torch.int32)
    n = int(k.shape[0]) + int(need2.sum())
    check(rows.shape[0] == n, "single_rows: gather rows differ from valid + need2")
    return dict(valid=int(k.shape[0]), need2=n - int(k.shape[0]), rows=n,
                sector_bytes_per_row=-(-4 * index.table.shape[1] // SECTOR) * SECTOR,
                gather=torch.cat([rows, rows[: (-n) % gf.TILE]]).contiguous())


def variant_registers(name: str, lib: str = None) -> dict:
    """{mangled kernel: registers a thread} of the port's build (or of the
    library `lib`), for the kernels whose name holds `name` (ptxas's
    report in `<lib>.log`)."""
    from genefuserust_tpu_torch.ops import cuda

    regs, cur = {}, None
    for line in open((lib or cuda.build()) + ".log"):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    return regs


def phase_layouts(data: dict, smi_line: str) -> dict:
    """Phase 15: phase 5's CLI job with GENEFUSE_TABLE_LAYOUT pinned to kvs
    and to kv16, its reports and stdout equal to the kv2 job's and the
    pack timed; then phase 3's first batch probed on the job's own table
    (the probe's single-probe variant) at strides 2 and 1, bit-equal to
    plain and to the kv2 table's results, its rows loaded equal to valid +
    need2 and the sectors it requested beside those rows' whole sectors,
    timed beside kv2's, the gather floor over the same rows and (with
    --wide-baseline) the parent's kernel -> the kernels' records and their
    launches (the CLI jobs', each its main path)."""
    import torch

    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.ops import cuda
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.index import index_to_torch, layout_name
    from genefuserust_tpu_torch.profiling import gather_floor as gf
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # registers a thread, and the variant's blocks an SM's 65,536 registers
    # hold (allocated 8 a thread at a time)
    regs = {4 if kern.startswith("_ZN2gf19probe_single_kernelILi4E") else 8: n
            for kern, n in variant_registers("probe_single_kernel").items()}
    for kern, n in sorted(variant_registers("probe_single_kernel").items()):
        say("15 layouts", kernel=kern, registers=n, threads=SINGLE_THREADS,
            blocks_per_sm_by_registers=65536 // (SINGLE_THREADS * (-(-n // 8) * 8)))
    base = wide_base(data)
    codes, lens = data["probe_codes"]
    B, W = codes.shape
    kv2 = index_to_torch(data["packed_kv2"], dev)
    rec, launches, kv2_out, kv2_ms, kv2_rows = {}, {}, {}, {}, {}
    km, kok = tm.compute_kmers(codes, lens)
    for stride in (2, 1):
        kv2_out[stride] = tm.probe(codes, lens, stride, kv2)
        kv2_ms[stride] = event_ms(lambda: tm.probe(codes, lens, stride, kv2), 20)
        kv2_rows[stride] = probe_rows(km[:, ::stride], kok[:, ::stride], kv2)["rows"]
    del kv2
    for layout in ("kvs", "kv16"):
        # (a) phase 5's CLI job with the layout pinned: its reports, its
        # launches (the main path) and its pack
        wd = os.path.join(data["workdir"], layout)
        os.makedirs(wd)
        html, js = os.path.join(wd, "out.html"), os.path.join(wd, "out.json")
        os.environ["GENEFUSE_TABLE_LAYOUT"] = layout
        cuda.reset_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        try:
            with pack_timers() as spent, contextlib.redirect_stdout(out):
                engine = cli.run(["-1", data["r1"], "-2", data["r2"], "-f", data["csv"],
                                  "-r", data["fa"], "-h", html, "-j", js])
            torch.cuda.synchronize()
        finally:
            del os.environ["GENEFUSE_TABLE_LAYOUT"]
        wall = time.perf_counter() - t0
        ran = dict(cuda.LAUNCHES)
        (entry,) = engine._tables.values()
        packed, (index,) = entry["packed"], entry["indexes"].values()
        name = cuda.probe_name(index)
        check(layout_name(packed) == layout,
              f"layouts: the {layout} job's pack fell through to {layout_name(packed)}")
        check(index.single_probe and index.S == {"kvs": 4, "kv16": 8}[layout],
              f"layouts: the {layout} table is not single-probe (S {index.S})")
        check(ran[name] > 0 and ran["probe"] == 0,
              f"layouts: the {layout} CLI job launched {name} {ran[name]} times, "
              f"probe {ran['probe']} times")
        for k in SCAN_KERNELS[1:]:
            check(ran[k] > 0, f"layouts: the {layout} CLI job did not launch {k}")
        check(_TS.sub("<ts>", open(html).read()) == data["cli_reports"][0],
              f"layouts: the {layout} job's HTML differs from the kv2 job's")
        check(strip_json(open(js).read()) == data["cli_reports"][1],
              f"layouts: the {layout} job's JSON differs from the kv2 job's")
        check(strip_stdout(out.getvalue()) == data["cli_stdout"],
              f"layouts: the {layout} job's stdout differs from the kv2 job's")
        launches[name] = ran[name]
        stats = single_table_stats(index)
        pack_s = spent["pack_s"]
        say("15 layouts", layout=layout, cli_pairs=len(data["block"][0]), wall_s=f"{wall:.2f}",
            index_s=f"{engine.table_seconds:.2f}", reports="equal to the kv2 job's",
            stdout="equal to the kv2 job's",
            launches=json.dumps({k: ran[k] for k in (name, *SCAN_KERNELS[1:])},
                                separators=(",", ":")), card=repr(smi_line))
        say("15 layouts", layout=layout, pack_s=f"{pack_s:.2f}",
            place_s=f"{spent['place_s']:.2f}", place_share=f"{spent['place_s'] / pack_s:.3f}",
            walk_s=f"{spent['walk_s']:.3f}", walk_share=f"{spent['walk_s'] / pack_s:.4f}",
            walk_ran=spent["walks"] > 0, n_buckets=packed.n_buckets,
            table=tuple(packed.kv_tbl.shape), bytes=packed.nbytes,
            flagged_buckets=stats["flagged"], flagged_share=f"{stats['flagged_share']:.6f}",
            spilled_keys=stats["spilled_keys"])
        # (b) phase 3's first batch at strides 2 and 1 on the job's table
        r = dict(err=0, registers=regs[index.S])
        for stride in (2, 1):
            got, err, ms, pms = _timed_pair(
                f"{name} stride {stride}", lambda: tm.probe(codes, lens, stride, index),
                lambda: tm.probe_plain(codes, lens, stride, index))
            check(torch.equal(got, kv2_out[stride]),
                  f"{name} stride {stride}: results differ from the kv2 table's")
            rows = single_rows(km[:, ::stride], kok[:, ::stride], index)
            loaded, sectors = probe_row_loads(codes, lens, index, got, stride, sectors=True)
            check(loaded == rows["rows"], f"{name} stride {stride}: the kernel loaded {loaded} "
                                          f"table rows, valid + need2 is {rows['rows']}")
            # the sectors of the rows needed, whole (kvs one a row, kv16 two)
            need_sectors = rows["rows"] * rows["sector_bytes_per_row"] // SECTOR
            # codes and lengths in, each row needed in whole 32-byte sectors
            # (kvs one, kv16 two), the results out
            b = bound(B * W + 4 * B + rows["rows"] * rows["sector_bytes_per_row"]
                      + got.numel() * 4,
                      OPS["probe_base"] * B * W + OPS["probe_query"] * rows["valid"])
            # the gather floor over the same rows in query order, whole rows
            floor = gf.measure(rows["gather"], index.table)
            # the parent's kernel on the same inputs, between two timings of
            # this checkout's
            parent = again = None
            if base:
                parent = parent_ms(f"{name} stride {stride}",
                                   lambda: base.probe(codes, lens, stride, index), got, 20)
                again = event_ms(lambda: tm.probe(codes, lens, stride, index), 20)
            r["err"] = max(r["err"], err)
            if stride == 2:
                r.update(ms=ms, plain_ms=pms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         rows_needed=rows["rows"], rows_loaded=loaded, kv2_ms=kv2_ms[2],
                         kv2_rows_needed=kv2_rows[2], sectors_requested=sectors,
                         sectors_needed=need_sectors, gather_floor_ms=floor["ms"],
                         shape=f"{layout} table {tuple(index.table.shape)}, {B}x{W} codes, "
                               f"stride 2")
                if base:
                    r.update(parent_ms=parent, again_ms=again)
            else:
                r.update(stride1_ms=ms, stride1_bound_ms=b["bound_ms"])
            say("15 layouts", kernel=name, stride=stride, equal_to_plain=True,
                equal_to_kv2=True, valid_queries=rows["valid"], need2=rows["need2"],
                rows_needed=rows["rows"], rows_loaded=loaded, kv2_rows_needed=kv2_rows[stride],
                sectors_requested=sectors, sectors_needed=need_sectors,
                sectors_share=f"{sectors / need_sectors:.4f}",
                ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", kv2_ms=f"{kv2_ms[stride]:.4f}",
                bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
                bound_share=f"{b['bound_ms'] / ms:.4f}",
                gather_floor_ms=f"{floor['ms']:.4f}",
                floor_over_probe=f"{floor['ms'] / ms:.4f}",
                **({} if not base else dict(parent_ms=f"{parent:.4f}", again_ms=f"{again:.4f}",
                                            baseline=base.csrc)),
                max_abs_err=err, card=repr(smi_line))
            del got
        rec[name] = r
        del engine, entry, packed, index
        torch.cuda.empty_cache()
    say("15 layouts", phase_wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return dict(rec=rec, launches=launches)

MERGE_KERNELS = ("merge_bytes", "merge_codes", "merge_rows")


def phase_device_merge(data: dict, smi_line: str) -> dict:
    """Phase 16: profiling/device_merge.run on phase 3's first 65,536 pairs
    and the kv2 table, which drives the device merge's path once with the
    launch counts set to 0 first and checks (a)-(d) (it raises on any
    difference; with --wide-baseline it also times the parent's row gather
    on the three row passes) -> the three kernels' records and their
    launches on that path."""
    import torch

    from genefuserust_tpu_torch.ops.index import index_to_torch
    from genefuserust_tpu_torch.profiling import device_merge

    t_phase = time.perf_counter()
    index = index_to_torch(data["packed_kv2"], torch.device("cuda"))
    base = wide_base(data)
    r = device_merge.run([a[:BATCH] for a in data["block"]], index,
                         others=dict(parent=base.active) if base else None)
    ran = r["launches"]
    for k in MERGE_KERNELS:
        check(ran[k] > 0, f"device merge: its path did not launch {k}")
    say("16 device merge", pairs=r["pairs"], L=r["L"], equal="(a) (b) (c) (d)",
        merged_lane_vote_width=r["merged_lane_vote_width"],
        launches=json.dumps(ran, separators=(",", ":")),
        checks=json.dumps(r["checks"], separators=(",", ":")))
    for k in MERGE_KERNELS:
        v = r["kernels"][k]
        say("16 device merge", kernel=k, shape=repr(v["shape"]), ms=f"{v['ms']:.4f}",
            plain_ms=f"{v['plain_ms']:.4f}", bound_ms=f"{v['bound_ms']:.5f}",
            bound_by=v["bound_by"], bound_share=f"{v['bound_ms'] / v['ms']:.4f}",
            bytes=v["bytes"], ops=v["ops"], max_abs_err=0, card=repr(smi_line),
            **{x: (f"{v[x]:.4f}" if isinstance(v[x], float) else v[x]) for x in v
               if x not in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes", "ops", "shape",
                            "err", "rows", "width")})
    say("16 device merge", pass1_lanes=json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r["pass1_lanes"].items()},
        separators=(",", ":")), card=repr(smi_line))
    h = r["host"]
    say("16 device merge", host_pack_pe_batch_s=f"{h['pack_pe_batch_s']:.4f}",
        host_merge_pack_pe_batch_s=f"{h['merge_pack_pe_batch_s']:.4f}",
        pack_all_s=",".join(f"{x:.4f}" for x in h["pack_pe_batch_all_s"]),
        merge_pack_all_s=",".join(f"{x:.4f}" for x in h["merge_pack_pe_batch_all_s"]),
        device_merge_ms=f"{r['kernels']['merge_codes']['no_lanes_ms']:.4f}",
        device_fused_pass1_ms=f"{r['pass1_lanes']['fused_pass1_chunked_ms']:.4f}",
        h2d=json.dumps({k: round(v, 4) if isinstance(v, float) else v
                        for k, v in r.get("h2d", {}).items()}, separators=(",", ":")),
        card=repr(smi_line))
    say("16 device merge", phase_wall_s=f"{time.perf_counter() - t_phase:.1f}")
    del index
    torch.cuda.empty_cache()
    return dict(rec=r["kernels"], launches={k: ran[k] for k in MERGE_KERNELS})


# phase 17: tables past the 2^31- and 2^32-byte marks, made on the card
# from the panel's kv2 table (profiling/large_tables.py): kv2 at 2^30 rows
# of 8 bytes (8 GiB), split at 2^28 buckets (8 GiB of keys, 16 GiB of
# vals) with its dupe rows from row 2^25 on (64-byte rows: 2 GiB in)
LARGE_KV_LOG2 = 30
LARGE_SPLIT_LOG2 = 28
LARGE_DUPE_BASE = 1 << 25


def phase_large_tables(data: dict, smi_line: str) -> dict:
    """Phase 17: phase 3's batch probed (strides 2 and 1) on a kv2 and a
    split table past 4 GiB, each launch bit-equal to plain, the rows it
    reads past the 2^31- and 2^32-byte marks counted from the plain
    version's buckets and its own count of rows loaded equal to them; on
    the split table the vote, mask+segments and the shard flags, whose
    dupe rows lie past 2^31 bytes, bit-equal to plain; the probe timed on
    the 8 GiB kv2 table beside phase 3's 512 MiB one -> the phase's
    record."""
    import torch

    from genefuserust_tpu_torch.config import PASS1_STEP
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.index import index_to_torch
    from genefuserust_tpu_torch.profiling import large_tables as lt
    from genefuserust_tpu_torch.profiling.gather_floor import event_ms

    t_phase = time.perf_counter()
    codes, lens = data["probe_codes"]
    index = index_to_torch(data["packed_kv2"], codes.device)
    out = {}

    def probed(table, name, stride):
        got, exp = tm.probe(codes, lens, stride, table), tm.probe_plain(codes, lens, stride, table)
        check(torch.equal(got, exp), f"large tables: the probe on {name} differs from plain "
                                     f"at stride {stride} (max_abs_err {max_abs_err(got, exp)})")
        rows = lt.rows_probed(table, codes, lens, stride)
        check(rows["past_2_31"] > 0 and rows["past_2_32"] > 0,
              f"large tables: no row of {name} read past 2^32 bytes: {rows}")
        loaded = probe_row_loads(codes, lens, table, got, stride=stride)
        check(loaded == rows["rows"],
              f"large tables: the probe loaded {loaded} rows of {name}, the lookup needs "
              f"{rows['rows']}")
        tb = sum(t.numel() * 4 for t in (table.table, table.vals, table.dupes))
        say("17 large tables", table=name, stride=stride, table_bytes=tb,
            shape=tuple(table.table.shape), equal=True, rows_loaded=loaded, **rows)
        return got, rows, tb

    t0 = time.perf_counter()
    kv, left_out = lt.widen_kv(index, LARGE_KV_LOG2)
    torch.cuda.synchronize()
    say("17 large tables", table="kv2", build_s=f"{time.perf_counter() - t0:.2f}",
        entries=int((index.table[:, 1] != 0).sum()), left_out=left_out)
    for stride in (PASS1_STEP, 1):
        _, rows, tb = probed(kv, "kv2", stride)
        out[f"kv2_stride{stride}"] = dict(rows, table_bytes=tb)
    ms = event_ms(lambda: tm.probe(codes, lens, PASS1_STEP, kv), 20)
    base_ms = event_ms(lambda: tm.probe(codes, lens, PASS1_STEP, index), 20)
    base_rows = lt.rows_probed(index, codes, lens, PASS1_STEP)["rows"]
    kv_rows = out[f"kv2_stride{PASS1_STEP}"]["rows"]
    out["kv2_probe"] = dict(ms=ms, rows=kv_rows, ps_per_row=ms * 1e9 / kv_rows,
                            panel_table_ms=base_ms, panel_table_rows=base_rows,
                            panel_table_ps_per_row=base_ms * 1e9 / base_rows)
    say("17 large tables", kernel="probe", table="kv2", table_bytes=tb, stride=PASS1_STEP,
        ms=f"{ms:.4f}", rows=kv_rows, ps_per_row=f"{ms * 1e9 / kv_rows:.2f}",
        panel_table_bytes=index.table.numel() * 4, panel_table_ms=f"{base_ms:.4f}",
        panel_table_rows=base_rows, panel_table_ps_per_row=f"{base_ms * 1e9 / base_rows:.2f}",
        card=repr(smi_line))
    del kv
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sp, left_out = lt.widen_split(index, LARGE_SPLIT_LOG2, LARGE_DUPE_BASE)
    torch.cuda.synchronize()
    say("17 large tables", table="split", build_s=f"{time.perf_counter() - t0:.2f}",
        left_out=left_out, dupe_rows=sp.dupes.shape[0], dupe_base=LARGE_DUPE_BASE)
    pr2, rows, tb = probed(sp, "split", PASS1_STEP)
    check(rows["vals_past_2_32"] > 0, f"large tables: no vals row read past 2^32 bytes: {rows}")
    out["split_stride2"] = dict(rows, table_bytes=tb)
    pr1, rows, _ = probed(sp, "split", 1)
    out["split_stride1"] = dict(rows, table_bytes=tb)
    # the dupe-row readers, their rows past 2^31 bytes
    named = {s: lt.dupe_rows_named(sp, pr) for s, pr in ((PASS1_STEP, pr2), (1, pr1))}
    for s, n in named.items():
        check(n["dupe_past_2_31"] > 0,
              f"large tables: no dupe row past 2^31 bytes at stride {s}: {n}")
    v = tm.vote(pr2, sp, 40, 20)
    check(torch.equal(v, tm.vote_plain(pr2, sp, 40, 20)),
          "large tables: the vote on the split table differs from plain")
    check(bool((v[:, 0] != 0).any()), "large tables: no row passed the vote's gate")
    gp = v[:, 1:5].contiguous()
    seg = tm.mask_segments(pr1, lens, gp, sp, 10)
    check(torch.equal(seg, tm.mask_segments_plain(pr1, lens, gp, sp, 10)),
          "large tables: mask_segments on the split table differs from plain")
    words = tm.shard_flags([pr1], lens, gp, [sp])
    check(torch.equal(words, tm.shard_flags_plain(pr1, gp, sp)),
          "large tables: shard_flags on the split table differs from plain")
    out["dupes"] = dict(dupes_bytes=sp.dupes.numel() * 4, **{f"stride{s}": n
                                                             for s, n in named.items()})
    say("17 large tables", table="split", readers="vote, mask_segments, shard_flags",
        equal=True, survivors=int((v[:, 0] != 0).sum()),
        two_segment_rows=int((seg[:, 0] & seg[:, 1]).sum()), dupes_bytes=sp.dupes.numel() * 4,
        **{f"{k}_stride{s}": x for s, n in named.items() for k, x in n.items()})
    del sp, pr1, pr2, words, index
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    say("17 large tables", phase_wall_s=f"{out['phase_wall_s']:.1f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    sweeps = ap.add_mutually_exclusive_group()
    sweeps.add_argument("--probe-sweep", action="store_true",
                        help="phases 1-3 and the probe's launch-shape sweep, then stop")
    sweeps.add_argument("--gather-sweep", action="store_true",
                        help="phases 1-3 and the gather's launch-shape sweep, then stop")
    sweeps.add_argument("--profile-only", action="store_true",
                        help="phase 1, the kv2 table and phase 7, then stop")
    sweeps.add_argument("--glue-sweep", action="store_true",
                        help="phases 1-3 and the compaction's tile sweep, then stop")
    ap.add_argument("--glue-baseline", metavar="DIR",
                    help="another checkout's csrc/: phase 3 also times its fused_glue.cu's "
                         "lane unpack and compaction with its survivor rows")
    ap.add_argument("--wide-baseline", metavar="DIR",
                    help="another checkout's csrc/: phases 3, 13, 15 and 16 also time its "
                         "probe.cu's, vote.cu's, mask_segments.cu's and merge.cu's kernels "
                         "on the same inputs, and compare probe_kernel's, vote_kernel's and "
                         "mask_segments_kernel's SASS")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    smi_line = phase_device()
    if not args.profile_only:
        phase_build()
    build_dir = os.path.join(REPO, "genefuserust_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke-", dir=build_dir)
    log = open(os.path.join(workdir, "reports.log"), "w")
    try:
        from genefuserust_tpu_torch.config import Settings
        from genefuserust_tpu_torch.core.mapper import FusionMapper
        from genefuserust_tpu_torch.io import fasta
        from genefuserust_tpu_torch.utils.synthetic import gen_block

        t0 = time.perf_counter()
        fa, csv, exons = write_panel(workdir, args.seed)
        mapper = FusionMapper(fasta.read_all(fa, force_upper_case=False), csv, Settings())
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blk = gen_block(mapper, CLI_PAIRS, 150, seed=args.seed)
        block = [blk.left.seq, blk.left.qual, blk.left.lens,
                 blk.right.seq, blk.right.qual, blk.right.lens]
        plant_fusions(mapper.contigs, exons, block[0], block[1], block[3], block[4])
        say("3 kernels", setup="data", panel_and_index_s=f"{index_s:.1f}",
            reads_s=f"{time.perf_counter() - t0:.1f}", pairs=CLI_PAIRS)
        data = dict(seed=args.seed, workdir=workdir, fa=fa, csv=csv, exons=exons,
                    mapper=mapper, blk=blk, block=block, log=log,
                    probe_sweep=args.probe_sweep, glue_baseline=args.glue_baseline,
                    wide_baseline=args.wide_baseline)
        if args.profile_only:
            pack_kv2(data)
            phase_profile(data)
            print(smi_line)
            return 0
        rec = phase_kernels(data)
        if args.gather_sweep:
            for case, res in sweep_gather(data).items():
                best = min(res, key=res.get)
                say("8 gather", case=case, sweep="blocks a tile, row loads a thread",
                    sweep_ms=json.dumps({k: round(v, 4) for k, v in res.items()},
                                        separators=(",", ":")),
                    best=repr(best), best_ms=f"{res[best]:.4f}", equal=True)
        if args.glue_sweep:
            for label, res in sweep_glue(data).items():
                best = min(res, key=res.get)
                say("3 kernels", kernel="compact", batch=label, sweep="rows a tile",
                    sweep_ms=json.dumps({k: round(v, 5) for k, v in res.items()},
                                        separators=(",", ":")),
                    best=best, best_ms=f"{res[best]:.5f}", equal=True)
        if args.probe_sweep:
            for layout, res in sweep_probe_single(data).items():
                best = min(res, key=lambda k: res[k][0])
                say("15 layouts", kernel=f"probe_{layout}",
                    sweep="queries a thread, threads a block: [ms, registers]",
                    sweep_ms=json.dumps(res, separators=(",", ":")), best=repr(best),
                    best_ms=f"{res[best][0]:.4f}", equal=True, card=repr(smi_line))
        if args.probe_sweep or args.gather_sweep or args.glue_sweep:
            print(smi_line)
            return 0
        phase_golden(data)
        launches = phase_cli(data, smi_line)
        phase_oracle(data)
        phase_profile(data)
        gather = phase_gather(data)
        edit = phase_edit(data)
        rich_launches = phase_rich(data)
        phase_multi(data, smi_line)
        phase_single(data, smi_line)
        sharded = phase_sharded(data, smi_line)
        multi_device = phase_multi_device(data, smi_line)
        layouts = phase_layouts(data, smi_line)
        device_merge = phase_device_merge(data, smi_line)
        phase_large_tables(data, smi_line)
    finally:
        log.close()
        shutil.rmtree(workdir, ignore_errors=True)
    replaces = {
        "probe": "genefuserust_tpu/ops/pallas_lookup.py:102",
        "vote": "genefuserust_tpu/ops/map_read.py:396",
        "mask_segments": "genefuserust_tpu/ops/map_read.py:439",
        "gather_sum": "tools/profiling/profile_dma_ring.py:35, "
                      "tools/profiling/profile_pallas_gather.py:46",
        "edit_distance": "genefuserust_tpu/ops/edit_distance.py:43",
        "probe_split": "genefuserust_tpu/ops/pallas_lookup.py:102",
        "vote_counts": "genefuserust_tpu/parallel/sharded_index.py:209",
        "merge_top2": "genefuserust_tpu/parallel/sharded_index.py:273",
        "shard_flags": "genefuserust_tpu/parallel/sharded_index.py:230",
        "mask_from_flags": "genefuserust_tpu/parallel/sharded_index.py:242",
        "vote_wide": "genefuserust_tpu/ops/map_read.py:396",
        "vote_counts_wide": "genefuserust_tpu/parallel/sharded_index.py:209",
        "mask_segments_wide": "genefuserust_tpu/ops/map_read.py:439",
        "shard_flags_wide": "genefuserust_tpu/parallel/sharded_index.py:230",
        "mask_from_flags_wide": "genefuserust_tpu/parallel/sharded_index.py:242",
        "probe_long": "genefuserust_tpu/ops/pallas_lookup.py:102",
        "lane_unpack": "genefuserust_tpu/ops/fused.py:488",
        "lane_exceptions": "genefuserust_tpu/ops/fused.py:493",
        "compact_count": "genefuserust_tpu/ops/fused.py:560",
        "compact_place": "genefuserust_tpu/ops/fused.py:509",
        "survivor_rows": "genefuserust_tpu/ops/fused.py:523",
        "probe_kvs": "genefuserust_tpu/ops/map_read.py:166 (kvs_lookup, via "
                     "_single_probe_lookup :178)",
        "probe_kv16": "genefuserust_tpu/ops/map_read.py:155 (kv16_lookup, via "
                      "_single_probe_lookup :178)",
        "merge_bytes": "genefuserust_tpu/ops/merge.py:42 (merge_batch)",
        "merge_codes": "genefuserust_tpu/ops/fused.py:51 (_merge_codes, with the front of "
                       "fused_pass1 :133 and fused_merge_chunked :262)",
        "merge_rows": "genefuserust_tpu/ops/fused.py:305,337,369 (the rows of "
                      "pass1_rows_merged, pass1_rows_packed, fused_pass2_combined)",
    }
    sources = dict(probe_split="probe", probe_long="probe", probe_kvs="probe",
                   probe_kv16="probe", vote_counts="vote", merge_top2="vote",
                   vote_wide="vote", vote_counts_wide="vote", shard_flags="mask_segments",
                   mask_from_flags="mask_segments", mask_segments_wide="mask_segments",
                   shard_flags_wide="mask_segments", mask_from_flags_wide="mask_segments",
                   **{k: "fused_glue" for k in GLUE_KERNELS},
                   **{k: "merge" for k in MERGE_KERNELS})
    # launches: each kernel's count over phase 5's CLI scan, the main path;
    # gather_sum is off it, so its count is that of its own entry point
    # (phase 8), and survivor_rows, which the main path leaves to the
    # place launch, that of phase 3's 12-lane fused_scan_lanes call (its
    # rows of lanes 8-11). No single PyTorch call computes the other
    # functions than survivor_rows (index_select; the compaction's argsort
    # is on its "pair" record) (library_ms null): see PERF.md's kernel
    # table for each reason.
    rec["gather_sum"] = dict(gather, shape="int32[2^22, 128] table, 2^17 rows, 1 lane")
    rec["edit_distance"] = dict(edit, err=max(edit["err"], data["ed_err"]),
                                main_path_flushes=data["ed_main"],
                                fusion_rich_launches=rich_launches["edit_distance"])
    launches = dict(launches, gather_sum=gather["launches"],
                    survivor_rows=data["rows_path_launches"]["survivor_rows"])
    # phase 13's kernels: launches over its 4-shard paired scan (probe_split
    # and the sharded stages) and over its wide-read scans (the wide paths)
    rec.update(sharded["rec"])
    launches.update({k: sharded["launches"][k] for k in sharded["rec"]})
    # phase 14 (e): the probe on the 250,000-base row, launches over its scan
    rec["probe_long"] = multi_device["rec"]
    launches["probe_long"] = multi_device["launches"]
    # phase 15: the single-probe variant, launches over each layout's CLI job
    rec.update(layouts["rec"])
    launches.update(layouts["launches"])
    # phase 16: the device merge, launches over its path's one run
    rec.update(device_merge["rec"])
    launches.update(device_merge["launches"])
    extra = ("shape", "wide", "rows_needed", "rows_loaded", "sectors_requested", "sectors_needed",
             "gather_floor_ms", "registers", "packed_parent_ms", "pass2_parent_ms",
             "h1_hit_share", "main_path_flushes",
             "fusion_rich_launches", "hits", "stride1_ms", "stride1_bound_ms", "edge_ms",
             "pair", "library_with_build_ms", "padded_bound_ms", "global_ms", "parent_ms",
             "again_ms", "device_ms", "rows4096", "peak", "sass", "kv2_ms", "kv2_rows_needed",
             "no_lanes_ms", "no_lanes_bound_ms", "packed_ms", "pass2_ms")
    kernels = [
        dict(name=k, route="cuda",
             source=f"genefuserust_tpu_torch/csrc/{sources.get(k, k)}.cu",
             replaces=replaces[k], launches=launches[k], max_abs_err=rec[k]["err"],
             ms=round(rec[k]["ms"], 6), plain_ms=round(rec[k]["plain_ms"], 6),
             bound_ms=round(rec[k]["bound_ms"], 6), bound_by=rec[k]["bound_by"],
             library_ms=(None if rec[k].get("library_ms") is None
                         else round(rec[k]["library_ms"], 6)),
             **{x: rec[k][x] for x in extra if x in rec[k]})
        for k in replaces
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
