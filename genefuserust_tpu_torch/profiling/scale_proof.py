"""Whole-genome scale proof of the port on the card.

Port of the JAX package's tools/scale_proof.py, with its flags and
defaults. It runs the two genome-scale parts of the system at full size:

  (a) the whole-genome Matcher (core/matcher.py) over a synthetic genome
      of --genome-mbp (1 Gbp), built from 200 candidate reads, then 50
      do_match queries: host code;
  (b) a --panel-mbp (256 Mbp) panel tiled over that genome in 2 Mbp genes
      (two exons each), indexed by FusionMapper, then 46 read pairs (6
      across a planted chr1/chr2 junction) scanned three ways on the same
      mapper: the host oracle (core/scanner.HostEngine); the
      contig-sharded index over --shards tables on one card
      (parallel/sharded_engine.ShardedIndexEngine, batch 64); and, once
      those tables are freed, one table through TorchEngine, the default
      engine, whose layout ops/index.build_packed_index picks down its
      fallback chain. Both device reports must equal the oracle's
      (timestamps stripped) and the planted fusion must be found. Then the
      probe is timed on one 65,536-pair batch (utils/synthetic.gen_block,
      stride 2) against that table, with the rows it needs, its sector
      bound and the gather floor over the same rows.

    python -m genefuserust_tpu_torch.profiling.scale_proof [--genome-mbp 1000]
        [--panel-mbp 256] [--shards 8] [--skip-matcher] [--matcher-note TEXT]
        [--device cuda|cpu] [--out FILE] [--reports DIR] [--probe-pairs 65536]

--panel-mbp 0 runs part (a) alone; --skip-matcher runs part (b) alone and
puts --matcher-note in the record. The record is one JSON line, printed
before the last line (the card's nvidia-smi name and power limit) and,
with --out, written to that file. It names the card, the host's cores and
RAM, each stage's seconds and peak RSS, the tables' bytes, the layout
picked and the seconds of each layout tried. It runs on the card unless
--device cpu is given (the plain versions of the kernels; the tests'
size); without a card and without --device cpu it exits with code 2. A
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import resource
import sys
import tempfile
import time

import numpy as np
import torch

GENE_LEN = 2_000_000
TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ [+-]\d{2}:\d{2}")
# the sharded path's card steps (LAUNCHES keys; its probe counts as "probe")
SHARDED_KERNELS = ("probe", "vote_counts", "merge_top2", "shard_flags", "mask_from_flags")
SECTOR = 32


def rss_gb() -> float:
    """Peak resident set of this process so far, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def rss_now_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def mem_available_gb() -> float:
    """The host's MemAvailable (/proc/meminfo), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def host_info() -> dict:
    return dict(cores=os.cpu_count(), cores_usable=len(os.sched_getaffinity(0)),
                ram_gb=round(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9, 1))


def gen_genome(mbp: float, n_contigs: int = 8, seed: int = 7):
    """Synthetic genome as in-memory contigs, with a poly-A decoy region in
    chr1 (a random genome otherwise takes the reference Matcher's panic
    path; see utils/synthetic.py). The JAX tool's generator."""
    from ..utils.synthetic import random_seq

    rng = np.random.default_rng(seed)
    per = int(mbp * 1e6 / n_contigs)
    contigs = {}
    for c in range(n_contigs):
        s = random_seq(rng, per)
        if c == 0:
            s = s[:1000] + "A" * 400 + s[1400:]
        contigs[f"chr{c + 1}"] = s
    return contigs


def matcher_candidates(contigs, n: int = 200, seed: int = 1):
    """n 150-base reads cut from random contigs at random offsets."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    cands = []
    for _ in range(n):
        s = contigs[names[int(rng.integers(len(names)))]]
        off = int(rng.integers(0, len(s) - 150))
        cands.append(s[off : off + 150])
    return cands


def write_panel_csv(contigs, panel_mbp: float, path: str):
    """Genes of GENE_LEN tiled over the contigs in order until panel_mbp,
    two exons each -> [(name, contig, start, end)], 0-based, end exclusive."""
    n_keep = int(panel_mbp * 1e6)
    genes = []
    with open(path, "w") as f:
        for name, s in contigs.items():
            pos = 0
            while pos + GENE_LEN <= len(s) and len(genes) * GENE_LEN < n_keep:
                gene = f"G{len(genes):04d}"
                f.write(f">{gene},{name}:{pos + 1}-{pos + GENE_LEN}\n")
                f.write(f"1,{pos + 100},{pos + 400}\n")
                f.write(f"2,{pos + 1000},{pos + 1400}\n")
                genes.append((gene, name, pos, pos + GENE_LEN))
                pos += GENE_LEN
            if len(genes) * GENE_LEN >= n_keep:
                break
    return genes


def planted_genes(genes):
    """The genes that hold the planted junction's two sides (chr1 at
    500,000, chr2 at 700,000)."""
    def at(contig, pos):
        return next(g for g, c, a, b in genes if c == contig and a <= pos < b)

    return at("chr1", 500_000), at("chr2", 700_000)


def make_pairs(contigs):
    """6 pairs across a junction of chr1 (at 500,000) and chr2 (at
    700,000), then 40 pairs from random places of chr1."""
    from ..core.read import SequenceRead, SequenceReadPair
    from ..core.sequence import reverse_complement

    rng = np.random.default_rng(1)
    g1, g2 = contigs["chr1"], contigs["chr2"]
    fused = g1[500_000:500_150] + g2[700_000 : 700_000 + 150]
    q = "I" * 150
    pairs = []
    for k in range(6):
        frag = fused[k * 5 : k * 5 + 260]
        pairs.append(SequenceReadPair(SequenceRead(f"@p{k}", frag[:150], "+", q),
                                      SequenceRead(f"@p{k} 2", reverse_complement(frag[-150:]),
                                                   "+", q)))
    for k in range(40):
        off = int(rng.integers(0, len(g1) - 260))
        frag = g1[off : off + 260]
        pairs.append(SequenceReadPair(SequenceRead(f"@b{k}", frag[:150], "+", q),
                                      SequenceRead(f"@b{k} 2", reverse_complement(frag[-150:]),
                                                   "+", q)))
    return pairs


def scan_report(mapper, engine, pairs, json_path: str, log) -> dict:
    """The pairs through `engine` on `mapper`, then the filters, clustering
    and the JSON report (core/scanner.finish_scan), the mapper's matches
    and results cleared first so that one index serves several engines ->
    {seconds, fusions, report with timestamps stripped}."""
    from ..config import Settings
    from ..core.scanner import finish_scan

    mapper.free_matches()
    mapper.fusion_results = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        engine.scan_pairs(mapper, pairs)
        if hasattr(engine, "flush"):
            engine.flush(mapper)
        finish_scan(mapper, "", json_path, "scale_proof", Settings())
    seconds = time.perf_counter() - t0
    with open(json_path) as f:
        report = TS.sub("<ts>", f.read())
    return dict(seconds=seconds, fusions=len(mapper.fusion_results), report=report,
                gene_pairs={(fr.left_gene.name, fr.right_gene.name)
                            for fr in mapper.fusion_results})


def probe_at_scale(mapper, index, n_pairs: int, device, seed: int = 2, reps: int = 20) -> dict:
    """The probe (stride 2) of one n_pairs batch of gen_block pairs, as the
    engine's lanes give it (phase 3 of chip_smoke.py), on `index`: kernel
    against plain (bit-equal), both timed, the rows needed with the
    kernel's own count, the sector bound, the gather floor over the same
    rows (the split layout's vals rows of the hits too)."""
    from ..config import PASS1_STEP, Settings
    from ..ops import cuda
    from ..ops import map_read as tm
    from ..ops.fused import lane_codes
    from ..parallel.engine import TorchEngine
    from ..utils.synthetic import gen_block
    from . import gather_floor as gf
    from .bounds import bound
    from .large_tables import rows_probed

    blk = gen_block(mapper, n_pairs, 150, seed=seed)
    sh = TorchEngine(Settings(), device="cpu")._st0_produce(
        blk.left.seq, blk.left.qual, blk.left.lens, blk.right.seq, blk.right.qual,
        blk.right.lens)
    W = sh["widths"][0]
    lens_l = torch.split(sh["lens_d"], [b.shape[0] for b in sh["bufs_d"]])
    lanes = []
    for li in (0, 2):
        c = lane_codes(sh["bufs_d"][li], sh["widths"][li], sh["exc_d"], sh["offs"][li])
        full = torch.full((c.shape[0], W), 255, dtype=torch.uint8)
        full[:, : c.shape[1]] = c
        lanes.append((full, lens_l[li]))
    codes = torch.cat([c for c, _ in lanes])[:n_pairs].contiguous().to(device)
    lens = torch.cat([n for _, n in lanes])[:n_pairs].contiguous().to(device)
    B, Wc = codes.shape
    pr = tm.probe(codes, lens, PASS1_STEP, index)
    exp = tm.probe_plain(codes, lens, PASS1_STEP, index)
    if not torch.equal(pr, exp):
        raise RuntimeError("scale_proof: the probe differs from its plain version")
    need = rows_probed(index, codes, lens, PASS1_STEP, indices=True)
    vals_rows = need.get("vals_rows", 0)  # the split layout's hits read a vals row each
    rec = dict(batch=f"{B}x{Wc}", stride=PASS1_STEP, layout="split" if index.split else "kv",
               table_rows=index.table.shape[0], row_bytes=need["row_bytes"],
               valid_queries=need["valid"], hits=need["hits"], rows_needed=need["rows"],
               vals_rows=vals_rows, max_row_offset=need["max_offset"], max_abs_err=0,
               **bound(B * Wc + 4 * B + (need["rows"] + vals_rows) * SECTOR + pr.numel() * 4,
                       2 * B * Wc + 16 * need["valid"]))
    if device.type != "cuda":
        return rec
    loads = torch.zeros(1, dtype=torch.int64, device=device)
    out = torch.empty_like(pr)
    cuda.launch_probe(codes, lens, None, None, B * pr.shape[1], Wc, PASS1_STEP, pr.shape[1],
                      index, out, row_loads=loads)
    if not torch.equal(out, exp):
        raise RuntimeError("scale_proof: the probe with its row counter differs from plain")
    rec["rows_loaded"] = int(loads.item())
    rec["ms"] = gf.event_ms(lambda: tm.probe(codes, lens, PASS1_STEP, index), reps)
    rec["plain_ms"] = gf.event_ms(lambda: tm.probe_plain(codes, lens, PASS1_STEP, index), 3)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["ps_per_row"] = rec["ms"] * 1e9 / need["rows"]
    # the gather floor: the same rows in query order, in whole tiles
    floor = {"table": (need["row_index"], index.table)}
    if index.split:
        floor["vals"] = (need["vals_index"], index.vals)
    rec["gather_floor_ms"] = 0.0
    for name, (rows, tbl) in floor.items():
        rows = rows.to(torch.int32)
        idx = torch.cat([rows, rows[: (-rows.shape[0]) % gf.TILE]]).contiguous()
        ms = gf.measure(idx, tbl)["ms"]
        rec[f"gather_floor_{name}_ms"] = ms
        rec["gather_floor_ms"] += ms
    rec["floor_over_probe"] = rec["gather_floor_ms"] / rec["ms"]
    return rec


def _card_bytes() -> dict:
    if not torch.cuda.is_available():
        return {}
    return dict(card_allocated=torch.cuda.memory_allocated(),
                card_max_allocated=torch.cuda.max_memory_allocated())


def _index_bytes(ix) -> dict:
    b = {k: getattr(ix, k).numel() * 4 for k in ("table", "vals", "dupes")}
    b["total"] = sum(b.values())
    return b


def part_a(contigs, rec: dict) -> None:
    from ..core.matcher import Matcher

    cands = matcher_candidates(contigs)
    t0 = time.perf_counter()
    matcher = Matcher(contigs, cands)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_aln = sum(1 for s in cands[:50] if matcher.do_match(s) is not None)
    rec["matcher"] = dict(build_s=build_s, do_match_50_s=time.perf_counter() - t0,
                          alignable=n_aln, peak_rss_gb=rss_gb())
    print(f"# matcher: build {build_s:.1f}s, 50 do_match, alignable={n_aln}, "
          f"rss={rss_gb():.1f}GB", flush=True)


def part_b(contigs, args, device, workdir: str, rec: dict, log) -> None:
    from ..config import Settings
    from ..core.mapper import FusionMapper
    from ..core.scanner import HostEngine
    from ..ops import cuda
    from ..ops.index import build_packed_index, layout_name
    from ..parallel.engine import TorchEngine
    from ..parallel.sharded_engine import ShardedIndexEngine

    reports = args.reports or workdir
    os.makedirs(reports, exist_ok=True)
    csv = os.path.join(workdir, f"scale_panel_{args.panel_mbp:g}.csv")
    genes = write_panel_csv(contigs, args.panel_mbp, csv)
    total = len(genes) * GENE_LEN
    t0 = time.perf_counter()
    mapper = FusionMapper(contigs, csv, Settings())
    ix = mapper.indexer
    rec["panel"] = dict(genes=len(genes), bases=total, make_index_s=time.perf_counter() - t0,
                        entries=int(len(ix.se_kmer)), unique_kmers=int(len(ix.uniq_keys)),
                        peak_rss_gb=rss_gb(), rss_gb=rss_now_gb(),
                        mem_available_gb=mem_available_gb())
    print(f"# panel: {len(genes)} genes, {total / 1e6:.0f} Mbp, make_index "
          f"{rec['panel']['make_index_s']:.1f}s, {len(ix.uniq_keys) / 1e6:.1f}M unique k-mers, "
          f"rss={rss_gb():.1f}GB", flush=True)
    pairs = make_pairs(contigs)

    host = scan_report(mapper, HostEngine(), pairs, os.path.join(reports, "host.json"), log)
    g1, g2 = planted_genes(genes)
    rec["host"] = dict(scan_s=host["seconds"], fusions=host["fusions"], planted=[g1, g2],
                       planted_found=bool({(g1, g2), (g2, g1)} & host["gene_pairs"]))
    print(f"# host oracle: {host['seconds']:.1f}s, fusions={host['fusions']}", flush=True)

    # the sharded index: S tables on the one card
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = ShardedIndexEngine(Settings(), devices=[device] * args.shards, batch_size=64)
    t0 = time.perf_counter()
    eng._prepare(mapper)
    pack_s = time.perf_counter() - t0
    shards = [_index_bytes(i) for i in eng._indexes]
    cuda.reset_launches()
    sh = scan_report(mapper, eng, pairs, os.path.join(reports, "sharded.json"), log)
    launches = {k: cuda.LAUNCHES[k] for k in (*SHARDED_KERNELS, "edit_distance")}
    rec["sharded"] = dict(shards=args.shards, pack_s=pack_s, table_bytes=eng.table_bytes,
                          shard_bytes=shards, min_shard_bytes=min(s["total"] for s in shards),
                          buckets=int(eng._indexes[0].table.shape[0]), scan_s=sh["seconds"],
                          fusions=sh["fusions"], equal_host=sh["report"] == host["report"],
                          launches=launches, peak_rss_gb=rss_gb(), rss_gb=rss_now_gb(),
                          **_card_bytes())
    print(f"# sharded: pack {pack_s:.1f}s, {eng.table_bytes / 1e9:.2f} GB over {args.shards} "
          f"shards, scan {sh['seconds']:.1f}s, fusions={sh['fusions']}, "
          f"equal_host={rec['sharded']['equal_host']}, rss={rss_gb():.1f}GB", flush=True)
    del eng, sh
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # one table through the default engine
    attempts = []
    t0 = time.perf_counter()
    packed = build_packed_index(ix, attempts=attempts)
    build_s = time.perf_counter() - t0
    layout = layout_name(packed)
    t0 = time.perf_counter()
    eng = TorchEngine(Settings(), device=device)
    eng.use_packed(packed, mapper)
    if device.type == "cuda":
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    index = eng._tables[id(mapper)]["indexes"][eng.device]
    del packed
    cuda.reset_launches()
    one = scan_report(mapper, eng, pairs, os.path.join(reports, "one_table.json"), log)
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    tb = _index_bytes(index)
    rec["one_table"] = dict(layout=layout, attempts=attempts, pack_s=build_s, upload_s=upload_s,
                            table_bytes=tb, past_2_32=tb["total"] > 1 << 32,
                            largest_tensor_past_2_32=max(tb["table"], tb["vals"]) > 1 << 32,
                            buckets=int(index.table.shape[0]), scan_s=one["seconds"],
                            fusions=one["fusions"], equal_host=one["report"] == host["report"],
                            launches=launches, peak_rss_gb=rss_gb(), rss_gb=rss_now_gb(),
                            **_card_bytes())
    print(f"# one table: {layout} after {[a['layout'] for a in attempts]}, pack {build_s:.1f}s, "
          f"{tb['total'] / 1e9:.2f} GB, scan {one['seconds']:.1f}s, fusions={one['fusions']}, "
          f"equal_host={rec['one_table']['equal_host']}, rss={rss_gb():.1f}GB", flush=True)
    del eng
    gc.collect()
    if args.probe_pairs:
        p = probe_at_scale(mapper, index, args.probe_pairs, device)
        rec["probe"] = p
        print(f"# probe: {p['batch']} on {p['table_rows']} rows of {p['row_bytes']} B, "
              f"rows needed {p['rows_needed']}, ms {p.get('ms', 'not measured')}, "
              f"bound_ms {p['bound_ms']:.4f}", flush=True)


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mbp", type=float, default=1000.0)
    ap.add_argument("--panel-mbp", type=float, default=256.0,
                    help="panel size; 0 runs part (a) alone")
    ap.add_argument("--skip-matcher", action="store_true",
                    help="skip part (a); put its timings in the record with --matcher-note")
    ap.add_argument("--matcher-note", default="")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the JSON record to this file")
    ap.add_argument("--reports", help="keep the three engines' JSON reports in this directory")
    ap.add_argument("--probe-pairs", type=int, default=65_536,
                    help="pairs of the probe's timed batch (0: no probe timing)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scale_proof: no CUDA device (give --device cpu for the plain versions)",
              file=sys.stderr)
        raise SystemExit(2)
    device = torch.device(args.device)
    rec = dict(tool="genefuserust_tpu_torch.profiling.scale_proof", args=vars(args),
               host=host_info(), torch=torch.__version__, cuda=torch.version.cuda)
    if device.type == "cuda":
        from ..ops import cuda
        from .gather_floor import card_line

        rec["card"] = card_line()
        t0 = time.perf_counter()
        cuda.library()
        rec["kernel_build_s"] = time.perf_counter() - t0
    print(f"# host: {rec['host']}, card: {rec.get('card', 'none (cpu)')}", flush=True)

    t0 = time.perf_counter()
    contigs = gen_genome(args.genome_mbp)
    rec["genome"] = dict(bases=sum(len(s) for s in contigs.values()), contigs=len(contigs),
                         gen_s=time.perf_counter() - t0, peak_rss_gb=rss_gb())
    print(f"# genome: {rec['genome']['bases'] / 1e9:.3f} Gbp in {rec['genome']['gen_s']:.1f}s, "
          f"rss={rss_gb():.1f}GB", flush=True)
    if args.skip_matcher:
        rec["matcher"] = dict(note=args.matcher_note or "part (a) run separately")
    else:
        part_a(contigs, rec)
    if args.panel_mbp > 0:
        with tempfile.TemporaryDirectory(prefix="scale-") as workdir, \
                open(os.path.join(workdir, "scan.log"), "w") as log:
            part_b(contigs, args, device, workdir, rec, log)
    rec["peak_rss_gb"] = rss_gb()
    return rec


def check(rec: dict) -> list:
    """What the record must show -> the failures, empty when it passed."""
    bad = []
    if "panel" not in rec:
        return bad
    for arm in ("sharded", "one_table"):
        if not rec[arm]["equal_host"]:
            bad.append(f"{arm}: report differs from the host oracle's")
    if not rec["host"]["planted_found"] or rec["host"]["fusions"] < 1:
        bad.append("the planted fusion was not found")
    if rec["args"]["device"] == "cuda":
        for k in SHARDED_KERNELS:
            if not rec["sharded"]["launches"][k]:
                bad.append(f"sharded: kernel {k} never launched")
    return bad


def main(argv=None) -> int:
    rec = run(argv)
    bad = check(rec)
    rec["ok"] = not bad
    line = json.dumps(rec, sort_keys=True)
    if rec["args"].get("out"):
        os.makedirs(os.path.dirname(os.path.abspath(rec["args"]["out"])), exist_ok=True)
        with open(rec["args"]["out"], "w") as f:
            f.write(line + "\n")
    print(line)
    print(rec.get("card", "cpu"))
    for b in bad:
        print(f"scale_proof: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
