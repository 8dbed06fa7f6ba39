"""Smoke run of the PyTorch/CUDA port (genefuserust_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one result line each; any failure raises and exits non-zero:

  1 device   require CUDA; the card's name and power limit (nvidia-smi)
  2 build    compile the csrc/ kernels with nvcc (sm_90a)
  3 kernels  each kernel against its plain PyTorch version, on the card,
             bit-equal, at main-path shapes: the probe over a 65,536-row
             batch against a 15.2 Mbp panel's kv2 table (2^26 rows), the
             vote on the same batch, mask+segments on the 1,024 rows the
             scan hands it; the probe on a small panel packed kv4, kv8 and
             split. Kernel and plain times from CUDA events.
  4 golden   tests/goldens/planted.{json,html} through TorchEngine, byte
             for byte (timestamps stripped), at survivor cap 1024 and 2
  5 cli      262,144 read pairs (plus two planted fusions) through the
             port's CLI: every kernel launched, >= 1 fusion reported
  6 oracle   the first 4,096 pairs: TorchEngine's JSON equal to the host
             oracle's, with the kv2 and the split table
  7 profile  the same 262,144 pairs through a warm TorchEngine, the kv2
             table already on the card, under torch.profiler: device time
             by kernel and the device's busy share of the scan's wall time

The last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}, preceded by nvidia-smi's name/power line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(got, exp) -> int:
    return int((got.to(exp.device).long() - exp.long()).abs().max())


def quiet(data: dict):
    """Send a scan's console report (the fusion listing) to the run's log
    file, so that the phase lines stay at the end of the output."""
    return contextlib.redirect_stdout(data["log"])


def strip_json(text: str) -> str:
    return "\n".join(l for l in _TS.sub("<ts>", text).splitlines()
                     if not l.startswith('\t"time"'))


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
    from genefuserust_tpu.core.sequence import reverse_complement

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

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
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
    check(len(regs) == 6, f"expected 6 compiled kernels, ptxas reported {len(regs)}")
    say("2 build", seconds=f"{secs:.2f}", lib=os.path.relpath(lib, REPO),
        registers_per_kernel=",".join(regs))


def _timed_pair(name, kernel_fn, plain_fn, exp=None, reps=20, plain_reps=3):
    """Run kernel and plain once, require bit equality, time both."""
    import torch

    got = kernel_fn()
    ref = plain_fn() if exp is None else exp
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    check(got.shape == ref.shape and torch.equal(got, ref),
          f"{name}: kernel differs from its plain version (max_abs_err {err})")
    return got, err, cuda_ms(kernel_fn, reps), cuda_ms(plain_fn, plain_reps)


def phase_kernels(data: dict) -> dict:
    import torch

    from genefuserust_tpu import native
    from genefuserust_tpu.config import PASS1_STEP, Settings
    from genefuserust_tpu.core.indexer import Indexer
    from genefuserust_tpu.core.sequence import encode_bases
    from genefuserust_tpu.models.fusion import Fusion
    from genefuserust_tpu.ops.hashtable import build_packed_index, pack_index, pack_index_kv
    from genefuserust_tpu.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
    from genefuserust_tpu_torch.ops import map_read as tm
    from genefuserust_tpu_torch.ops.fused import lane_codes
    from genefuserust_tpu_torch.ops.index import index_to_torch
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    dev = torch.device("cuda")
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
    index = index_to_torch(packed, dev)
    data["packed_kv2"] = packed
    # the main path's lanes for the first batch: host merge + pack (engine
    # stage 0), then the merged-short lane topped up with unmerged reads
    b1, q1, l1, b2, q2, l2 = (a[:BATCH] for a in data["block"])
    sh = TorchEngine(Settings(), device="cpu")._st0_produce(b1, q1, l1, b2, q2, l2)
    erow, ecol = sh["exc_d"][:, 0].long(), sh["exc_d"][:, 1].long()
    W = sh["widths"][0]
    lanes = []
    for li in (0, 2):
        c = lane_codes(sh["bufs_d"][li], sh["widths"][li], erow, ecol, sh["offs"][li])
        full = torch.full((c.shape[0], W), 255, dtype=torch.uint8)
        full[:, : c.shape[1]] = c
        lanes.append((full, sh["lens_d"][li]))
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
    rec["probe"] = (err, ms, pms)
    say("3 kernels", kernel="probe", layout="kv2", shape=tuple(pr.shape), stride=PASS1_STEP,
        hits=int((pr[..., 0] >= 0).sum()), ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        max_abs_err=err)
    v, err, ms, pms = _timed_pair(
        "vote", lambda: tm.vote(pr, index, 40, 20),
        lambda: tm.vote_plain(pr, index, 40, 20))
    rec["vote"] = (err, ms, pms)
    ok = v[:, 0] != 0
    say("3 kernels", kernel="vote", rows=v.shape[0], candidates_per_row=pr.shape[1] * index.D,
        sort_buffer=tm.vote_width(pr.shape[1], index.D), survivors=int(ok.sum()),
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", max_abs_err=err)
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
    rec["mask_segments"] = (err, ms, pms)
    say("3 kernels", kernel="mask_segments", rows=seg.shape[0], width=scodes.shape[1],
        two_segment_rows=int((seg[:, 0] & seg[:, 1]).sum()), ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", max_abs_err=err)

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
    for layout, p in (("kv4", pack_index_kv(ix, target_load=0.6, slots=2)),
                      ("kv8", pack_index_kv(ix)), ("split", pack_index(ix))):
        check(p is not None, f"small panel does not pack as {layout}")
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


def phase_golden(data: dict) -> None:
    import torch

    from genefuserust_tpu.config import Settings
    from genefuserust_tpu.core.scanner import Scanner
    from genefuserust_tpu.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files
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

    from genefuserust_tpu import native
    from genefuserust_tpu_torch import cli
    from genefuserust_tpu_torch.ops import cuda

    check(native.available(), "the native host library did not build")
    wd = data["workdir"]
    b1, q1, _, b2, q2, _ = data["block"]
    r1, r2 = os.path.join(wd, "R1.fq"), os.path.join(wd, "R2.fq")
    write_fastq(r1, b1, q1, "p")
    write_fastq(r2, b2, q2, "p")
    html, js = os.path.join(wd, "out.html"), os.path.join(wd, "out.json")
    # the JAX engine's opt-in wall-time split of host stages (TpuEngine._timed)
    os.environ["GENEFUSE_STAGE_TIMERS"] = "1"
    cuda.reset_launches()
    t0 = time.perf_counter()
    with quiet(data):
        engine = cli.run(["-1", r1, "-2", r2, "-f", data["csv"], "-r", data["fa"],
                          "-h", html, "-j", js])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    n_fusions = len(json.load(open(js))["fusions"])
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the CLI run")
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
        host_stage_s=json.dumps({k: round(v[0], 3) for k, v in engine._timers.items()},
                                separators=(",", ":")),
        card=repr(smi_line))
    return launches


def phase_oracle(data: dict) -> None:
    from genefuserust_tpu.config import Settings
    from genefuserust_tpu.core.read import SequenceRead, SequenceReadPair
    from genefuserust_tpu.core.scanner import HostEngine, Scanner
    from genefuserust_tpu.ops.hashtable import build_packed_index
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    b1, q1, _, b2, q2, _ = (a[:ORACLE_PAIRS] for a in data["block"])

    def read(name, s, q):
        return SequenceRead(name, s.tobytes().decode(), "+", q.tobytes().decode())

    pairs = [SequenceReadPair(read(f"@p{i:08d}", b1[i], q1[i]), read(f"@p{i:08d}", b2[i], q2[i]))
             for i in range(ORACLE_PAIRS)]
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
    for kernel in ("probe", "vote", "mask_segments"):
        if f"{kernel}_kernel" in name:
            return kernel
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    return "torch_other"


def phase_profile(data: dict) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genefuserust_tpu.config import Settings
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_s = scan()
    spans, by_kind = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            kind = _device_kind(e.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    smi_line = phase_device()
    phase_build()
    build_dir = os.path.join(REPO, "genefuserust_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke-", dir=build_dir)
    log = open(os.path.join(workdir, "reports.log"), "w")
    try:
        import bench
        from genefuserust_tpu.config import Settings
        from genefuserust_tpu.core.mapper import FusionMapper
        from genefuserust_tpu.io import fasta

        t0 = time.perf_counter()
        fa, csv, exons = write_panel(workdir, args.seed)
        mapper = FusionMapper(fasta.read_all(fa, force_upper_case=False), csv, Settings())
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blk = bench.gen_block(mapper, CLI_PAIRS, 150, seed=args.seed, profile="real")
        block = [blk.left.seq, blk.left.qual, blk.left.lens,
                 blk.right.seq, blk.right.qual, blk.right.lens]
        plant_fusions(mapper.contigs, exons, block[0], block[1], block[3], block[4])
        say("3 kernels", setup="data", panel_and_index_s=f"{index_s:.1f}",
            reads_s=f"{time.perf_counter() - t0:.1f}", pairs=CLI_PAIRS)
        data = dict(seed=args.seed, workdir=workdir, fa=fa, csv=csv, mapper=mapper,
                    blk=blk, block=block, log=log)
        rec = phase_kernels(data)
        phase_golden(data)
        launches = phase_cli(data, smi_line)
        phase_oracle(data)
        phase_profile(data)
    finally:
        log.close()
        shutil.rmtree(workdir, ignore_errors=True)
    replaces = {
        "probe": "genefuserust_tpu/ops/pallas_lookup.py:102",
        "vote": "genefuserust_tpu/ops/map_read.py:396",
        "mask_segments": "genefuserust_tpu/ops/map_read.py:439",
    }
    kernels = [
        dict(name=k, route="cuda", source=f"genefuserust_tpu_torch/csrc/{k}.cu",
             replaces=replaces[k], launches=launches[k], max_abs_err=rec[k][0],
             ms=round(rec[k][1], 6), plain_ms=round(rec[k][2], 6))
        for k in ("probe", "vote", "mask_segments")
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
