"""The pass-1 vote (csrc/vote.cu, `vote_kernel`) on the benchmark cells'
own batches: where its time goes and what its rows hold.

    python -m genefuserust_tpu_torch.profiling.vote_profile \\
        [--cells cancer15-pe-targeted,oncokb1100-pe-targeted] [--pairs 262144] \\
        [--seed 1] [--baseline DIR] [--min-blocks 4,5,8] [--out FILE]

For each cell it makes the cell's panel and sample from the seed
(gfbench's generators), makes the panel ready as the benchmark does and
scans the sample's first `--pairs` pairs through `TorchEngine`, keeping
every vote call of the scan (its probe results, lengths and table). On
those calls it reports:

  - the rows' valid keys (n) and distinct keys (d), as shares of rows:
    what the warp path's sort (n) and a distinct-key peel (d) each cost;
  - the vote's device time summed over the calls, for this checkout's
    library, for a build of it whose warp path loads and compacts the
    keys but votes on none (`nosort`: the warp path without its vote),
    for builds with another VOTE_MIN_BLOCKS (`--min-blocks`), and with
    `--baseline DIR` for another checkout's csrc/ (a parent from before
    the vote's `stats` argument);
  - whether each library's rows equal the plain vote's, and its counter
    of rows voted and rows sorted (zeros from a build without one) beside
    the plain rule's (`tally`, map_read.vote_tally);
  - the registers of `vote_kernel` in each build (ptxas) and the static
    SASS instruction mix of its body (cuobjdump -sass).

One JSON line for the builds, then one a cell. Needs the card (and
nvcc); `--device cpu` runs the capture and the row statistics at a small
size (30 genes, 4,096 pairs), with no build and no time.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from ..config import PASS1_STEP
from ..ops import cuda, fused, map_read

# the warp path's vote calls in csrc/vote.cu, each replaced by `false` for
# the `nosort` build (the rows' outputs are then left unwritten)
_WARP_VOTE = re.compile(r"(warp_vote|vote_warp)<\d+>\(slice[^;]*;")
REPS = 20  # timed launches of each call
_OLD_VOTE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
    ctypes.c_int] * 10 + [ctypes.c_void_p] * 3


def capture(cell: str, seed: int, pairs: int, device: str):
    """The vote calls of a scan of the cell's first `pairs` pairs ->
    ([(pr, lengths, index, major_req, minor_req)], layout)."""
    from gfbench import panel as panels, registry, traffic

    from ..config import Settings
    from ..core.mapper import FusionMapper
    from ..core.read import SequenceRead
    from ..io import fasta
    from ..ops.index import build_packed_index, layout_name
    from ..parallel.engine import TorchEngine

    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    mix = registry.traffic(wl["traffic"])
    if device == "cpu":
        cfg = {**cfg, "genes": 30, "panel_bp": 360_000, "batch_pairs": 1024}
        mix = {**mix, "pairs_per_sample": 4096}
    settings = Settings(**cfg["settings"])
    calls = []
    real = fused.vote

    def keep(pr, index, major_req, minor_req, lengths=None, **kw):
        calls.append((pr.clone(), None if lengths is None else lengths.clone(), index,
                      major_req, minor_req))
        return real(pr, index, major_req, minor_req, lengths, **kw)

    rundir = tempfile.mkdtemp(prefix="vote-profile-")
    try:
        p = panels.make_panel(cfg, seed, rundir)
        contigs = fasta.read_all(p.fasta, force_upper_case=False)
        mapper = FusionMapper(contigs, p.csvs[0], settings)
        engine = TorchEngine(settings, batch_size=cfg["batch_pairs"], device=device,
                             pipeline_depth=cfg["pipeline_depth"])
        packed = build_packed_index(mapper.indexer)
        engine.use_packed(packed, mapper=mapper)
        layout = layout_name(packed)
        del packed
        pool = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, seed,
                                read_cls=SequenceRead)
        fused.vote = keep
        try:
            engine.scan_pair_block_multi([mapper], pool.head(min(len(pool), pairs)))
            engine.flush()
        finally:
            fused.vote = real
        del engine, mapper, contigs
        return calls, layout
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def row_stats(calls) -> dict:
    """Shares of the calls' rows by valid keys n and distinct keys d."""
    n_all, d_all = [], []
    for pr, _, index, _, _ in calls:
        for r0 in range(0, pr.shape[0], 8192):
            keys, cv = map_read._keys_at(index, pr[r0 : r0 + 8192], PASS1_STEP)
            B = keys.shape[0]
            keys, cv = keys.reshape(B, -1), cv.reshape(B, -1)
            big = torch.iinfo(torch.int64).max
            s = torch.sort(torch.where(cv, keys, big), dim=1).values
            new = torch.ones_like(s, dtype=torch.bool)
            new[:, 1:] = s[:, 1:] != s[:, :-1]
            d_all.append((new & (s != big)).sum(1).cpu())
            n_all.append(cv.sum(1).cpu())
    n, d = torch.cat(n_all), torch.cat(d_all)
    rows = n.numel()
    share = lambda m: round(int(m.sum()) / max(1, rows), 6)  # noqa: E731
    return dict(
        rows=rows, n_mean=round(float(n.float().mean()), 3), d_mean=round(float(d.float().mean()), 3),
        n_share={"0": share(n == 0), "1-32": share((n > 0) & (n <= 32)),
                 "33-64": share((n > 32) & (n <= 64)), "65-128": share((n > 64) & (n <= 128)),
                 "129-256": share((n > 128) & (n <= 256)), ">256": share(n > 256)},
        d_share={str(k): share(d == k) for k in range(9)} | {
            "9-16": share((d > 8) & (d <= 16)), "17-32": share((d > 16) & (d <= 32)),
            ">32": share(d > 32)},
        d_past={str(c): share((d > c) & (n <= map_read.VOTE_WARP_KEYS))
                for c in (4, 8, 12, 16, 24, 32)},
    )


def _variant(csrc: str, tmp: str, name: str) -> str:
    """A copy of csrc/ whose warp path votes on no row (`nosort`), or
    whose VOTE_MIN_BLOCKS is m (`min_blocks_<m>`)."""
    out = os.path.join(tmp, name)
    shutil.copytree(csrc, out, dirs_exist_ok=True)
    path = os.path.join(out, "vote.cu")
    with open(path) as f:
        src = f.read()
    if name == "nosort":
        cut, k = _WARP_VOTE.subn("false;", src)
    else:
        m = name.rsplit("_", 1)[1]
        cut, k = re.subn(r"constexpr int VOTE_MIN_BLOCKS = \d+;",
                         f"constexpr int VOTE_MIN_BLOCKS = {m};", src)
    if not k:
        raise RuntimeError(f"vote_profile: vote.cu has no site for the {name} variant")
    with open(path, "w") as f:
        f.write(cut)
    return out


def _launcher(lib, old: bool):
    fn = lib.gf_vote
    if old:
        fn.argtypes = _OLD_VOTE

    def launch(pr, lengths, index, major_req, minor_req, out, stats=None):
        dstride, D = cuda._dupe_args(index)
        B, NS, _ = pr.shape
        # as the main path launches it: no lengths (every sample walked), no
        # wide list
        args = [pr.data_ptr(), B, NS, None,
                index.dupes.data_ptr(), dstride, D, int(index.split), index.cbits,
                index.pos_bias, PASS1_STEP, major_req, minor_req,
                map_read.vote_width(NS, index.D), 0, None, out.data_ptr()]
        if not old:
            args.append(None if stats is None else stats.data_ptr())
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gf_vote: CUDA error {err}")

    return launch


def _registers(so: str) -> dict:
    """ptxas's registers and spill bytes (stores, loads) of each vote
    kernel in a build's log."""
    out, fn = {}, None
    try:
        with open(so + ".log") as f:
            for line in f:
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    fn = m.group(1)
                if not fn or "vote" not in fn:
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    out.setdefault(fn, {})["spill"] = [int(m.group(1)), int(m.group(2))]
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    out.setdefault(fn, {})["registers"] = int(m.group(1))
    except OSError:
        pass
    return out


def sass_mix(so: str, kernel: str = "vote_kernel") -> dict:
    """Static SASS instruction counts of `kernel`'s body in a library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    r = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    counts, inside = collections.Counter(), False
    for line in r.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            inside = kernel in name and "wide" not in name and "shards" not in name
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
    return dict(total=sum(counts.values()), top=dict(counts.most_common(16)))


def time_calls(launch, calls, reps: int):
    """Device ms of `launch` over every call (adding to a row counter, as
    the main path's launches do), its rows, and its counter over one
    launch of each call -> (record, rows)."""
    from .gather_floor import event_ms

    total, outs, tally = 0.0, [], torch.zeros(2, dtype=torch.int64)
    for pr, lengths, index, major_req, minor_req in calls:
        out = torch.empty((pr.shape[0], 5), dtype=torch.int32, device=pr.device)
        stats = torch.zeros(map_read.VOTE_STAT_SLOTS, dtype=torch.int64, device=pr.device)
        launch(pr, lengths, index, major_req, minor_req, out, stats)
        t = int(stats.sum())
        tally += torch.tensor([t & 0xFFFFFFFF, t >> 32])
        total += event_ms(lambda: launch(pr, lengths, index, major_req, minor_req, out, stats),
                          reps)
        outs.append(out)
    return dict(ms=round(total, 5), counter=tally.tolist()), outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="cancer15-pe-targeted,oncokb1100-pe-targeted")
    ap.add_argument("--pairs", type=int, default=262144)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--baseline", default=None, help="another checkout's csrc/")
    ap.add_argument("--min-blocks", default="",
                    help="comma-separated VOTE_MIN_BLOCKS values, a build of each")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    on_card = a.device == "cuda"
    sink = open(a.out, "a") if a.out else None

    def say(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    libs = {}
    if on_card:
        tmp = tempfile.mkdtemp(prefix="vote-builds-")
        old_own = len(cuda._ARGTYPES["gf_vote"]) == 18
        own = cuda.build()
        libs["lib"] = (own, _launcher(cuda.load(own), old_own))
        nosort = cuda.build(("vote.cu",), csrc=_variant(cuda.CSRC, tmp, "nosort"))
        libs["nosort"] = (nosort, _launcher(cuda.load(nosort), old_own))
        for m in filter(None, a.min_blocks.split(",")):
            name = f"min_blocks_{m}"
            so = cuda.build(("vote.cu",), csrc=_variant(cuda.CSRC, tmp, name))
            libs[name] = (so, _launcher(cuda.load(so), old_own))
        if a.baseline:
            base = cuda.build(("vote.cu",), csrc=a.baseline)
            libs["baseline"] = (base, _launcher(cuda.load(base), True))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        say(dict(card=smi.stdout.strip(), builds={
            k: dict(registers=_registers(so), sass=sass_mix(so)) for k, (so, _) in libs.items()}))
    for cell in a.cells.split(","):
        calls, layout = capture(cell, a.seed, a.pairs, a.device)
        rec = dict(cell=cell, layout=layout, calls=len(calls),
                   shapes=sorted({tuple(c[0].shape[:2]) for c in calls}), rows=row_stats(calls))
        if on_card:
            plain = [map_read.vote_plain(pr, ix, mj, mn) for pr, _, ix, mj, mn in calls]
            rec["tally"] = [sum(x) for x in zip(*(map_read.vote_tally(pr, ix)
                                                  for pr, _, ix, _, _ in calls))]
            for k, (_, launch) in libs.items():
                t, outs = time_calls(launch, calls, REPS)
                if k != "nosort":
                    t["equal_plain"] = all(torch.equal(o, p) for o, p in zip(outs, plain))
                rec[k] = t
        say(rec)
        del calls
        if on_card:
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
