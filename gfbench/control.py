"""The control of `correct`: the reference put in the program's place,
its scan's gene positions held in 16-bit integers where the panel states
32 (GenePos: contig i16, position i32; the device's result rows and the
table's packed payloads are where a narrower position would save bytes).
It has to come out as not correct.

    python3 -m gfbench.control --workload <name> --seeds <n> [<n> ...]

Makes the cell's panel and sample from each seed, as a run does, and
prints a JSON line a seed: the numbers of checks.py with the control's
outputs compared to the reference's, over the check set (every chimeric
and planted pair and checks.RANDOM_PAIRS more). No device is used.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from . import checks, panel as panels, registry, traffic

CONTROL_BITS = 16


def control_numbers(name: str, seed: int, sizes: dict = None) -> dict:
    """checks.compare of the control against the reference at one seed;
    `sizes` overrides configuration and traffic keys, as in run_cell."""
    from .reference import Reference, Settings

    wl = registry.workload(name)
    cfg = {**registry.config(wl["config"]), **(sizes or {}).get("config", {})}
    mix = {**registry.traffic(wl["traffic"]), **(sizes or {}).get("traffic", {})}
    rundir = tempfile.mkdtemp(prefix="gfbench-control-")
    try:
        p = panels.make_panel(cfg, seed, rundir)
        sample = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, seed)
        pairs = checks.check_set(sample, seed)
        settings = Settings(**cfg["settings"])
        ref_pairs, ref_reports = checks.reference_outcome(
            Reference(p.fasta, p.csvs, settings), sample, pairs)
        ctl_pairs, ctl_reports = checks.reference_outcome(
            Reference(p.fasta, p.csvs, settings, position_bits=CONTROL_BITS), sample, pairs)
        same = checks.compare([(ref_pairs, ref_reports)], ref_pairs, ref_reports, pairs)
        numbers = checks.compare([(ctl_pairs, ctl_reports)], ref_pairs, ref_reports, pairs)
        return dict(workload=name, seed=seed, pairs_checked=len(pairs),
                    reference_vs_itself=same, control=numbers,
                    control_correct=checks.verdict(numbers)["correct"])
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(args.workload, seed)
        out["seconds"] = round(time.perf_counter() - t0, 2)
        print(json.dumps(out, separators=(",", ":")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
