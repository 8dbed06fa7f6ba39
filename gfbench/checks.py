"""What decides `correct`: the program's outputs in the window against the
plain reference's (gfbench/reference), on the same panel files and reads.

Two numbers, each an exact comparison with the limit 0:

  pairs_differing      pairs of the check set, summed over the window's
                       samples, whose matches (per panel: the read, its
                       break, both gene positions, the gap, the strand and
                       the two edit distances) differ from the reference's:
                       the device scan's outcome for the pair, the match
                       that assembly makes of it and the edit distances it
                       computes;
  reports_differing    reports (a panel a sample) whose JSON fusions block
                       differs from the reference's: every fusion, its
                       positions, and its supporting reads.

The check set is every chimeric and planted pair, every pair that the
program gave a match in any sample, and `RANDOM_PAIRS` more drawn from the
seed. Only those kinds of pair can span two genes, so the reference's
report, built from the check set's matches, is that of the whole sample.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import traffic

LIMITS = {"pairs_differing": 0, "reports_differing": 0}
RANDOM_PAIRS = 1024
REPORT_START = '\t"fusions":{'

Key = tuple
Outcome = Dict[int, List[Key]]


def pair_of(name: str) -> int:
    """The pair index in a read name `@GF:<i> <mate>:N:0:ACGT` (a merged
    read's name starts with R1's)."""
    return int(name[4 : name.index(" ")])


def outcome(panel: int, m) -> Key:
    """A match as compared: what the scan and assembly decided."""
    return (panel, m.read.name, m.read.seq, m.read.quality, m.read_break,
            m.left_gp.contig, m.left_gp.position, m.right_gp.contig,
            m.right_gp.position, m.gap, bool(m.reversed), m.left_distance, m.right_distance)


def program_outcome(mappers) -> Outcome:
    """Every match in the mappers' bins, by pair (read before finish_scan,
    which changes the matches)."""
    out: Outcome = {}
    for p, mapper in enumerate(mappers):
        for fm in mapper.fusion_matches:
            for m in fm:
                out.setdefault(pair_of(m.original_reads[0].name), []).append(outcome(p, m))
    return out


def report_block(text: str) -> str:
    """A JSON report from its fusions block on (the command, version and
    time lines before it are not compared)."""
    i = text.find(REPORT_START)
    return text[i:] if i >= 0 else text


def check_set(sample: "traffic.Sample", seed: int, program_pairs=()) -> np.ndarray:
    rng = np.random.default_rng([seed, 3])
    rand = rng.choice(len(sample), min(RANDOM_PAIRS, len(sample)), replace=False)
    spans = np.nonzero((sample.kind == traffic.CHIMERA) | (sample.kind == traffic.PLANTED))[0]
    return np.unique(np.concatenate([rand, spans, np.asarray(list(program_pairs), np.int64)]))


def reference_outcome(ref, sample: "traffic.Sample",
                      pairs: Sequence[int]) -> Tuple[Outcome, List[str]]:
    """The reference's outcome for each pair and its report for each panel."""
    from .reference import SequenceRead, SequenceReadPair

    L = sample.left.with_reads(SequenceRead)
    R = sample.right.with_reads(SequenceRead)
    idx = [int(x) for x in pairs]
    found = ref.pair_matches([SequenceReadPair(L.read_obj(i), R.read_obj(i)) for i in idx])
    out: Outcome = {}
    kept: List[list] = [[] for _ in ref.mappers]
    for i, per_panel in zip(idx, found):
        for p, ms in enumerate(per_panel):
            for m in ms:
                out.setdefault(i, []).append(outcome(p, m))
            kept[p].extend(ms)
    return out, ref.report(kept)


def compare(samples: Sequence[Tuple[Outcome, List[str]]], ref_pairs: Outcome,
            ref_reports: List[str], pairs: Sequence[int]) -> dict:
    """The numbers over every (outcome, reports) of `samples`."""
    n = dict(pairs_differing=0, reports_differing=0)
    for got, reports in samples:
        for i in (int(x) for x in pairs):
            n["pairs_differing"] += sorted(got.get(i, [])) != sorted(ref_pairs.get(i, []))
        n["reports_differing"] += sum(g != e for g, e in zip(reports, ref_reports))
        n["reports_differing"] += abs(len(reports) - len(ref_reports))
    return n


def verdict(numbers: dict) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit."""
    checks = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    return dict(checks=checks, correct=all(v["value"] <= v["limit"] for v in checks.values()))
