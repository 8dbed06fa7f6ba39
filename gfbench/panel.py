"""A configuration's panel, made from the seed: the FASTA of its contigs
and its CSV files, written into the run's directory.

Gene g lies alone on contig c<g>, from base 50, `panel_bp // genes` bases
long, with `exons_per_gene` exons of `exon_bp` bases one every span // 21
bases from base 110 (chip_smoke.py's write_panel). Contig c00 also ends,
past its gene, in a poly-A decoy (see the configurations' `assumed`). With
`csvs` > 1, gene k goes to CSV k mod csvs (bench.py's split_panel_csvs).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

DECOY = ("A" * 16 + "T" + "A" * 16 + "C" + "A" * 16 + "G") * 60
_BASES = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Panel:
    fasta: str
    csvs: List[str]
    genes: List[np.ndarray]  # each gene's bases (uint8), gene order
    exon_starts: List[List[int]]  # 1-based CSV starts, a list a gene
    gene_start: int  # 0-based start of every gene on its contig


def gene_span(cfg: dict) -> int:
    return cfg["panel_bp"] // cfg["genes"]


def make_panel(cfg: dict, seed: int, workdir: str) -> Panel:
    rng = np.random.default_rng([seed, 1])
    n_genes, span = cfg["genes"], gene_span(cfg)
    step = span // 21
    start = 50
    contigs = _BASES[rng.integers(0, 4, (n_genes, span + 100), dtype=np.uint8)]
    fa = os.path.join(workdir, "panel.fa")
    with open(fa, "wb") as f:
        for g in range(n_genes):
            seq = contigs[g].tobytes() + (DECOY.encode() if g == 0 else b"")
            f.write(f">c{g:02d}\n".encode())
            f.write(b"\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + b"\n")
    headers, exon_starts = [], []
    for g in range(n_genes):
        starts = [start + 60 + e * step for e in range(cfg["exons_per_gene"])]
        lines = [f">G{g:02d},c{g:02d}:{start}-{start + span}"]
        lines += [f"{e + 1},{s},{s + cfg['exon_bp']}" for e, s in enumerate(starts)]
        headers.append("\n".join(lines) + "\n")
        exon_starts.append(starts)
    n_csv = cfg["csvs"]
    csvs = []
    for k in range(n_csv):
        p = os.path.join(workdir, "panel.csv" if n_csv == 1 else f"panel_part{k:02d}.csv")
        with open(p, "w") as f:
            f.write("".join(headers[k::n_csv]))
        csvs.append(p)
    genes = [contigs[g, start : start + span].copy() for g in range(n_genes)]
    return Panel(fa, csvs, genes, exon_starts, start)
