"""Fusion panel CSV parsing.

reference: src/core/fusion.rs:23-91. Format:
  `>NAME,chr:start-end` gene header lines followed by `id,start,end` exon
  lines; `#`-prefixed comment lines; lines with <2 fields skipped; exon
  lines need >=3 fields.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import FUSION_CSV_LINE_LIMIT
from .gene import Gene


@dataclasses.dataclass
class Fusion:
    gene: Gene

    def is_reversed(self) -> bool:
        return self.gene.is_reversed()

    @staticmethod
    def parse_csv(filename: str) -> List["Fusion"]:
        fusions: List[Fusion] = []
        working = Gene()
        with open(filename, "r", newline="") as f:
            for raw in f:
                if len(raw) > FUSION_CSV_LINE_LIMIT:
                    raise RuntimeError(
                        f"fusion CSV line exceeds {FUSION_CSV_LINE_LIMIT} bytes "
                        "(reference LimitedBufReader panics: src/aux/limited_bufreader.rs:49-56)"
                    )
                line = raw.strip()
                fields = line.split(",")
                if len(fields) < 2:
                    continue
                if fields[0].startswith("#"):
                    continue
                if fields[0].startswith(">"):
                    if working.valid():
                        fusions.append(Fusion(working))
                    working = Gene.parse(line)
                    continue
                if len(fields) < 3:
                    continue
                working.add_exon(
                    int(fields[0].strip()), int(fields[1].strip()), int(fields[2].strip())
                )
        if working.valid():
            fusions.append(Fusion(working))
        return fusions
