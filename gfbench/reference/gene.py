"""Panel gene model: a gene region with exons.

Reproduces the reference's Gene (reference: src/core/gene.rs:9-229):
header parsing, exon bookkeeping, the `reversed` inference (exon[0].start >
exon[1].start), and the exact position-string formatting used in fusion
titles and reports.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class Exon:
    id: int
    start: int
    end: int


@dataclasses.dataclass
class Gene:
    name: str = "invalid"
    chr: str = "invalid"
    start: int = 0
    end: int = 0
    exons: List[Exon] = dataclasses.field(default_factory=list)
    reversed: bool = False

    def is_reversed(self) -> bool:
        return self.reversed

    def valid(self) -> bool:
        """reference: src/core/gene.rs:40-42."""
        return self.name != "invalid" and self.start != 0 and self.end != 0

    @staticmethod
    def parse(line: str) -> "Gene":
        """Parse a `>NAME,chr:start-end` header line.

        reference: src/core/gene.rs:44-90. Malformed lines yield the invalid
        default gene; unparsable integers raise ValueError (the reference
        bubbles the parse error up and aborts the run).
        """
        fields = line.split(",")
        if len(fields) < 2:
            return Gene()
        name = fields[0][1:].strip()
        chr_pos = fields[1].split(":")
        if len(chr_pos) < 2:
            return Gene()
        chrom = chr_pos[0].strip()
        rng = chr_pos[1].split("-")
        if len(rng) < 2:
            return Gene()
        start = int(rng[0].strip())
        end = int(rng[1].strip())
        return Gene(name=name, chr=chrom, start=start, end=end)

    def add_exon(self, id: int, start: int, end: int) -> None:
        """reference: src/core/gene.rs:92-107 (reversed inferred from the
        first two exons only)."""
        self.exons.append(Exon(id, start, end))
        if len(self.exons) > 1 and self.exons[0].start > self.exons[1].start:
            self.reversed = True

    def pos2str(self, pos: int) -> str:
        """Gene-relative signed position -> `NAME:exon:N|±chr:abspos`.

        reference: src/core/gene.rs:132-171. If the position falls in no
        exon/intron window, the exon/intron part is omitted entirely.
        """
        pp = abs(pos) + self.start
        out = f"{self.name}:"
        for i, exon in enumerate(self.exons):
            if exon.start <= pp <= exon.end:
                out += f"exon:{exon.id}|"
                break
            if i > 0:
                if self.reversed:
                    if exon.end < pp < self.exons[i - 1].start:
                        out += f"intron:{exon.id - 1}|"
                        break
                else:
                    if self.exons[i - 1].end < pp < exon.start:
                        out += f"intron:{exon.id - 1}|"
                        break
        out += "+" if pos >= 0 else "-"
        out += f"{self.chr}:{pp}"
        return out

    def get_exon_intron(self, pos: int) -> Tuple[bool, int]:
        """-> (is_exon, exon_or_intron_id); (False, -1) when no window
        matches (FusionResult's initial values, fusion_result.rs:50-57).

        Faithful quirk: the reference's prev_exon is initialized to
        exons[0] and NEVER advanced (gene.rs:181-199), so intron windows
        compare against the FIRST exon's bound, not exons[i-1] (pos2str,
        a separate function, does use exons[i-1]). Identical results for
        monotonic exon lists; reproduced exactly for non-monotonic ones."""
        pp = abs(pos) + self.start
        first = self.exons[0] if self.exons else None
        for i, exon in enumerate(self.exons):
            if exon.start <= pp <= exon.end:
                return True, exon.id
            if i > 0:
                if self.reversed:
                    if exon.end < pp < first.start:
                        return False, exon.id - 1
                else:
                    if first.end < pp < exon.start:
                        return False, exon.id - 1
        return False, -1

    def gene_pos_2_chr_pos(self, genepos: int) -> int:
        """reference: src/core/gene.rs:207-214."""
        chrpos = abs(genepos) + self.start
        return -chrpos if genepos < 0 else chrpos
