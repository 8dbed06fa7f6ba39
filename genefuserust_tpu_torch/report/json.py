"""JSON reporter — byte-identical to the reference modulo the time line.

reference: src/core/json_reporter.rs:34-112 (hand-rolled JSON with the
exact tab/space layout, trailing `, ` after left/right blocks included).
"""

from __future__ import annotations

from datetime import datetime
from typing import Optional

from ..config import Settings
from ..version import GENEFUSE_VER


def _now_local() -> str:
    """chrono Local::now() Display format: e.g.
    `2024-02-01 12:34:56.789012345 +09:00`. We format to the same shape
    (nanoseconds padded from microseconds; timestamp lines are excluded
    from equality checks anyway)."""
    now = datetime.now().astimezone()
    off = now.strftime("%z")
    off = off[:3] + ":" + off[3:]
    return now.strftime("%Y-%m-%d %H:%M:%S.%f") + f"000 {off}"


class JsonReporter:
    def __init__(self, filename: str, mapper, command: str, settings: Settings):
        self.filename = filename
        self.mapper = mapper
        self.command = command
        self.settings = settings

    def run(self) -> None:
        st = self.settings
        out = []
        w = out.append
        w("{\n")
        w(f'\t"command":"{self.command}",\n')
        w(f'\t"version":"{GENEFUSE_VER}",\n')
        w(f'\t"time":"{_now_local()}",\n')
        w('\t"fusions":{')
        is_first = True
        for fusion in self.mapper.fusion_results:
            matches = fusion.matches
            if not st.output_deletions and fusion.is_deletion():
                continue
            if fusion.is_left_protein_forward() != fusion.is_right_protein_forward():
                if not st.output_untranslated:
                    continue
            if is_first:
                w("\n")
                is_first = False
            else:
                w(",\n")
            w(f'\t\t"{fusion.title}":{{\n')
            for side, gene, gp, ref, ref_ext, pos_str, is_exon, eid, fwd in (
                (
                    "left",
                    fusion.left_gene,
                    fusion.left_gp,
                    fusion.left_ref,
                    fusion.left_ref_ext,
                    fusion.left_pos,
                    fusion.left_is_exon,
                    fusion.left_exon_or_intron_id,
                    fusion.is_left_protein_forward(),
                ),
                (
                    "right",
                    fusion.right_gene,
                    fusion.right_gp,
                    fusion.right_ref,
                    fusion.right_ref_ext,
                    fusion.right_pos,
                    fusion.right_is_exon,
                    fusion.right_exon_or_intron_id,
                    fusion.is_right_protein_forward(),
                ),
            ):
                w(f'\t\t\t"{side}":{{\n')
                w(f'\t\t\t\t"gene_name":"{gene.name}",\n')
                w(f'\t\t\t\t"gene_chr":"{gene.chr}",\n')
                w(f'\t\t\t\t"position":{gene.gene_pos_2_chr_pos(gp.position)},\n')
                w(f'\t\t\t\t"reference":"{ref}",\n')
                w(f'\t\t\t\t"ref_ext":"{ref_ext}",\n')
                w(f'\t\t\t\t"pos_str":"{pos_str}",\n')
                w(f'\t\t\t\t"exon_or_intron":"{"exon" if is_exon else "intron"}",\n')
                w(f'\t\t\t\t"exon_or_intron_id":{eid},\n')
                w(f'\t\t\t\t"strand":"{"forward" if fwd else "reversed"}"\n')
                w("\t\t\t}, \n")
            w(f'\t\t\t"unique":{fusion.unique},\n')
            w('\t\t\t"reads":[\n')
            for m, me in enumerate(matches):
                w("\t\t\t\t{\n")
                w(f'\t\t\t\t\t"break":{me.read_break},\n')
                w(
                    f'\t\t\t\t\t"strand":"{"reversed" if me.reversed else "forward"}",\n'
                )
                w(f'\t\t\t\t\t"seq":"{me.read.seq}",\n')
                w(f'\t\t\t\t\t"qual":"{me.read.quality}"\n')
                w("\t\t\t\t}")
                if m != len(matches) - 1:
                    w(",")
                w("\n")
            w("\t\t\t]\n")
            w("\t\t}")
        w("\n\t}\n}\n\n")
        with open(self.filename, "w") as f:
            f.write("".join(out))
