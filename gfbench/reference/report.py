"""The fusions block of the JSON report, as the reference writes it.

reference: src/core/json_reporter.rs:34-112 (hand-rolled JSON with the
exact tab/space layout, trailing `, ` after left/right blocks included).
The lines before the block (command, version, time) are not compared and
are not written.
"""

from __future__ import annotations

from .config import Settings


class JsonReporter:
    def __init__(self, mapper, settings: Settings):
        self.mapper = mapper
        self.settings = settings

    def fusions_block(self) -> str:
        """The report from its `"fusions":{` line to its end."""
        st = self.settings
        out = []
        w = out.append
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
        return "".join(out)
