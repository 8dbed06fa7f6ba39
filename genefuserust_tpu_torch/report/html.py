"""HTML reporter — byte-identical to the reference modulo timestamp lines.

reference: src/core/html_reporter.rs:39-369 plus the per-read helpers in
read_match.rs:92-113 and read.rs:127-213 (per-base quality coloring, row
toggling, protein exon/intron diagram).
"""

from __future__ import annotations

from ..config import Settings
from ..version import GENEFUSE_VER
from .json import _now_local


def quality_color(qual: str) -> str:
    """reference: src/core/read.rs:275-297."""
    if qual >= "I":
        return "#78C6B9"
    if qual >= "?":
        return "#33BBE2"
    if qual >= "5":
        return "#666666"
    if qual >= "0":
        return "#E99E5B"
    return "#FF0000"


def _html_seq_with_qual(read, start: int, length: int) -> str:
    """reference: src/core/read.rs:199-213."""
    parts = []
    for i in range(start, min(start + length, len(read.seq))):
        q = read.quality[i]
        parts.append(
            f"<a title='{q}'><font color='{quality_color(q)}'>{read.seq[i]}</font></a>"
        )
    return "".join(parts)


def _print_html_td_with_breaks(w, read, breaks) -> None:
    """reference: src/core/read.rs:127-165."""
    w(f"<td class='alignright'>{_html_seq_with_qual(read, 0, breaks[0])}</td>")
    for i in range(len(breaks) - 1):
        w("<td")
        if i == 0:
            w(" class='alignright'")
        w(f">{_html_seq_with_qual(read, breaks[i], breaks[i + 1] - breaks[i])}</td>")
    if breaks[-1] > 0:
        w(
            "<td class='alignleft'>"
            f"{_html_seq_with_qual(read, breaks[-1], len(read.seq) - breaks[-1])}</td>"
        )


def _print_match_html_td(w, me) -> None:
    """reference: src/core/read_match.rs:92-113."""
    w("←" if me.reversed else "→")
    w("</a></span>")
    w(f"</td><td>{me.left_distance}|{me.right_distance}</td>")
    _print_html_td_with_breaks(w, me.read, [me.read_break + 1])


def _print_reads_to_file(w, me) -> None:
    """reference: read_match.rs:115-120 + read.rs:263-272."""
    for r in me.original_reads:
        w(f"{r.name}\n{r.seq}\n{r.strand}\n")
        if r.has_quality:
            w(f"{r.quality}\n")


def _print_exon_intron_td(w, is_exon: bool, forward: bool, number: int, percent: float, style: str) -> None:
    """reference: fusion_result.rs:727-759 (percent truncated to int, min 1)."""
    int_percent = int(percent)
    if int_percent <= 0:
        int_percent = 1
    w(f"<td class='{style}' width='{int_percent}%'>")
    if is_exon:
        w(f"E{number}")
    else:
        w("→" if forward else "←")
    w("</td>")


def _print_left_protein_html(w, fr) -> None:
    """reference: fusion_result.rs:579-648."""
    total_step = fr.left_exon_num + fr.left_intron_num
    exon = 1
    intron = 1
    step = 1
    step_percent = 100.0 / total_step
    half = step_percent * 0.5
    forward = fr.is_left_protein_forward()
    if not forward:
        exon = len(fr.left_gene.exons)
        intron = exon - 1
        step = -1
    w("<table width='100%' class='protein_table'>\n<tr>")
    print_exon = 0.0
    print_intron = 0.0
    while print_exon < fr.left_exon_num or print_intron < fr.left_intron_num:
        if print_exon < fr.left_exon_num:
            percent = half if print_exon + 1.0 > fr.left_exon_num else step_percent
            _print_exon_intron_td(w, True, forward, exon, percent, "exon_left")
            print_exon += 1.0
            exon += step
        if print_intron < fr.left_intron_num:
            percent = half if print_intron + 1.0 > fr.left_intron_num else step_percent
            _print_exon_intron_td(w, False, forward, intron, percent, "intron_left")
            print_intron += 1.0
            intron += step
    w("</tr></table>")


def _print_right_protein_html(w, fr) -> None:
    """reference: fusion_result.rs:650-725."""
    total_step = fr.right_exon_num + fr.right_intron_num
    exon = fr.right_exon_or_intron_id
    intron = fr.right_exon_or_intron_id
    step = 1
    step_percent = 100.0 / total_step
    half = step_percent * 0.5
    forward = fr.is_right_protein_forward()
    if not forward:
        step = -1
    w("<table width='100%' class='protein_table'>\n<tr>")
    print_exon = 0.0
    print_intron = 0.0
    if not fr.right_is_exon:
        _print_exon_intron_td(w, False, forward, intron, half, "intron_right")
        print_intron += 0.5
        intron += step
        if forward:
            exon += step
    while print_exon < fr.right_exon_num or print_intron < fr.right_intron_num:
        if print_exon < fr.right_exon_num:
            percent = half if (fr.right_is_exon and print_exon == 0.0) else step_percent
            _print_exon_intron_td(w, True, forward, exon, percent, "exon_right")
            if fr.right_is_exon and print_exon == 0.0:
                print_exon += 0.5
            else:
                print_exon += 1.0
            exon += step
        if print_intron < fr.right_intron_num:
            _print_exon_intron_td(w, False, forward, intron, step_percent, "intron_right")
            print_intron += 1.0
            intron += step
    w("</tr></table>")


def print_fusion_protein_html(w, fr) -> None:
    """reference: fusion_result.rs:514-577 (note the right td reuses
    left_percent — faithful)."""
    fr.calc_left_exon_intron_number()
    fr.calc_right_exon_intron_number()
    left_size = fr.left_exon_num + fr.left_intron_num
    right_size = fr.right_exon_num + fr.right_intron_num
    # Rust f32 .round() rounds half away from zero
    val = left_size * 100.0 / (left_size + right_size)
    import math

    left_percent = int(math.floor(val + 0.5)) if val >= 0 else int(math.ceil(val - 0.5))
    right_percent = 100 - left_percent
    if left_percent == 0:
        left_percent = 1
    if right_percent == 0:
        right_percent = 1
    w("<table width='100%' class='protein_table'>\n")
    w("<tr>")
    w(f"<td width='{left_percent}%'>")
    w(fr.left_gene.name)
    w("</td>")
    w(f"<td width='{right_percent}%'>")
    w(fr.right_gene.name)
    w("</td>")
    w("</tr>")
    w("<tr>")
    w(f"<td class='protein_left' width='{left_percent}%'>")
    _print_left_protein_html(w, fr)
    w("</td>")
    w(f"<td class='protein_right' width='{left_percent}%'>")
    _print_right_protein_html(w, fr)
    w("</td>")
    w("</tr>")
    w("</table>")


_CSS = (
    '<style type="text/css">'
    "td {border:1px solid #dddddd;padding-left:2px;padding-right:2px;font-size:10px;}"
    "table {border:1px solid #999999;padding:2x;border-collapse:collapse;}"
    "img {padding:30px;}"
    ".alignleft {text-align:left;}"
    ".alignright {text-align:right;}"
    ".software {font-weight:bold;font-size:24px;padding:5px;}"
    ".header {color:#ffffff;padding:1px;height:20px;background:#000000;}"
    ".figuretitle {color:#996657;font-size:20px;padding:50px;}"
    "#container {text-align:center;padding:1px;font-family:Arail,'Liberation Mono', Menlo, Courier, monospace;}"
    "#menu {padding-top:10px;padding-bottom:10px;text-align:left;}"
    "#menu a {color:#0366d6; font-size:18px;font-weight:600;line-height:28px;text-decoration:none;font-family:-apple-system, BlinkMacSystemFont, 'Segoe UI', Helvetica, Arial, sans-serif, 'Apple Color Emoji', 'Segoe UI Emoji', 'Segoe UI Symbol'}"
    "a:visited {color: #999999}"
    ".menu_item {text-align:left;padding-top:5px;font-size:18px;}"
    ".highlight {text-align:left;padding-top:30px;padding-bottom:30px;font-size:20px;line-height:35px;}"
    ".fusion_head {text-align:left;color:#0092FF;font-family:Arial;padding-top:20px;padding-bottom:5px;}"
    ".fusion_block {}"
    ".match_brief {font-size:8px}"
    ".fusion_point {color:#FFCCAA}"
    "#helper {text-align:left;border:1px dotted #fafafa;color:#777777;font-size:12px;}"
    "#footer {text-align:left;padding-left:10px;padding-top:20px;color:#777777;font-size:10px;}"
    ".exon_left{background:blue;color:white;border:0px;padding:0px;font-size:8px;}"
    ".exon_right{background:red;color:white;0px;padding:0px;font-size:8px;}"
    ".intron_left{color:blue;0px;padding:0px;font-size:8px;}"
    ".intron_right{color:red;0px;padding:0px;font-size:8px;}"
    ".protein_table{text-align:center;font-size:8px;}"
    ".tips{font-size:10px;padding:5px;color:#666666;text-align:left;}"
    "</style>"
)

# NOTE: the reference writes these via Rust string-continuation escapes
# (`\` + newline, html_reporter.rs:164-192), which strip the newline AND the
# next line's leading whitespace — so the emitted JS has no indentation.
_JS = (
    '<script type="text/javascript">\n'
    "function toggle(targetid){ \n"
    "if (document.getElementById){ \n"
    "target=document.getElementById(targetid); \n"
    "if (target.style.display=='table-row'){ \n"
    "target.style.display='none'; \n"
    "} else { \n"
    "target.style.display='table-row'; \n"
    "} \n"
    "} \n"
    "}"
    "function toggle_target_list(targetid){ \n"
    "if (document.getElementById){ \n"
    "target=document.getElementById(targetid); \n"
    "if (target.style.display=='block'){ \n"
    "target.style.display='none'; \n"
    "document.getElementById('target_view_btn').value='view';\n"
    "} else { \n"
    "document.getElementById('target_view_btn').value='hide';\n"
    "target.style.display='block'; \n"
    "} \n"
    "} \n"
    "}"
    "</script>"
)


class HtmlReporter:
    def __init__(self, filename: str, mapper, command: str, settings: Settings):
        self.filename = filename
        self.mapper = mapper
        self.command = command
        self.settings = settings

    def run(self) -> None:
        out = []
        w = out.append
        self._header(w)
        self._helper(w)
        self._fusions(w)
        self._footer(w)
        with open(self.filename, "w") as f:
            f.write("".join(out))

    def _header(self, w) -> None:
        w(
            '<html><head><meta http-equiv="content-type" content="text/html;charset=utf-8" />'
        )
        w(f"<title>GeneFuse {GENEFUSE_VER}, at {_now_local()}</title>")
        w(_JS)
        w(_CSS)
        w("</head>")
        w("<body><div id='container'>")
        w(
            "<div class='software'> "
            "<a href='https://github.com/OpenGene/GeneFuse' style='text-decoration:none;' "
            f"target='_blank'>GeneFuse</a> <font size='-1'>{GENEFUSE_VER}</font></div>"
        )

    def _helper(self, w) -> None:
        w("<div id='helper'><p>Helpful tips:</p><ul>")
        w(
            "<li> Base color indicates quality: <font color='#78C6B9'>extremely high (Q40+)</font>, "
            "<font color='#33BBE2'>high (Q30~Q39) </font>, <font color='#666666'>moderate (Q20~Q29)</font>, "
            "<font color='#E99E5B'>low (Q15~Q19)</font>, <font color='#FF0000'>extremely low (0~Q14).</font> </li>"
        )
        w("<li> Move mouse over the base, it will show the quality value</li>")
        w("<li> Click on any row, the original read/pair will be displayed</li>")
        w(
            "<li> For pair-end sequencing, GeneFuse tries to merge each pair, "
            "with overlapped assigned higher qualities </li>"
        )
        w("</ul><p>Columns:</p><ul>")
        w(
            "<li> col1: is fusion mapped with original read? → means original "
            "read, ← means reverse complement</li>"
        )
        w(
            "<li> col2: edit distance (ed) between read and reference sequence "
            "(left_part_ed | right_part_ed)</li>"
        )
        w("<li> col3: read's left part after fusion break</li>")
        w("<li> col4: read's right part after fusion break</li>")
        w("</ul></div>")

    def _fusions(self, w) -> None:
        results = self.mapper.fusion_results
        found = len(results)
        w(f"<div id='menu'><p>Found {found} fusion")
        if found > 1:
            w("s")
        w(":</p><ul>")
        for i, fr in enumerate(results):
            w(
                f"<li class='menu_item'><a href='#fusion_id_{i + 1}'> "
                f"{i + 1}, {fr.title}</a></li>"
            )
        w("</ul></div>")
        st = self.settings
        fid = 0
        for fr in results:
            if not st.output_deletions and fr.is_deletion():
                continue
            if fr.is_left_protein_forward() != fr.is_right_protein_forward():
                if not st.output_untranslated:
                    continue
            fid += 1
            self._fusion(w, fid, fr)

    def _fusion(self, w, fid: int, fr) -> None:
        w("<div class='fusion_block'>")
        w(f"<div class='fusion_head'><a name='fusion_id_{fid}'>")
        w(f"{fid}, {fr.title}")
        w("</a></div>")
        w("<div class='tips'>Inferred protein")
        if fr.is_left_protein_forward() != fr.is_right_protein_forward():
            w(
                " (transcription direction conflicts, this fusion may be not transcribed) "
            )
        w(":</div>")
        print_fusion_protein_html(w, fr)
        w("<div class='tips'>Supporting reads:</div>")
        w("<table>")
        w("<tr class='header'>")
        w(
            f"<td class='alignright' colspan='3'>{fr.left_pos} = "
            "<font color='yellow'>↓</font></td>"
        )
        w(
            f"<td class='alignleft'><font color='yellow'>↓</font> = "
            f"{fr.right_pos}</td>"
        )
        w("</tr>")
        w("<tr class='header'>")
        w(
            f"<td class='alignright' colspan='3'><a title='{fr.left_ref}___"
            f"{fr.left_ref_ext}'>{fr.left_ref}</a></td>"
        )
        w(
            f"<td class='alignleft'><a title='{fr.right_ref_ext}___"
            f"{fr.right_ref}'>{fr.right_ref}</a></td>"
        )
        w("</tr>")
        for m, me in enumerate(fr.matches):
            rowid = fid * 100000 + m
            w(f"<tr onclick='toggle({rowid});'>")
            w("<td>")
            w(f"<a title='{me.read.name}'>")
            if (m + 1) < 10:
                w("0")
            if (m + 1) < 100:
                w("0")
            if (m + 1) < 1000:
                w("0")
            w(f"{m + 1}")
            _print_match_html_td(w, me)
            w("</tr>")
            w(f"<tr id='{rowid}' style='display:none;'>")
            w("<td colspan='6'><xmp>")
            _print_reads_to_file(w, me)
            w("</xmp></td>")
            w("</tr>")
        w("</table></div>")

    def _footer(self, w) -> None:
        w("<div id='footer'> ")
        w(f"<p>{self.command}</p>")
        w(f"GeneFuse {GENEFUSE_VER}, at {_now_local()} </div>")
        w("</div></body></html>")
