"""FASTA loading as the reference does it (src/core/fasta_reader.rs).

Every contig, keyed by the header up to its first space or newline, its
sequence with every byte that is not a letter, '-' or '*' removed, case
kept; the dict is ordered by contig name (the reference's BTreeMap).
"""

from __future__ import annotations

from typing import Dict

_DELETE = bytes(b for b in range(256)
                if not ((chr(b).isascii() and chr(b).isalpha()) or chr(b) in "-*"))


def read_all(path: str) -> Dict[str, str]:
    with open(path, "rb") as f:
        data = f.read()
    first = data.find(b">")
    if first < 0:
        raise RuntimeError(f"Loaded file is empty: {path}")
    contigs: Dict[str, str] = {}
    for chunk in data[first + 1 :].split(b">"):
        if not chunk:
            continue
        cuts = [c for c in (chunk.find(b"\n"), chunk.find(b" ")) if c >= 0]
        cut = min(cuts) if cuts else len(chunk)
        rest = chunk[cut + 1 :] if cut < len(chunk) else b""
        contigs[chunk[:cut].decode("latin-1")] = rest.translate(None, _DELETE).decode("latin-1")
    return dict(sorted(contigs.items()))
