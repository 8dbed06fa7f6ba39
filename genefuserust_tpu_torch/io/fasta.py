"""FASTA loading with the reference's exact parsing semantics.

reference: src/core/fasta_reader.rs:38-201.
  - plain or gzip (MultiGzDecoder-equivalent: gzip module reads all members)
  - records delimited on '>'
  - header = bytes up to the FIRST space or newline; note the reference then
    filters the *rest of the chunk* — including any header description text —
    into the sequence (alphabetic chars, '-' and '*' kept). We reproduce that
    faithfully.
  - `force_upper_case` uppercases during filtering; the panel indexer loads
    with force_upper_case=False and uppercases gene slices later
    (reference: src/core/indexer.rs:154-159).
  - contigs stored in a name-sorted map (BTreeMap) — iteration order matters
    for the whole-genome Matcher.
"""

from __future__ import annotations

import gzip
from typing import Dict


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


_KEEP = bytearray(256)
for _b in range(256):
    _c = chr(_b)
    _KEEP[_b] = 1 if (_c.isascii() and _c.isalpha()) or _c in "-*" else 0

_SEQ_FILTER_DELETE = bytes(b for b in range(256) if not _KEEP[b])
_UPPER_TABLE = bytes.maketrans(
    bytes(range(ord("a"), ord("z") + 1)), bytes(range(ord("A"), ord("Z") + 1))
)


def read_all(path: str, force_upper_case: bool = False) -> Dict[str, str]:
    """Load every contig. Returns a dict ordered by contig name (BTreeMap
    iteration order, reference: src/core/fasta_reader.rs:35,189-201)."""
    with _open_maybe_gz(path) as f:
        data = f.read()
    first = data.find(b">")
    if first < 0:
        raise RuntimeError(f"Loaded file is empty: {path}")
    from ..utils.pbar import prepare_pbar_force

    pbar = prepare_pbar_force(0)
    pbar.set_message("Reading references...")
    contigs: Dict[str, str] = {}
    for chunk in data[first + 1 :].split(b">"):
        if not chunk:
            continue
        pbar.inc(1)
        # header: up to first space or newline
        cut_nl = chunk.find(b"\n")
        cut_sp = chunk.find(b" ")
        cuts = [c for c in (cut_nl, cut_sp) if c >= 0]
        cut = min(cuts) if cuts else len(chunk)
        header = chunk[:cut].decode("latin-1")
        rest = chunk[cut + 1 :] if cut < len(chunk) else b""
        seq = rest.translate(None, _SEQ_FILTER_DELETE)
        if force_upper_case:
            seq = seq.translate(_UPPER_TABLE)
        contigs[header] = seq.decode("latin-1")
    pbar.finish_and_clear()
    return dict(sorted(contigs.items()))
