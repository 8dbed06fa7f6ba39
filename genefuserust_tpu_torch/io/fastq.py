"""FASTQ streaming with the reference's exact record semantics.

reference: src/core/fastq_reader.rs:19-219.
  - 4-line records (name, seq, strand, qual)
  - only a trailing '\\n' is stripped (a '\\r' from CRLF files is KEPT —
    reference strips exactly one trailing newline char: fastq_reader.rs:82-88)
  - per-line byte cap of 1000 (reference LimitedBufReader panics on longer
    lines; we raise RuntimeError)
  - extension sniffing: .fastq/.fq/.fasta/.fa (+.gz) else hard error
  - the pair reader stops at the shorter of the two files
"""

from __future__ import annotations

import gzip
from typing import Iterator, Optional, Tuple

from ..config import FASTQ_LINE_LIMIT
from ..core.read import SequenceRead, SequenceReadPair

_EXTS = (".fastq", ".fq", ".fasta", ".fa")


def _check_ext(path: str) -> None:
    base = path[:-3] if path.endswith(".gz") else path
    if not base.endswith(_EXTS):
        raise SystemExit(
            "ERROR: the input file should be fastq (.fq, .fastq) or gzipped "
            f"fastq (.fq.gz, .fastq.gz) {path}"
        )


class FastqReader:
    def __init__(self, path: str, has_quality: bool = True):
        _check_ext(path)
        self.path = path
        self.has_quality = has_quality
        self._f = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _line(self) -> Optional[str]:
        raw = self._f.readline(FASTQ_LINE_LIMIT + 1)
        if not raw:
            return None
        if len(raw) > FASTQ_LINE_LIMIT:
            raise RuntimeError(
                f"FASTQ line exceeds {FASTQ_LINE_LIMIT} bytes in {self.path} "
                "(reference LimitedBufReader panics)"
            )
        s = raw.decode("latin-1")
        if s.endswith("\n"):
            s = s[:-1]
        return s

    def read(self) -> Optional[SequenceRead]:
        name = self._line()
        if name is None:
            return None
        seq = self._line()
        if seq is None:
            return None
        strand = self._line()
        if strand is None:
            return None
        if self.has_quality:
            qual = self._line()
            if qual is None:
                return None
        else:
            qual = ""
        return SequenceRead(name, seq, strand, qual, self.has_quality)

    def __iter__(self) -> Iterator[SequenceRead]:
        while True:
            r = self.read()
            if r is None:
                return
            yield r

    def close(self) -> None:
        self._f.close()


class FastqReaderPair:
    def __init__(self, left_path: str, right_path: str):
        self.left = FastqReader(left_path, True)
        self.right = FastqReader(right_path, True)

    def read(self) -> Optional[SequenceReadPair]:
        l = self.left.read()
        r = self.right.read()
        if l is None or r is None:
            return None
        return SequenceReadPair(l, r)

    def __iter__(self) -> Iterator[SequenceReadPair]:
        while True:
            p = self.read()
            if p is None:
                return
            yield p

    def close(self) -> None:
        self.left.close()
        self.right.close()
