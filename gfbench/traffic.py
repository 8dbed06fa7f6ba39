"""The one generator of read-pair traffic. A traffic mix is a data file of
parameters (`gfbench/traffic/<name>.json`); this module reads any of them.

A sample is `pairs_per_sample` pairs in a seed-shuffled order, each of one
kind, in counts that the mix fixes and the seed does not change:

  on-target   a fragment of one panel gene (share `on_target`);
  chimera     half a fragment from one gene and half from another
              (share `chimera`, 0 where the mix has none);
  planted     pairs across the fusion junctions `planted.fusions`
              ([gene a, exon a, gene b, exon b], exons 1-based): exon a's
              start joined to exon b's start, `pairs_each` pairs each;
  off-target  a fragment of a random `offtarget_bp`-base sequence (the
              rest).

Fragments take insert sizes N(mean, sd) clipped to [read_len + 1, max]; R1
is a fragment's first read_len bases, R2 the reverse complement of its last.
Planted pairs follow chip_smoke.py's plant_fusions: the j-th pair's R1
starts `read_len - first_cross - cross_step * j` bases before the junction
(j wrapping so that R1 keeps `min_cross` bases each side), its R2 ends
`r2_shift` bases past R1's end, every base quality `qual` and no error.
The others get a quality profile (`quality.chars` drawn with `quality.p`),
substitutions at `errors.sub` a base (`errors.sub_lowq` of them called at
`quality.sub_lowq_char`) and N at `errors.n` a base (quality
`quality.n_char`): the real profile of the port's utils/synthetic.gen_block
(bench.py's profile="real"), drawn in bulk with NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

ON, OFF, CHIMERA, PLANTED = 0, 1, 2, 3
_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMPLEMENT = np.full(256, ord("N"), np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


class ReadSide:
    """One side of a sample's pairs, as the port's blocks hold them: (n, L)
    bases and qualities, lengths, and a read object a row on demand."""

    def __init__(self, seq, qual, lens, mate: int, read_cls: Callable = None):
        self.seq, self.qual, self.lens = seq, qual, lens
        self.mate = mate
        self.read_cls = read_cls

    def __len__(self) -> int:
        return len(self.lens)

    def name(self, i: int) -> str:
        return f"@GF:{i} {self.mate}:N:0:ACGT"

    def read_obj(self, i: int):
        n = int(self.lens[i])
        return self.read_cls(self.name(i), self.seq[i, :n].tobytes().decode("latin-1"), "+",
                             self.qual[i, :n].tobytes().decode("latin-1"))

    def with_reads(self, read_cls: Callable) -> "ReadSide":
        """The same rows, read objects of another class."""
        return ReadSide(self.seq, self.qual, self.lens, self.mate, read_cls)

    def head(self, n: int) -> "ReadSide":
        """The first n rows (views, no copy)."""
        return ReadSide(self.seq[:n], self.qual[:n], self.lens[:n], self.mate, self.read_cls)


@dataclass
class Sample:
    left: ReadSide
    right: ReadSide
    kind: np.ndarray  # (n,) int8: ON, OFF, CHIMERA or PLANTED
    fusion: np.ndarray  # (n,) int8: the planted fusion's index, else -1
    insert: np.ndarray  # (n,) int32 fragment lengths

    def __len__(self) -> int:
        return len(self.kind)

    def with_reads(self, read_cls: Callable) -> "Sample":
        return Sample(self.left.with_reads(read_cls), self.right.with_reads(read_cls),
                      self.kind, self.fusion, self.insert)

    def head(self, n: int) -> "Sample":
        """The first n pairs (views, no copy)."""
        return Sample(self.left.head(n), self.right.head(n), self.kind[:n], self.fusion[:n],
                      self.insert[:n])


def kind_counts(mix: dict) -> dict:
    """How many pairs of each kind a sample holds: fixed by the mix."""
    n = mix["pairs_per_sample"]
    pl = mix.get("planted")
    n_pl = len(pl["fusions"]) * pl["pairs_each"] if pl else 0
    n_on = int(n * mix["on_target"])
    n_ch = int(n * mix.get("chimera", 0))
    return {ON: n_on, CHIMERA: n_ch, PLANTED: n_pl, OFF: n - n_on - n_ch - n_pl}


def junctions(mix: dict, genes: List[np.ndarray], exon_starts, gene_start: int):
    """Each planted fusion's joined sequence (flank + 1 bases of gene a up
    to exon a's start, then flank bases of gene b from exon b's start)."""
    pl = mix["planted"]
    out = []
    for ga, ea, gb, eb in pl["fusions"]:
        lb = exon_starts[ga][ea - 1] - 1 - gene_start  # 1-based CSV -> gene offset
        rb = exon_starts[gb][eb - 1] - 1 - gene_start
        f = pl["flank"]
        out.append(np.concatenate([genes[ga][lb - f : lb + 1], genes[gb][rb : rb + f]]))
    return out


def generate(mix: dict, genes: List[np.ndarray], exon_starts, gene_start: int, seed: int,
             read_cls: Callable = None) -> Sample:
    rng = np.random.default_rng([seed, 2])
    n, rl = mix["pairs_per_sample"], mix["read_len"]
    counts = kind_counts(mix)
    kind = np.concatenate([np.full(counts[k], k, np.int8) for k in (ON, OFF, CHIMERA, PLANTED)])
    kind = kind[rng.permutation(n)]
    ins = mix["insert"]
    lens = np.clip(np.rint(rng.normal(ins["mean"], ins["sd"], n)), rl + 1, ins["max"]).astype(np.int64)

    # every fragment's bases come from one array: the genes, the off-target
    # sequence and the planted junctions, end to end
    offtarget = _BASES[rng.integers(0, 4, mix["offtarget_bp"], dtype=np.uint8)]
    junc = junctions(mix, genes, exon_starts, gene_start) if counts[PLANTED] else []
    parts = [*genes, offtarget, *junc]
    base = np.cumsum([0] + [len(p) for p in parts])
    universe = np.concatenate(parts)
    glen = np.array([len(g) for g in genes], np.int64)
    gbase = base[: len(genes)]

    # a fragment is universe[a + c] for c < cut, universe[b + c - cut] past it
    a = np.zeros(n, np.int64)
    b = np.zeros(n, np.int64)
    cut = lens.copy()
    fusion = np.full(n, -1, np.int8)
    on = np.nonzero(kind == ON)[0]
    g = rng.integers(0, len(genes), len(on))
    a[on] = gbase[g] + rng.integers(0, np.maximum(1, glen[g] - lens[on]))
    off = np.nonzero(kind == OFF)[0]
    a[off] = base[len(genes)] + rng.integers(0, mix["offtarget_bp"] - lens[off])
    ch = np.nonzero(kind == CHIMERA)[0]
    g1 = rng.integers(0, len(genes), len(ch))
    g2 = rng.integers(0, len(genes), len(ch))
    a[ch] = gbase[g1] + rng.integers(0, glen[g1] - lens[ch])
    b[ch] = gbase[g2] + rng.integers(0, glen[g2] - lens[ch])
    cut[ch] = lens[ch] // 2
    pl_rows = np.nonzero(kind == PLANTED)[0]
    if len(pl_rows):
        pl = mix["planted"]
        # how far R1 may start before the junction and still keep
        # min_cross bases on each side of it
        steps = (rl - pl["first_cross"] - pl["min_cross"]) // pl["cross_step"] + 1
        j = np.arange(len(pl_rows)) % pl["pairs_each"]
        k = np.arange(len(pl_rows)) // pl["pairs_each"]
        junction_at = pl["flank"] + 1  # the first base of gene b in a junction
        start = junction_at - (rl - pl["first_cross"] - pl["cross_step"] * (j % steps))
        a[pl_rows] = base[len(genes) + 1 + k] + start
        lens[pl_rows] = pl["r2_shift"] + rl
        cut[pl_rows] = lens[pl_rows]
        fusion[pl_rows] = k

    # rows of one piece are windows of the universe; chimeras take two
    win = np.lib.stride_tricks.sliding_window_view(universe, rl)
    seq1 = win[a]
    seq2 = _COMPLEMENT[win[a + lens - rl][:, ::-1]]
    if len(ch):
        c = np.arange(rl)[None, :]

        def frag(cols):
            return universe[np.where(cols < cut[ch, None], a[ch, None] + cols,
                                     b[ch, None] + cols - cut[ch, None])]

        seq1[ch] = frag(c)
        seq2[ch] = _COMPLEMENT[frag(lens[ch, None] - 1 - c)]

    q = mix["quality"]
    qlut = _quality_lut(q["chars"], q["p"])
    plant = kind == PLANTED
    qual1 = qlut[rng.integers(0, 1 << 16, (n, rl), dtype=np.uint16)]
    qual2 = qlut[rng.integers(0, 1 << 16, (n, rl), dtype=np.uint16)]
    for sq, ql in ((seq1, qual1), (seq2, qual2)):
        _corrupt(rng, sq, ql, mix["errors"], q, plant)
    if len(pl_rows):
        qual1[pl_rows] = qual2[pl_rows] = ord(mix["planted"]["qual"])
    rlens = np.full(n, rl, np.int32)
    return Sample(ReadSide(seq1, qual1, rlens, 1, read_cls), ReadSide(seq2, qual2, rlens.copy(), 2, read_cls),
                  kind, fusion, lens.astype(np.int32))


def _quality_lut(chars: str, p) -> np.ndarray:
    """A 16-bit draw -> a quality character with probabilities `p`."""
    edges = np.rint(np.cumsum(p) * (1 << 16)).astype(np.int64)
    edges[-1] = 1 << 16
    idx = np.searchsorted(edges, np.arange(1 << 16), side="right")
    return np.frombuffer(chars.encode(), np.uint8)[idx]


def _sparse(rng, shape, p: float, skip_rows: np.ndarray) -> tuple:
    """Positions of a per-base event of probability p: the count from the
    binomial law, the positions drawn at random (repeats merged), rows in
    `skip_rows` left out."""
    total = shape[0] * shape[1]
    k = rng.binomial(total, p)
    pos = np.unique(rng.integers(0, total, k))
    r, c = np.divmod(pos, shape[1])
    keep = ~skip_rows[r]
    return r[keep], c[keep]


def _corrupt(rng, seq, qual, err: dict, q: dict, skip_rows) -> None:
    r, c = _sparse(rng, seq.shape, err["sub"], skip_rows)
    code = np.zeros(256, np.uint8)
    code[_BASES] = np.arange(4, dtype=np.uint8)
    seq[r, c] = _BASES[(code[seq[r, c]] + rng.integers(1, 4, len(r))) % 4]
    low = rng.random(len(r)) < err["sub_lowq"]
    qual[r[low], c[low]] = ord(q["sub_lowq_char"])
    r, c = _sparse(rng, seq.shape, err["n"], skip_rows)
    seq[r, c] = ord("N")
    qual[r, c] = ord(q["n_char"])
