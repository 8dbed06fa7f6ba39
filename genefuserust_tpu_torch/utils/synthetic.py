"""Synthetic data generation: genomes, panels, planted-fusion reads, and
the read-pair workload of `gen_block` (bench.py's profile='real').

Used by the end-to-end tests and chip_smoke.py. The reference validates e2e
behavior manually against hg19/hg38 (SURVEY §4); those references are not
available here, so we synthesize deterministic genomes with planted fusion
junctions whose expected detections are known by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.read import SequenceRead, SequenceReadPair
from ..core.sequence import COMPLEMENT_LUT, reverse_complement

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng: np.random.Generator, n: int) -> str:
    return rng.choice(_BASES, size=n).tobytes().decode()


@dataclasses.dataclass
class SyntheticPanel:
    contigs: Dict[str, str]
    csv_text: str
    # per gene: (name, chrom, start, end)
    genes: List[Tuple[str, str, int, int]]


def make_panel(
    seed: int = 7,
    chrom_len: int = 30000,
    n_genes: int = 2,
    gene_len: int = 10000,
) -> SyntheticPanel:
    """Two-chromosome genome with one forward gene per chromosome, each with
    evenly spaced exons (exon 500bp / intron 500bp)."""
    rng = np.random.default_rng(seed)
    contigs = {}
    genes = []
    lines = []
    # Poly-A decoy: real genomes contain abundant poly-A runs, which give the
    # quirky Matcher's 1-base query keys (0..3) more than skip_threshold=50
    # index positions so they are skipped (matcher.rs:397,426-429). Without
    # this, tiny random genomes drive the reference binary into its
    # inverted-membership panic (matcher.rs:486-491) — see core/matcher.py.
    decoy = ("A" * 16 + "T" + "A" * 16 + "C" + "A" * 16 + "G") * 60
    for gi in range(n_genes):
        chrom = f"chr{gi + 1}"
        seq = random_seq(rng, chrom_len)
        if gi == 0:
            pos = chrom_len - len(decoy) - 100
            seq = seq[:pos] + decoy + seq[pos + len(decoy) :]
        contigs[chrom] = seq
        start = 5000
        end = start + gene_len
        name = f"GENE{gi + 1}"
        genes.append((name, chrom, start, end))
        lines.append(f">{name},{chrom}:{start}-{end}")
        eid = 1
        pos = start
        while pos + 500 <= end:
            lines.append(f"{eid},{pos},{pos + 500}")
            eid += 1
            pos += 1000
    return SyntheticPanel(contigs, "\n".join(lines) + "\n", genes)


def plant_fusion_pairs(
    panel: SyntheticPanel,
    n_support: int = 6,
    n_background: int = 50,
    read_len: int = 150,
    seed: int = 13,
) -> List[SequenceReadPair]:
    """Paired-end reads: `n_support` spanning a junction between GENE1 and
    GENE2 (left break at gene1-relative 5000, right at gene2-relative 6000),
    plus background pairs sampled from the genome."""
    rng = np.random.default_rng(seed)
    g1_name, g1_chr, g1_start, _ = panel.genes[0]
    g2_name, g2_chr, g2_start, _ = panel.genes[1]
    left_break = g1_start + 5000  # chrom coords; gene-relative 5000
    right_break = g2_start + 6000
    fused = (
        panel.contigs[g1_chr][left_break - 400 : left_break + 1]
        + panel.contigs[g2_chr][right_break : right_break + 400]
    )
    pairs = []
    for k in range(n_support):
        off = 400 - read_len + 25 + 7 * k  # junction near middle of R1
        r1 = fused[off : off + read_len]
        r2_span = fused[off + 40 : off + 40 + read_len]
        name = f"@SYNTH:fusion:{k} 1:N:0:ACGT"
        qual = "I" * read_len
        pairs.append(
            SequenceReadPair(
                SequenceRead(name, r1, "+", qual),
                SequenceRead(name, reverse_complement(r2_span), "+", qual),
            )
        )
    chroms = list(panel.contigs)
    for k in range(n_background):
        chrom = chroms[int(rng.integers(len(chroms)))]
        s = panel.contigs[chrom]
        off = int(rng.integers(0, len(s) - read_len - 60))
        r1 = s[off : off + read_len]
        r2_span = s[off + 40 : off + 40 + read_len]
        name = f"@SYNTH:bg:{k} 1:N:0:ACGT"
        qual = "I" * read_len
        pairs.append(
            SequenceReadPair(
                SequenceRead(name, r1, "+", qual),
                SequenceRead(name, reverse_complement(r2_span), "+", qual),
            )
        )
    return pairs


def write_panel_files(panel: SyntheticPanel, tmpdir: str) -> Tuple[str, str]:
    """-> (fasta_path, csv_path)"""
    import os

    fasta_path = os.path.join(tmpdir, "ref.fa")
    with open(fasta_path, "w") as f:
        for name, seq in panel.contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + "\n")
    csv_path = os.path.join(tmpdir, "panel.csv")
    with open(csv_path, "w") as f:
        f.write(panel.csv_text)
    return fasta_path, csv_path


def write_fastq_files(pairs: List[SequenceReadPair], tmpdir: str) -> Tuple[str, str]:
    import os

    r1 = os.path.join(tmpdir, "R1.fq")
    r2 = os.path.join(tmpdir, "R2.fq")
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for p in pairs:
            f1.write(f"{p.left.name}\n{p.left.seq}\n+\n{p.left.quality}\n")
            f2.write(f"{p.right.name}\n{p.right.seq}\n+\n{p.right.quality}\n")
    return r1, r2


# ---------------- the read-pair workload as matrices ----------------


class ReadMatrix:
    """ReadBlock-shaped view of (n, L) read bytes, qualities and lengths."""

    def __init__(self, seq, qual, lens, tag):
        self.seq = seq
        self.qual = qual
        self.lens = lens
        self.tag = tag

    def __len__(self):
        return len(self.lens)

    def name(self, i):
        return f"@bench:{self.tag}:{i}"

    def read_obj(self, i):
        n = self.lens[i]
        return SequenceRead(
            self.name(i),
            self.seq[i, :n].tobytes().decode("latin-1"),
            "+",
            self.qual[i, :n].tobytes().decode("latin-1"),
        )


class PairMatrix:
    """PairBlock-shaped pair of ReadMatrix sides."""

    def __init__(self, left, right):
        self.left = left
        self.right = right

    def __len__(self):
        return min(len(self.left), len(self.right))


# calibrated to the reference's shipped test reads (see gen_block)
_INSERT_MEAN, _INSERT_SD = 168.0, 8.0
_SUB_ERR_RATE = 0.003          # per base per read
_ERR_LOWQ_FRAC = 0.8           # errors that get a low-qual ('/'=Q14) call
_N_RATE = 0.0005               # no-call rate ('N' base, '#' qual)
_QUAL_CHARS = np.frombuffer(b"EA</6", np.uint8)   # Q36 Q32 Q27 Q14 Q21
_QUAL_P = np.array([0.80, 0.10, 0.04, 0.05, 0.01])


def gen_block(mapper, n: int, read_len: int = 150, seed: int = 2) -> PairMatrix:
    """Read-pair workload as matrices: the JAX package's
    `bench.gen_block(profile="real")`, the same pairs for the same seed.

    70% on-target single-gene pairs, ~30% off-target, 0.1% fusion-junction
    pairs, calibrated to the reference's shipped test reads (151 bp reads,
    merged lengths 161-178 bp, ~5.7% sub-Q20 bases): insert sizes N(168, 8)
    clipped to [read_len + 1, 200], a NextSeq-like quality profile,
    0.3%/base substitution errors (80% of them low-qual, as base-call
    errors are), 0.05% N bases. Most pairs merge through the <= 2
    low-qual-diff tolerance, ~15% fail the merge and take the unmerged
    lanes."""
    gene_seqs = [s for s in mapper.indexer.fusion_seq if s]
    rng = np.random.default_rng(seed)
    ins_lo, ins_hi = read_len + 1, 200
    lens = np.clip(
        np.rint(rng.normal(_INSERT_MEAN, _INSERT_SD, n)), ins_lo, ins_hi
    ).astype(np.int64)
    lmax = int(lens.max())

    n_on = int(n * 0.70)
    n_junc = max(1, int(n * 0.001))
    n_off = n - n_on - n_junc
    offtarget = random_seq(rng, 200000)
    frags = []
    for i in range(n_on):
        L = int(lens[i])
        s = gene_seqs[int(rng.integers(len(gene_seqs)))]
        off = int(rng.integers(0, max(1, len(s) - L)))
        frags.append(s[off : off + L].ljust(lmax, "A"))
    for i in range(n_on, n_on + n_off):
        L = int(lens[i])
        off = int(rng.integers(0, len(offtarget) - L))
        frags.append(offtarget[off : off + L].ljust(lmax, "A"))
    for i in range(n_on + n_off, n):
        L = int(lens[i])
        s1 = gene_seqs[int(rng.integers(len(gene_seqs)))]
        s2 = gene_seqs[int(rng.integers(len(gene_seqs)))]
        o1 = int(rng.integers(0, len(s1) - L))
        o2 = int(rng.integers(0, len(s2) - L))
        frags.append((s1[o1 : o1 + L // 2] + s2[o2 : o2 + L - L // 2]).ljust(lmax, "A"))
    order = rng.permutation(n)
    frags = [frags[i] for i in order]
    lens = lens[order]

    buf = np.frombuffer("".join(frags).encode(), np.uint8).reshape(n, lmax)
    b1 = buf[:, :read_len].copy()
    # R2 = reverse complement of the fragment's last read_len bases
    idx2 = lens[:, None] - read_len + np.arange(read_len)[None, :]
    b2 = COMPLEMENT_LUT[np.take_along_axis(buf, idx2, 1)][:, ::-1].copy()

    base_idx = np.zeros(256, np.uint8)
    base_idx[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def corrupt(b):
        q = rng.choice(_QUAL_CHARS, p=_QUAL_P, size=b.shape)
        err = rng.random(b.shape) < _SUB_ERR_RATE
        sub = rng.integers(1, 4, b.shape).astype(np.uint8)
        b2_ = np.where(err, bases[(base_idx[b] + sub) % 4], b)
        q = np.where(err & (rng.random(b.shape) < _ERR_LOWQ_FRAC), ord("/"), q)
        nmask = rng.random(b.shape) < _N_RATE
        b2_ = np.where(nmask, ord("N"), b2_)
        q = np.where(nmask, ord("#"), q)
        return np.ascontiguousarray(b2_), np.ascontiguousarray(q.astype(np.uint8))

    b1, q1 = corrupt(b1)
    b2, q2 = corrupt(b2)
    rl = np.full(n, read_len, np.int32)
    return PairMatrix(ReadMatrix(b1, q1, rl.copy(), "L"), ReadMatrix(b2, q2, rl.copy(), "R"))


# ---------------- hand-built rows for the pass-1 vote ----------------

DUPE_MOTIF = "ACGTTGCAACGGTTACGATCCAGTTACG"


def long_reads(left: str, right: str, seed: int, span: int = 4200,
               wide: int = 70000) -> Tuple[str, str]:
    """Two reads past the scan kernels' main paths, from a junction: `left`
    ends at it and `right` starts at it (at least span // 2 bases each).

    -> (a `span`-base read across the junction, half from each side: wider
    than the vote's shared-memory sort from 4,096 bases; a `wide`-base
    read: 2,000 bases of `left`'s end, random bases, 2,000 of `right`'s
    start ending 2,000 bases before the read's end, so that its chains end
    past 65,535 bases, and its random middle fails the mismatch test
    before the reference's quadratic segment walk)."""
    rng = np.random.default_rng(seed)
    h = span // 2
    spanning = left[-h:] + right[: span - h]
    middle = wide - 6000
    return spanning, (left[-2000:] + random_seq(rng, middle) + right[:2000]
                      + random_seq(rng, 2000))


def dupe_panel(seed: int = 11) -> SyntheticPanel:
    """make_panel with a 28 bp motif planted 3x in GENE1 (dupe entries) and
    8x in GENE2 (high-level dupes)."""
    panel = make_panel(seed=seed)
    for (_, chrom, start, _), offs in zip(
        panel.genes, ([1000, 3000, 7000], [500 + 1100 * k for k in range(8)])
    ):
        s = panel.contigs[chrom]
        for off in offs:
            s = s[: start + off] + DUPE_MOTIF + s[start + off + len(DUPE_MOTIF) :]
        panel.contigs[chrom] = s
    return panel


def vote_edge_rows(seed: int, layout: str = "kv2", NS: int = 121):
    """Pass-1 probe-result rows built by hand against `dupe_panel`'s table
    -> (rows (B, NS, 2) int32 tensor, the packed table, row names).

    A row holds, per sample s, a (contig, pos) lookup result: a regular hit
    (contig >= 0) votes for key (contig, pos - 2s), DUPE names a dupe row,
    HIGH and EMPTY vote for nothing. The rows cover no valid candidate,
    only key 0, one distinct key, two and three keys tied on count, keys
    whose low half wraps at pos - 2s, a DUPE-heavy row beyond the vote
    kernel's warp path, rows of exactly 31-33, 64-65, 128-129 and 255-257
    candidates (the edges of its register widths), a row with all NS
    samples hit, and random rows. NS = 121 is the main path's largest
    lane (width 256)."""
    import tempfile

    import torch

    from ..config import PASS1_STEP, Settings
    from ..core.indexer import Indexer
    from ..models.fusion import Fusion
    from ..ops.hashtable import DUPE, EMPTY, HIGH
    from ..ops.index import build_packed_index, index_to_torch
    from ..ops.map_read import VOTE_WARP_KEYS, expand, vote_candidates

    panel = dupe_panel()
    with tempfile.TemporaryDirectory() as td:
        _, csv = write_panel_files(panel, td)
        ix = Indexer(panel.contigs, Fusion.parse_csv(csv), Settings())
    ix.make_index()
    packed = build_packed_index(ix, layout=layout)
    index = index_to_torch(packed, "cpu")
    nd = index.dupes.shape[0]
    # valid candidates of each dupe row
    _, _, cv = expand(index, torch.full((nd,), DUPE, dtype=torch.int32),
                      torch.arange(nd, dtype=torch.int32))
    dcount = cv.sum(1).numpy()
    full_rows = np.nonzero(dcount == dcount.max())[0]
    assert dcount.max() >= 3, "the dupe panel has no dupe row of 3 candidates"
    step = PASS1_STEP
    rng = np.random.default_rng(seed)
    rows, names = [], []

    def row(name, cells):
        r = np.zeros((NS, 2), np.int64)
        r[:, 0] = EMPTY
        for s, (c, p) in cells.items():
            r[s] = (c, p)
        rows.append(r)
        names.append(name)

    def hit(contig, lo, s):
        """The lookup result that votes for key (contig, lo) at sample s."""
        return contig, lo + s * step

    def exact(name, n, keys):
        """A row of exactly n valid candidates: dupe samples (largest rows
        first) while n exceeds the samples left, then regular hits on
        `keys` in turn."""
        cells, need = {}, n
        order = np.argsort(-dcount, kind="stable")
        for s in range(NS):
            if need == 0:
                break
            if need > NS - s:
                r = int(next(i for i in order if dcount[i] <= need))
                cells[s], need = (DUPE, r), need - int(dcount[r])
            else:
                cells[s], need = hit(*keys[s % len(keys)], s), need - 1
        assert need == 0, f"{name}: cannot place {n} candidates"
        row(name, cells)

    row("no_valid", {s: (HIGH if s % 3 else EMPTY, 0) for s in range(NS)})
    row("only_key_0", {s: hit(0, 0, s) for s in range(0, 40, 2)})
    row("one_key", {s: hit(1, 5000, s) for s in range(10, 70)})
    two = {s: hit(1, 7000, s) for s in range(0, 40, 2)}
    two.update({s: hit(0, 9000, s) for s in range(1, 41, 2)})
    two.update({s: hit(0, 0, s) for s in range(50, 80)})  # key 0 outvotes both
    row("two_tied", two)
    three = {s: hit(s % 3, 100 * (3 - s % 3), s) for s in range(0, 45)}
    three.update({s: hit(1, 4242, s) for s in range(60, 70)})
    row("three_tied", three)
    # pos - 2s below 0 keeps the contig: (1, 0xFFFFFFFD) sorts after (1, 5)
    # and (0, 0xFFFFFFFF) before (1, 0); pos - 2s below INT32_MIN wraps
    wrap = {s: (1, 2 * s - 3) for s in range(0, 30)}
    wrap.update({s: hit(1, 5, s) for s in range(30, 60)})
    wrap.update({s: hit(0, -1, s) for s in range(60, 80)})
    wrap.update({s: hit(1, 0, s) for s in range(80, 100)})
    wrap.update({s: (2, -(2**31) + s) for s in range(100, NS)})
    row("lo_wraps", wrap)
    row("dupe_heavy", {s: (DUPE, int(full_rows[s % len(full_rows)])) for s in range(NS)})
    for n in (31, 32, 33, 64, 65, 128, 129, 255, 256, 257):
        exact(f"n_{n}", n, [(1, 300), (0, 77), (1, 300), (2, 9)])
    row("all_samples", {s: hit(*((1, 1000) if s % 3 else (0, 1000 + s % 7)), s)
                        for s in range(NS)})
    keyset = [(int(rng.integers(0, 3)), int(rng.integers(-3, 4))) for _ in range(6)]
    for k in range(48):
        cells = {}
        for s in range(NS):
            u = rng.random()
            if u < 0.35:
                cells[s] = hit(*keyset[int(rng.integers(len(keyset)))], s)
            elif u < 0.35 + 0.02 * (k % 8):
                cells[s] = (DUPE, int(rng.integers(0, nd)))
            elif u < 0.8:
                cells[s] = (HIGH, 0)
        row(f"random_{k}", cells)
    pr = np.stack(rows)
    # int32 bit patterns of the wrapped positions
    pr = ((pr + 2**31) % 2**32 - 2**31).astype(np.int32)
    pr_t = torch.from_numpy(pr)
    n = vote_candidates(pr_t, index).numpy()
    for name, want in (("dupe_heavy", VOTE_WARP_KEYS + 1), ("n_257", 257)):
        assert n[names.index(name)] >= want, (name, n[names.index(name)])
    return pr_t, packed, names
