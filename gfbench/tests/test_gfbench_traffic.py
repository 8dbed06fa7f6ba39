"""The traffic generator: the same pairs for the same seed, each kind of
pair in the count and place that the mix file gives."""

import numpy as np

from gfbench import panel, registry, traffic
from gfbench.reference.sequence import reverse_complement


def _make(tmp_path, small, seed, mix=None):
    cfg = {**registry.config("cancer15"), **small["config"]}
    mix = mix or {**registry.traffic("pe-targeted"), **small["traffic"]}
    p = panel.make_panel(cfg, seed, str(tmp_path))
    return p, mix, traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, seed)


def test_same_seed_same_pairs(tmp_path, small):
    for d in "abc":
        (tmp_path / d).mkdir()
    _, _, a = _make(tmp_path / "a", small, 2**31 + 99)
    _, _, b = _make(tmp_path / "b", small, 2**31 + 99)
    for x, y in ((a.left.seq, b.left.seq), (a.left.qual, b.left.qual), (a.right.seq, b.right.seq),
                 (a.right.qual, b.right.qual), (a.kind, b.kind), (a.insert, b.insert)):
        assert np.array_equal(x, y)
    _, _, c = _make(tmp_path / "c", small, 2**31 + 100)
    assert not np.array_equal(a.left.seq, c.left.seq)


def test_kind_counts_do_not_depend_on_the_seed(tmp_path, small):
    mix = {**registry.traffic("pe-targeted"), **small["traffic"]}
    want = traffic.kind_counts(mix)
    assert want[traffic.CHIMERA] == int(4096 * 0.01)
    assert want[traffic.PLANTED] == 2 * 16
    for seed in (1, 2):
        (tmp_path / str(seed)).mkdir()
        _, _, s = _make(tmp_path / str(seed), small, seed)
        assert {k: int((s.kind == k).sum()) for k in want} == want


def test_full_size_shares():
    mix = registry.traffic("pe-targeted")
    c = traffic.kind_counts(mix)
    assert sum(c.values()) == 1_048_576
    assert c[traffic.CHIMERA] == 0  # no random chimeras (the mix's `assumed`)
    assert c[traffic.PLANTED] == 2 * 16
    assert c[traffic.ON] == int(1_048_576 * 0.70)


def test_chimeras_join_two_genes(tmp_path, small):
    p, mix, s = _make(tmp_path, small, 7)
    genes = [g.tobytes() for g in p.genes]
    rl = mix["read_len"]
    for i in np.nonzero(s.kind == traffic.CHIMERA)[0][:20]:
        cut = s.insert[i] // 2
        r1 = s.left.seq[i].tobytes()
        # the first half of R1 comes from one gene, the rest from another
        # (substitutions and N aside: compare a clean stretch)
        head, tail = r1[: cut - 2], r1[cut + 2 :]
        assert s.left.qual[i].min() >= 0 and len(r1) == rl
        assert _in_some(genes, head) and _in_some(genes, tail)


def _in_some(genes, piece, errors_ok=4, k=12):
    """piece occurs in some gene with at most errors_ok differing bases
    (located by any of its k-base stretches)."""
    for off in range(0, len(piece) - k + 1, k):
        for g in genes:
            at = g.find(piece[off : off + k])
            while at >= 0:
                cand = g[at - off : at - off + len(piece)]
                if at >= off and len(cand) == len(piece) and \
                        sum(x != y for x, y in zip(cand, piece)) <= errors_ok:
                    return True
                at = g.find(piece[off : off + k], at + 1)
    return False


def test_planted_pairs_span_their_junctions(tmp_path, small):
    p, mix, s = _make(tmp_path, small, 11)
    pl = mix["planted"]
    juncs = [j.tobytes().decode() for j in traffic.junctions(mix, p.genes, p.exon_starts,
                                                               p.gene_start)]
    rl = mix["read_len"]
    for k, (ga, ea, gb, eb) in enumerate(pl["fusions"]):
        rows = np.nonzero(s.fusion == k)[0]
        assert len(rows) == pl["pairs_each"]
        # the junction: exon ea's start of gene ga, then exon eb's start of gene gb
        lb = p.exon_starts[ga][ea - 1] - 1 - p.gene_start
        rb = p.exon_starts[gb][eb - 1] - 1 - p.gene_start
        assert juncs[k][: pl["flank"] + 1] == p.genes[ga][lb - pl["flank"] : lb + 1].tobytes().decode()
        assert juncs[k][pl["flank"] + 1 :] == p.genes[gb][rb : rb + pl["flank"]].tobytes().decode()
        for i in rows:
            r1 = s.left.seq[i].tobytes().decode()
            at = juncs[k].find(r1)
            assert at >= 0
            left = pl["flank"] + 1 - at  # R1's bases before the junction
            assert pl["min_cross"] <= left <= rl - pl["min_cross"]
            r2 = reverse_complement(s.right.seq[i].tobytes().decode())
            assert juncs[k].find(r2) == at + pl["r2_shift"]
            assert set(s.left.qual[i].tobytes()) == {ord(pl["qual"])}


def test_error_rates(tmp_path):
    mix = {**registry.traffic("pe-targeted"), "pairs_per_sample": 65536}
    cfg = {**registry.config("cancer15"), "genes": 30, "panel_bp": 360_000}
    p = panel.make_panel(cfg, 5, str(tmp_path))
    s = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, 5)
    n_rate = (s.left.seq == ord("N")).mean()
    assert abs(n_rate - mix["errors"]["n"]) < 0.2 * mix["errors"]["n"]
    q = s.left.qual[s.kind != traffic.PLANTED]
    assert abs((q == ord("E")).mean() - 0.80) < 0.01
    assert s.insert.min() >= mix["read_len"] + 1 and s.insert.max() <= mix["insert"]["max"]
