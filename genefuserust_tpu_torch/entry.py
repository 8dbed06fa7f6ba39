"""Entry point of the port's flagship compute path, for a compile-and-run
check on one device.

The counterpart of the JAX package's `__graft_entry__.py::entry`: the
default-layout index of a small synthetic panel (two genes with two exons
each) and a 64 x 128 batch of reads around a junction between them.
`entry(device)` returns `(fn, example_args)`; `fn(*example_args)` runs
both passes of map_read (`ops/map_read.py::map_read_batch`) on `device`,
through the CUDA kernels on the card and their plain versions on the CPU.

    python -m genefuserust_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch


def _make_index_and_batch(batch: int, read_len: int):
    from .config import Settings
    from .core.indexer import Indexer
    from .core.sequence import encode_bases
    from .models.fusion import Fusion
    from .models.gene import Gene
    from .ops.index import build_packed_index
    from .utils.synthetic import make_panel

    panel = make_panel(seed=3, chrom_len=12000, gene_len=6000)
    fusions = []
    for name, chrom, start, end in panel.genes:
        g = Gene(name=name, chr=chrom, start=start, end=end)
        g.add_exon(1, start + 10, start + 500)
        g.add_exon(2, start + 1000, start + 1500)
        fusions.append(Fusion(g))
    ix = Indexer(panel.contigs, fusions, Settings())
    ix.make_index()
    packed = build_packed_index(ix)  # the default table layout

    rng = np.random.default_rng(0)
    g1, g2 = panel.genes[0], panel.genes[1]
    fused = (
        panel.contigs[g1[1]][g1[2] + 2000 : g1[2] + 2000 + read_len]
        + panel.contigs[g2[1]][g2[2] + 3000 : g2[2] + 3000 + read_len]
    )
    codes = np.full((batch, read_len), 255, np.uint8)
    lengths = np.full(batch, read_len, np.int32)
    for i in range(batch):
        off = int(rng.integers(0, read_len // 2))
        codes[i] = encode_bases(fused[off : off + read_len])
    return packed, codes, lengths


def entry(device="cuda"):
    """-> (fn, example_args): map_read_batch on `device`, ready to call."""
    from .ops.index import index_to_torch
    from .ops.map_read import map_read_batch
    from .parallel.engine import resolve_device

    dev = resolve_device(device)
    packed, codes, lengths = _make_index_and_batch(batch=64, read_len=128)
    fn = functools.partial(map_read_batch, index=index_to_torch(packed, dev), major_req=40,
                           minor_req=20, mismatch_thr=10)
    return fn, (torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run the port's entry() once")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    if out.seg_valid.is_cuda:
        torch.cuda.synchronize()
    print("entry: ok", [tuple(a.shape) for a in example_args],
          "valid segments:", int(out.seg_valid.sum()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
