"""Entry points of the port: a compile-and-run check of the flagship
compute path on one device, and a dry run of the multi-device paths.

The counterparts of the JAX package's `__graft_entry__.py::entry` and
`::dryrun_multichip`. `entry(device)` returns `(fn, example_args)`: the
default-layout index of a small synthetic panel (two genes with two exons
each) and a 64 x 128 batch of reads around a junction between them;
`fn(*example_args)` runs both passes of map_read
(`ops/map_read.py::map_read_batch`) on `device`, through the CUDA kernels
on the card and their plain versions on the CPU. `dryrun_multichip(n)`
runs the four multi-device paths on an n-entry device list, each against
its one-device or host twin.

    python -m genefuserust_tpu_torch.entry [--device cpu] [--dryrun-multichip N]
"""

from __future__ import annotations

import argparse
import functools
from typing import List

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


def device_list(n_devices: int, device="cuda") -> List[torch.device]:
    """n entries: the first n cards when `device` is "cuda" and the machine
    has that many, else n entries of the one device (a card, or the CPU),
    each with its own streams in TorchEngine."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The port's multi-device paths on an n-entry device list
    (`device_list`), each asserted byte-identical (JSON, timestamps masked)
    to its one-device or host twin, with the planted fusion found:

      1. PE scan through TorchEngine(devices=...): whole batches in turn,
         the table on each device (reference flow: src/core/
         pescanner.rs:296-348), every entry given a batch;
      2. SE scan through the same engine (sescanner.rs:183-205 analog);
      3. the contig-sharded index over n shards (ShardedIndexEngine), the
         whole-genome-panel path, against the host oracle;
      4. multi-CSV mode through the driver (`driver.genefuse`) with a
         CSV-list fusion file and `RunConfig.devices`: per-CSV reports
         named {stem}_{csv_stem} (fusion_scan.rs:62-188,190-251), against
         the one-device run.
    """
    import os
    import re
    import tempfile

    from .config import Settings
    from .core.scanner import HostEngine, Scanner
    from .driver import RunConfig, genefuse
    from .parallel.engine import TorchEngine, resolve_device
    from .parallel.sharded_engine import ShardedIndexEngine
    from .utils.synthetic import (
        make_panel,
        plant_fusion_pairs,
        write_fastq_files,
        write_panel_files,
    )

    def check(cond, msg):
        if not cond:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {msg}")

    devices = [resolve_device(d) for d in device_list(n_devices, device)]
    ts = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")
    batch = 8
    panel = make_panel(seed=3)
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=batch * n_devices)

    with tempfile.TemporaryDirectory() as td:
        _, csv_path = write_panel_files(panel, td)

        def run(tag, engine, se=False):
            html, json = f"{td}/{tag}.html", f"{td}/{tag}.json"
            sc = Scanner(csv_path, panel.contigs, html, json, Settings(), engine=engine,
                         command="dryrun")
            if se:
                sc.scan_singles([p.left for p in pairs])
            else:
                sc.scan_pairs(pairs)
            return ts.sub("<ts>", open(json).read())

        # 1. PE, batches in turn over the list
        mesh = TorchEngine(Settings(), batch_size=batch, devices=devices)
        j_mesh = run("mesh", mesh)
        j_one = run("one", TorchEngine(Settings(), batch_size=batch, device=devices[0]))
        check('"unique"' in j_mesh, "planted fusion not detected on the device list")
        check(j_mesh == j_one, "PE scan on the device list diverged from one device")
        check(min(mesh.entry_batches) >= 1, f"an entry took no batch: {mesh.entry_batches}")

        # 2. SE, batches in turn over the list
        j_se_mesh = run("se_mesh", TorchEngine(Settings(), batch_size=batch, devices=devices),
                        se=True)
        j_se_one = run("se_one", TorchEngine(Settings(), batch_size=batch, device=devices[0]),
                       se=True)
        check(j_se_mesh == j_se_one, "SE scan on the device list diverged")

        # 3. contig-sharded index engine vs host oracle
        j_sh = run("shidx", ShardedIndexEngine(Settings(), devices=devices, batch_size=batch))
        j_host = run("host", HostEngine())
        check(j_sh == j_host, "sharded-index scan diverged from the host oracle")

        # 4. multi-CSV mode through the driver, device list vs one device
        r1, r2 = write_fastq_files(pairs, td)
        with open(f"{td}/panel2.csv", "w") as f:
            f.write(panel.csv_text)  # same genome; second CSV = same panel
        with open(f"{td}/csvlist.txt", "w") as f:
            f.write(f"{csv_path}\n{td}/panel2.csv\n")

        def run_multi(tag, devs):
            genefuse(RunConfig(r1_file=r1, r2_file=r2, fusion_file=f"{td}/csvlist.txt",
                               html=f"{td}/m_{tag}.html", json=f"{td}/m_{tag}.json",
                               ref_file=f"{td}/ref.fa", device=str(devices[0]), mesh="1",
                               devices=devs))
            outs = []
            for stem in ("panel", "panel2"):
                p = f"{td}/m_{tag}_{stem}.json"
                check(os.path.exists(p), f"per-CSV report missing: {p}")
                outs.append(ts.sub("<ts>", open(p).read()))
            return outs

        m_mesh = run_multi("mesh", [str(d) for d in devices])
        m_one = run_multi("one", None)
        check(all('"unique"' in j for j in m_mesh), "multi-CSV: no fusion")
        check(m_mesh == m_one, "multi-CSV run on the device list diverged")
    print(f"dryrun_multichip({n_devices}): ok - 4 paths on "
          f"[{', '.join(str(d) for d in devices)}] (PE, SE, sharded-index, driver "
          "multi-CSV), all JSON byte-identical to their one-device/host twins, fusions "
          "detected")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run the port's entry() once, or its "
                                 "multi-device dry run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun-multichip", type=int, metavar="N", default=0,
                    help="run dryrun_multichip(N) on --device instead of entry()")
    args = ap.parse_args(argv)
    if args.dryrun_multichip:
        dryrun_multichip(args.dryrun_multichip, args.device)
        return 0
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    if out.seg_valid.is_cuda:
        torch.cuda.synchronize()
    print("entry: ok", [tuple(a.shape) for a in example_args],
          "valid segments:", int(out.seg_valid.sum()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
