"""Run driver of the port: single- and multi-CSV scans on one torch device.

Mirrors `genefuserust_tpu/driver.py` (reference: src/genefuse.rs:14-87,
src/core/fusion_scan.rs:62-330). A fusion file ending in .csv is one
panel: paired-end input goes through `Scanner.scan_pair_stream`,
single-end input through `Scanner.scan_single_stream`. Any other fusion
file is a list of CSV paths (multi-CSV mode): the reads are loaded once,
paired-end input is scanned against every panel in one pass
(`scan_pair_block_multi`), single-end input panel by panel, and each
panel gets its own `{stem}_{csv_stem}.{ext}` reports with logging and the
stdout fusion blocks suppressed.

Engines: 'cuda', or 'tpu', its second name for command lines written for
the JAX reference (`TorchEngine` over `--mesh` devices, whole batches in
turn with the table on each, or over an explicit device list; one device
when the mesh resolves to one), 'sharded-index' (`ShardedIndexEngine`,
the panel's table split by contig over `--mesh` devices, one shard each,
or over an explicit device list) and 'host' (the scalar oracle).
`--mesh` resolves as in the JAX driver (`parallel/mesh.py::resolve_mesh`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

from .config import Settings
from .version import GENEFUSE_VER

log = logging.getLogger("genefuse")


@dataclasses.dataclass
class RunConfig:
    r1_file: str
    r2_file: str
    fusion_file: str
    html: str
    json: str
    ref_file: str
    thread_num: Optional[int] = None
    settings: Settings = dataclasses.field(default_factory=Settings)
    engine: str = "cuda"  # 'cuda' or 'tpu' (TorchEngine) | 'sharded-index' | 'host' (scalar oracle)
    index_cache_dir: str = ""
    mesh: str = "auto"  # cuda: the data-parallel devices; sharded-index: the shard count
    device: str = "cuda"  # torch device (type) of the engine
    # in place of --mesh (API only): cuda, the entries that take batches in
    # turn; sharded-index, one device per shard. A device may repeat:
    # several entries or shards on one card
    devices: Optional[Sequence[str]] = None


def init_logger() -> None:
    """stderr logging, reference pattern `[{d}] {T} {t} {l}>> {m}`
    (src/utils/logging.rs:7-40), root level INFO."""
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(
        logging.Formatter(
            "[%(asctime)s] %(threadName)s %(name)s %(levelname)s>> %(message)s"
        )
    )
    if not log.handlers:
        log.addHandler(h)
    log.setLevel(logging.INFO)


def check_file_valid(path: str) -> None:
    """reference: src/utils/mod.rs:11-29."""
    if not os.path.isfile(path):
        print(f"ERROR: file '{path}' doesn't exist, quit now")
        raise SystemExit(-1)


def make_engine(kind: str, settings: Settings, device: str = "cuda",
                mesh: str = "auto", thread_num=None, devices=None):
    if kind == "host":
        from .core.scanner import HostEngine

        return HostEngine()
    if kind not in ("cuda", "tpu", "sharded-index"):
        raise ValueError(f"unknown engine {kind!r}")
    from .parallel.mesh import resolve_mesh

    devs = list(devices) if devices else resolve_mesh(mesh, device)
    if kind == "sharded-index":
        # contig-sharded index for panels beyond one device's memory
        from .parallel.sharded_engine import ShardedIndexEngine

        return ShardedIndexEngine(settings, devices=devs)
    from .parallel.engine import TorchEngine

    if not devices and len(devs) == 1:
        devs = [device]  # one device: the one asked for (cuda:1 stays cuda:1)
    # -t bounds the batches in flight, as in the JAX driver
    return TorchEngine(
        settings, devices=devs,
        pipeline_depth=6 if thread_num is None else max(2, min(16, thread_num)),
    )


def genefuse(config: RunConfig):
    """Run one scan with the reference's console output -> the engine."""
    init_logger()
    command = " ".join(sys.argv) if sys.argv else "genefuse-torch"
    for path in (config.ref_file, config.r1_file, config.r2_file, config.fusion_file):
        if path:
            check_file_valid(path)
    print(f"\n# {command}\n")
    t0 = time.time()
    engine = scan(config, command)
    print(f"# genefuse v{GENEFUSE_VER}, time used: {time.time() - t0} seconds\n")
    log.info("done")
    return engine


def scan(config: RunConfig, command: str):
    """Scan and write the reports -> the engine that ran the scan."""
    from .core.scanner import Scanner
    from .io import fasta
    from .io.fastq_block import stream_fastq_blocks, stream_pair_blocks

    engine = make_engine(
        config.engine, config.settings, config.device, config.mesh, config.thread_num,
        config.devices,
    )
    contigs = fasta.read_all(config.ref_file, force_upper_case=False)
    if Path(config.fusion_file).suffix != ".csv":
        _scan_multi_csv(config, command, engine, contigs)
        return engine
    scanner = Scanner(
        config.fusion_file, contigs, config.html, config.json, config.settings,
        engine, multi_csv_mode=False, command=command,
        index_cache_dir=config.index_cache_dir, ref_file=config.ref_file,
    )
    if config.r2_file:
        scanner.scan_pair_stream(stream_pair_blocks(config.r1_file, config.r2_file))
    else:
        scanner.scan_single_stream(stream_fastq_blocks(config.r1_file))
    return engine


def _scan_multi_csv(config: RunConfig, command: str, engine, contigs) -> None:
    """Multi-CSV mode (reference: fusion_scan.rs:62-188)."""
    from .core.mapper import FusionMapper
    from .core.scanner import Scanner, finish_scan
    from .io.fastq_block import read_fastq_block, read_pair_block
    from .utils.pbar import prepare_pbar_force, set_multi_csv_mode

    log.info("Reading input seqeunces...")
    pairs = reads = None
    if config.r2_file:
        pairs = read_pair_block(config.r1_file, config.r2_file)
    else:
        reads = read_fastq_block(config.r1_file)
    csv_paths = _read_csv_list(config.fusion_file)
    html_names = _report_names(config.html, csv_paths)
    json_names = _report_names(config.json, csv_paths)
    log.info("Multi csv input mode enabled. Suppress all logging messages while "
             "doing jobs in parallel.")
    prev_level = log.level
    log.setLevel(logging.CRITICAL)
    set_multi_csv_mode(True)
    pb = prepare_pbar_force(len(csv_paths))
    pb.set_message("Scanning fusions given in csv...")
    try:
        if pairs is not None and hasattr(engine, "scan_pair_block_multi"):
            # one pass over the reads serves every panel: merge, pack and
            # upload are panel-independent
            mappers = [
                FusionMapper(contigs, csv, config.settings, multi_csv_mode=True,
                             index_cache_dir=config.index_cache_dir,
                             ref_file=config.ref_file)
                for csv in csv_paths
            ]
            engine.scan_pair_block_multi(mappers, pairs)
            engine.flush()
            for i, mapper in enumerate(mappers):
                finish_scan(mapper, html_names[i] if html_names else "",
                            json_names[i] if json_names else "", command, config.settings)
                pb.inc(1)
        else:
            for i, csv in enumerate(csv_paths):
                scanner = Scanner(
                    csv, contigs, html_names[i] if html_names else "",
                    json_names[i] if json_names else "", config.settings, engine,
                    multi_csv_mode=True, command=command,
                    index_cache_dir=config.index_cache_dir, ref_file=config.ref_file,
                )
                # the last CSV's mapper keeps the shared genome index
                # (core/matcher.py) alive until this one has found it
                if pairs is not None:
                    mapper = scanner.scan_pair_block(pairs)
                else:
                    mapper = scanner.scan_single_block(reads)
                pb.inc(1)
    finally:
        pb.finish_and_clear()
        set_multi_csv_mode(False)
        log.setLevel(prev_level)


def _read_csv_list(path: str) -> List[str]:
    """reference: fusion_scan.rs:253-280."""
    out = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if not os.path.isfile(s):
                print(f"Fusion csv file '{s}' was not found.", file=sys.stderr)
                raise SystemExit(-1)
            out.append(s)
    return out


def _report_names(report_file: str, csv_paths: List[str]) -> List[str]:
    """`{parent}/{stem}_{csv_stem}.{ext}` per CSV (fusion_scan.rs:190-251)."""
    if not report_file:
        return []
    p = Path(report_file)
    parent = str(p.parent) if str(p.parent) != "." else ""
    out = []
    for csv in csv_paths:
        name = f"{p.stem}_{Path(csv).stem}{p.suffix}"
        out.append(os.path.join(parent, name) if parent else name)
    return out
