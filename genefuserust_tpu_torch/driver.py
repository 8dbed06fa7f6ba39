"""Run driver of the port: single- and multi-CSV scans on one torch device.

Mirrors `genefuserust_tpu/driver.py` (reference: src/genefuse.rs:14-87,
src/core/fusion_scan.rs:62-330). A fusion file ending in .csv is one
panel: paired-end input goes through `Scanner.scan_pair_stream`,
single-end input through `Scanner.scan_single_stream`. Any other fusion
file is a list of CSV paths (multi-CSV mode): the reads are loaded once,
paired-end input is scanned against every panel in one pass
(`scan_pair_block_multi`), single-end input panel by panel, and each
panel gets its own `{stem}_{csv_stem}.{ext}` reports with logging and the
stdout fusion blocks suppressed. Multi-device meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from pathlib import Path

from genefuserust_tpu import driver as _jax_driver
from genefuserust_tpu.config import Settings
from genefuserust_tpu.version import GENEFUSE_VER

log = _jax_driver.log


@dataclasses.dataclass
class RunConfig(_jax_driver.RunConfig):
    engine: str = "cuda"  # 'cuda' (TorchEngine) | 'host' (scalar oracle)
    device: str = "cuda"  # torch device of TorchEngine


def make_engine(kind: str, settings: Settings, device: str = "cuda",
                mesh: str = "auto", thread_num=None):
    if mesh not in ("", "auto", "1"):
        raise NotImplementedError(
            f"--mesh {mesh}: multi-GPU data parallelism is not ported yet "
            "(ROADMAP.md, port queue: multi-GPU)"
        )
    if kind == "host":
        from genefuserust_tpu.core.scanner import HostEngine

        return HostEngine()
    if kind != "cuda":
        raise ValueError(f"unknown engine {kind!r}")
    from .parallel.engine import TorchEngine

    # -t bounds the batches in flight, as in the JAX driver
    return TorchEngine(
        settings, device=device,
        pipeline_depth=6 if thread_num is None else max(2, min(16, thread_num)),
    )


def genefuse(config: RunConfig):
    """Run one scan with the reference's console output -> the engine."""
    _jax_driver.init_logger()
    command = " ".join(sys.argv) if sys.argv else "genefuse-torch"
    for path in (config.ref_file, config.r1_file, config.r2_file, config.fusion_file):
        if path:
            _jax_driver.check_file_valid(path)
    print(f"\n# {command}\n")
    t0 = time.time()
    engine = scan(config, command)
    print(f"# genefuse v{GENEFUSE_VER}, time used: {time.time() - t0} seconds\n")
    log.info("done")
    return engine


def scan(config: RunConfig, command: str):
    """Scan and write the reports -> the engine that ran the scan."""
    from genefuserust_tpu.core.scanner import Scanner
    from genefuserust_tpu.io import fasta
    from genefuserust_tpu.io.fastq_block import stream_fastq_blocks, stream_pair_blocks

    engine = make_engine(
        config.engine, config.settings, config.device, config.mesh, config.thread_num
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
    """Multi-CSV mode (genefuserust_tpu/driver.py:171-248)."""
    from genefuserust_tpu.core.mapper import FusionMapper
    from genefuserust_tpu.core.scanner import Scanner, finish_scan
    from genefuserust_tpu.io.fastq_block import read_fastq_block, read_pair_block
    from genefuserust_tpu.utils.pbar import prepare_pbar_force, set_multi_csv_mode

    log.info("Reading input seqeunces...")
    pairs = reads = None
    if config.r2_file:
        pairs = read_pair_block(config.r1_file, config.r2_file)
    else:
        reads = read_fastq_block(config.r1_file)
    csv_paths = _jax_driver._read_csv_list(config.fusion_file)
    html_names = _jax_driver._report_names(config.html, csv_paths)
    json_names = _jax_driver._report_names(config.json, csv_paths)
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
                if pairs is not None:
                    scanner.scan_pair_block(pairs)
                else:
                    scanner.scan_single_block(reads)
                pb.inc(1)
    finally:
        pb.finish_and_clear()
        set_multi_csv_mode(False)
        log.setLevel(prev_level)
