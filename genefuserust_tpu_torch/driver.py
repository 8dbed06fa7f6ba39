"""Run driver of the port: the single-CSV scan on one torch device.

Mirrors `genefuserust_tpu/driver.py` (reference: src/genefuse.rs:14-87).
A fusion file ending in .csv is one panel: paired-end input goes through
`Scanner.scan_pair_stream`, single-end input through
`Scanner.scan_single_stream`, both on `TorchEngine`. A CSV-list file
(multi-CSV mode) and multi-device meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
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

    if Path(config.fusion_file).suffix != ".csv":
        raise NotImplementedError(
            "a CSV-list fusion file (multi-CSV mode) is not ported yet "
            "(ROADMAP.md, port queue: multi-CSV)"
        )
    engine = make_engine(
        config.engine, config.settings, config.device, config.mesh, config.thread_num
    )
    contigs = fasta.read_all(config.ref_file, force_upper_case=False)
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
