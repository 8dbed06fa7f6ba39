"""CLI of the port: the reference's flags (src/argparse.rs:3-130), plus
`--engine cuda|sharded-index|host`, `--device` and `--mesh`. `-h` is the
HTML report path, so the help flag is `--help`."""

from __future__ import annotations

import argparse
import sys

from .config import Settings
from .driver import RunConfig, genefuse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genefuse-torch",
        description="gene fusion detection on PyTorch/CUDA (GeneFuse-compatible)",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="show this help message and exit")
    p.add_argument("-1", "--read1", required=True, help="read1 file name")
    p.add_argument("-2", "--read2", default="", help="read2 file name")
    p.add_argument("-f", "--fusion", required=True, help="fusion file name, in CSV format")
    p.add_argument("-r", "--ref", required=True, help="reference fasta file name")
    p.add_argument("-u", "--unique", type=int, default=2,
                   help="least supporting read number required to report a fusion, default 2")
    p.add_argument("-h", "--html", default="genefuse.html",
                   help="file name to store HTML report, default is genefuse.html")
    p.add_argument("-j", "--json", default="genefuse.json",
                   help="file name to store JSON report, default is genefuse.json")
    p.add_argument("-t", "--thread", type=int, default=None,
                   help="in-flight batch bound of the engine (unset: 6)")
    p.add_argument("-d", "--deletion", type=int, default=50,
                   help="least deletion length of an intra-gene deletion to report, default 50")
    p.add_argument("-D", "--output_deletions", action="store_true",
                   help="enable to output long deletions")
    p.add_argument("-U", "--output_untranslated_fusions", action="store_true",
                   help="enable to output untranslatable fusions")
    p.add_argument("--engine", choices=["cuda", "tpu", "sharded-index", "host"], default="cuda",
                   help="compute engine: batched torch/CUDA pipeline (default; 'tpu' is "
                   "accepted as its second name, for command lines written for the JAX "
                   "reference), the contig-sharded index (panels beyond one device), or "
                   "the scalar host oracle")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda and sharded-index engines, default "
                   "cuda (cpu runs the kernels' plain versions)")
    p.add_argument("--index-cache", default="",
                   help="directory for the on-disk panel index cache")
    p.add_argument("--mesh", default="auto",
                   help="device count ('auto': every device): the cuda engine gives each "
                   "device whole batches in turn, with the table on each; sharded-index "
                   "takes one shard a device")
    return p


def run(argv=None):
    """Parse `argv` and scan -> the engine that ran the scan."""
    args = build_parser().parse_args(argv)
    config = RunConfig(
        r1_file=args.read1,
        r2_file=args.read2,
        fusion_file=args.fusion,
        html=args.html,
        json=args.json,
        ref_file=args.ref,
        thread_num=args.thread,
        settings=Settings(
            unique_requirement=args.unique,
            deletion_threshold=args.deletion,
            output_deletions=args.output_deletions,
            output_untranslated=args.output_untranslated_fusions,
        ),
        engine=args.engine,
        device=args.device,
        index_cache_dir=args.index_cache,
        mesh=args.mesh,
    )
    return genefuse(config)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
