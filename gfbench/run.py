"""Run one cell of BENCHMARK.json once on the card:

    python3 -m gfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the last
lines of standard error are each compared number beside its limit. Exits 2
without a result where CUDA is missing or the card count is short of the
cell's, and 3 where a module of JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genefuserust_tpu", "bench", "tools")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (genefuserust_tpu_torch is not genefuserust_tpu)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _say(obj) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import registry

    chips = registry.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gfbench: the cell needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}, count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from .cell import run_cell

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START, say=_say)
    bad = forbidden_modules()
    if bad:
        print(f"gfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    _say(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
