"""The gather-floor probe: random table-row gathers summed per tile.

Port of the JAX package's two profiling Pallas kernels,
tools/profiling/profile_dma_ring.py (`build(...).kernel`: one int32 sum
per tile of 1,024 indices) and tools/profiling/profile_pallas_gather.py
(`main().kernel`: the same sum written over a 128-lane output row). On the
card it measures how fast random rows of a table that does not fit in L2
can be read: the floor under the scan's table probe.

    python -m genefuserust_tpu_torch.profiling.gather_floor \\
        --rows 4194304 --width 128 --queries 131072 [--lanes 1] [--seed 0]

prints the card's name and power limit, then the kernel's time against
its plain version's, ns/row, rows/s, requested bytes/s (rows * W * 4) and
DRAM-sector bytes/s (rows * max(32, W * 4)). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from ..ops import cuda

TILE = 1024  # indices per tile, as on the TPU (its SMEM layout T(1024))
M32 = 0xFFFFFFFF


def tile_row_sums(idx: torch.Tensor, tbl: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """Plain version: (tiles*1024,) int32 indices, (nb, W) int32 table ->
    (tiles,) int32 for lanes=1, (tiles, 128) for lanes=128; each the
    int32-wrapping sum of every element of the tile's rows."""
    rows = tbl[idx.to(torch.int64)]
    s = rows.reshape(-1, TILE * tbl.shape[1]).sum(dim=1, dtype=torch.int64) & M32
    s = torch.where(s > 0x7FFFFFFF, s - (1 << 32), s).to(torch.int32)
    return s if lanes == 1 else s[:, None].expand(-1, lanes).contiguous()


def gather_tile_sums(idx: torch.Tensor, tbl: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """Kernel 4 (csrc/gather_sum.cu) for CUDA tensors, `tile_row_sums` for
    CPU tensors. Indices must lie in [0, nb); the kernel does not check."""
    dev = idx.device
    cuda.check_tensor(idx, "idx", torch.int32, 1, dev)
    cuda.check_tensor(tbl, "tbl", torch.int32, 2, dev)
    if idx.shape[0] % TILE:
        raise ValueError(f"gather_tile_sums: {idx.shape[0]} indices are not whole tiles of {TILE}")
    if lanes not in (1, 128):
        raise ValueError(f"gather_tile_sums: lanes must be 1 or 128, got {lanes}")
    if dev.type == "cpu":
        return tile_row_sums(idx, tbl, lanes)
    tiles = idx.shape[0] // TILE
    out = torch.empty((tiles,) if lanes == 1 else (tiles, lanes), dtype=torch.int32, device=dev)
    if tiles:
        cuda.launch_gather_tile_sums(idx, tbl, lanes, out)
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# enqueue time that event_ms covers by holding the stream busy, and the
# clock rate its busy wait is sized at (above the card's, so it overshoots)
COVER_S = 0.05
SLEEP_HZ = 2e9


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs after two warm-up
    runs. While the runs are enqueued the stream is held busy
    (`torch.cuda._sleep`, for twice the enqueue time the second warm-up
    run took), so a kernel that is shorter than its host call is timed at
    the device's pace, not the host's. Runs that take more than COVER_S to
    enqueue (plain versions of many small ops) are timed as they come."""
    fn()
    t = time.perf_counter()
    fn()
    host_s = (time.perf_counter() - t) * reps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if host_s < COVER_S:
        torch.cuda._sleep(int(2 * host_s * SLEEP_HZ) + 1)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def rates(rows: int, width: int, ms: float) -> dict:
    """Per-row time and the read rates of `rows` random rows in `ms`."""
    s = ms / 1e3
    return dict(ns_per_row=ms * 1e6 / rows, rows_per_s=rows / s,
                requested_bytes_per_s=rows * width * 4 / s,
                sector_bytes_per_s=rows * max(32, width * 4) / s)


def measure(idx, tbl, lanes: int = 1, reps: int = 20, plain_reps: int = 3) -> dict:
    """Kernel against plain on the card: bit equality, both times, rates."""
    got = gather_tile_sums(idx, tbl, lanes)
    exp = tile_row_sums(idx, tbl, lanes)
    torch.cuda.synchronize()
    if not torch.equal(got, exp):
        raise RuntimeError("gather_tile_sums differs from tile_row_sums")
    ms = event_ms(lambda: gather_tile_sums(idx, tbl, lanes), reps)
    plain_ms = event_ms(lambda: tile_row_sums(idx, tbl, lanes), plain_reps)
    return dict(rows=idx.shape[0], width=tbl.shape[1], lanes=lanes, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, **rates(idx.shape[0], tbl.shape[1], ms))


def random_inputs(rows: int, width: int, queries: int, seed: int, device="cuda"):
    """A random int32[rows, width] table and `queries` row indices, made on
    `device` from the seed -> (idx, tbl)."""
    g = torch.Generator(device=device).manual_seed(seed)
    tbl = torch.randint(-2**31, 2**31, (rows, width), dtype=torch.int32, device=device,
                        generator=g)
    idx = torch.randint(0, rows, (queries,), dtype=torch.int32, device=device, generator=g)
    return idx, tbl


def run(argv=None) -> dict:
    """The command line's work: build a random table and indices on the
    card from the seed, print the card and the measurement -> the
    measurement. Raises without a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 22, help="table rows (nb)")
    ap.add_argument("--width", type=int, default=128, help="int32 per row (W)")
    ap.add_argument("--queries", type=int, default=1 << 17, help="indices, whole tiles of 1024")
    ap.add_argument("--lanes", type=int, default=1, choices=(1, 128))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gather_floor needs a CUDA device")
    print(f"card: {card_line()}", flush=True)
    idx, tbl = random_inputs(args.rows, args.width, args.queries, args.seed)
    r = measure(idx, tbl, args.lanes)
    print(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in r.items()), flush=True)
    return r


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("gather_floor: no CUDA device", file=sys.stderr)
        return 2
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
