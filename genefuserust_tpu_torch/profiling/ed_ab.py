"""A/B of the Myers kernel against another build of csrc/edit_distance.cu.

    python -m genefuserust_tpu_torch.profiling.ed_ab --baseline DIR \\
        [--jobs 64,128,...,65536] [--lengths 80-110,100-300] [--seed 1] [--out FILE]

DIR is the csrc/ directory of another checkout (for one, the parent
commit unpacked with `git archive`). Its edit_distance.cu is built alone
for sm_90a into a library of its own. For each range of job lengths, the
script makes the largest flush of synthetic jobs (`ed_jobs`: a random
sequence and a copy with ~2% edits) and, for each flush size, encodes
the first n jobs as the batcher encodes a flush
(`parallel/ed_batch.encode_jobs`). The port's kernel and the baseline's
run on the same tensors in one process: they must agree bit for bit, and
on the largest flush the first 500 jobs must equal host Myers. Both are
timed with `gather_floor.event_ms`. Prints the card's name and power
limit, one JSON line per (lengths, n) and, per range of lengths, the
crossover: the smallest n from which the baseline is faster at every
larger n measured (null when the port's kernel wins at the largest).
A baseline whose `gf_edit_distance` takes a block size from
`gf_edit_distance_block(W)` (the one-thread-a-job kernel) is called so.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from ..core.edit_distance import edit_distance
from ..ops import cuda
from ..ops import edit_distance as ted
from ..parallel import ed_batch
from .gather_floor import card_line, event_ms

JOBS = tuple(1 << k for k in range(6, 17))  # 64 .. 65,536
LENGTHS = ("80-110", "100-300")  # read halves of a scan's flush; phase 9's jobs


def ed_jobs(n: int, seed: int, lo: int = 100, hi: int = 300):
    """n (a, b) pairs: a of lo-hi random bases, b = a with ~2% edits (half
    substitutions, a quarter each insertions and deletions)."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    abc = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for L in rng.integers(lo, hi + 1, n).tolist():
        a = abc[rng.integers(0, 4, L)].tobytes().decode()
        b = list(a)
        for _ in range(int(rng.binomial(L, 0.02))):
            p, op = int(rng.integers(0, len(b))), rng.random()
            if op < 0.5:
                b[p] = bases[int(rng.integers(0, 4))]
            elif op < 0.75 and len(b) > 1:
                del b[p]
            else:
                b.insert(p, bases[int(rng.integers(0, 4))])
        jobs.append((a, "".join(b)))
    return jobs


def baseline_launcher(csrc: str):
    """Build DIR's edit_distance.cu -> fn(pc, pl, tc, tl, W, out) that
    launches it on the current stream."""
    lib = ctypes.CDLL(cuda.build(("edit_distance.cu",), csrc=os.path.abspath(csrc)))
    P, I = ctypes.c_void_p, ctypes.c_int
    blocked = hasattr(lib, "gf_edit_distance_block")
    lib.gf_edit_distance.argtypes = [P, P, P, P, I, I, I, I, *([I] if blocked else []), P, P]
    lib.gf_edit_distance.restype = ctypes.c_int
    if blocked:
        lib.gf_edit_distance_block.argtypes = [I]
        lib.gf_edit_distance_block.restype = ctypes.c_int

    def launch(pc, pl, tc, tl, W, out):
        extra = [lib.gf_edit_distance_block(W)] if blocked else []
        err = lib.gf_edit_distance(
            pc.data_ptr(), pl.data_ptr(), tc.data_ptr(), tl.data_ptr(), pc.shape[0],
            pc.shape[1], tc.shape[1], W, *extra, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline edit_distance launch failed: CUDA error {err}")

    return launch


def run(argv=None) -> list:
    """The command line's work -> the records printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="csrc/ directory of the baseline")
    ap.add_argument("--jobs", default=",".join(map(str, JOBS)))
    ap.add_argument("--lengths", default=",".join(LENGTHS))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also write the records here, one JSON line each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ed_ab needs a CUDA device")
    sizes = sorted(int(n) for n in args.jobs.split(","))
    base = baseline_launcher(args.baseline)
    print(f"card: {card_line()}", flush=True)
    records = []
    for rng_s in args.lengths.split(","):
        lo, hi = map(int, rng_s.split("-"))
        jobs = ed_jobs(sizes[-1], args.seed, lo, hi)
        per = []
        for n in sizes:
            host, arrays = ed_batch.encode_jobs(jobs[:n])
            if host.any():
                raise RuntimeError("ed_ab: a synthetic job was routed to host Myers")
            a = [torch.from_numpy(x).cuda() for x in arrays]
            W = a[0].shape[1] // 32
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            got = ted.edit_distance_batch(*a, W)
            base(*a, W, out)
            torch.cuda.synchronize()
            if not torch.equal(got, out):
                raise RuntimeError(f"ed_ab: the kernels differ at {n} jobs of {rng_s} bases")
            if n == sizes[-1]:
                exp = [edit_distance(q, r) for q, r in jobs[:500]]
                if got[:500].cpu().tolist() != exp:
                    raise RuntimeError("ed_ab: the kernel differs from host Myers")
            rec = dict(lengths=rng_s, jobs=n, W=W, Lt=a[2].shape[1],
                       ms=event_ms(lambda: ted.edit_distance_batch(*a, W), args.reps),
                       baseline_ms=event_ms(lambda: base(*a, W, out), args.reps))
            per.append(rec)
            print(json.dumps(rec), flush=True)
        slower = [r["jobs"] for r in per if r["baseline_ms"] < r["ms"]]
        cross = next((r["jobs"] for r in per
                      if all(m in slower for m in sizes if m >= r["jobs"])), None)
        summary = dict(lengths=rng_s, crossover_jobs=cross)
        print(json.dumps(summary), flush=True)
        records += per + [summary]
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))
    return records


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("ed_ab: no CUDA device", file=sys.stderr)
        return 2
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
