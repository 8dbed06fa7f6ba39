"""Build, load and launch the hand-written CUDA kernels of csrc/.

The sources are compiled at first use with `nvcc` for `sm_90a` into one
shared library with a plain C interface (build/, named by a digest of the
sources), loaded with ctypes. Every entry point takes device pointers and
the current stream, launches on that stream, allocates nothing and returns
`cudaGetLastError()`; a nonzero code raises here.

`LAUNCHES` counts the kernel launches made through the wrappers in
ops/map_read.py, one per launch, so a run can show which kernels it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("probe.cu", "vote.cu", "mask_segments.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {"probe": 0, "vote": 0, "mask_segments": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgfkernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ unless this exact source set is built already -> the
    library path. The compiler's register/shared-memory report is kept
    beside it as `<lib>.log`."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-8000:]}")
    with open(so + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.gf_probe.argtypes = [P, P, P, P, ctypes.c_longlong, I, I, I,
                                     P, P, I, I, I, I, I, P, P]
            lib.gf_vote.argtypes = [P, I, I, P, I, I, I, I, I, I, I, I, I, P, P]
            lib.gf_mask_segments.argtypes = [P, P, P, I, I, P, I, I, I, I, I, I,
                                             P, P]
            for fn in (lib.gf_probe, lib.gf_vote, lib.gf_mask_segments):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _done(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _dupe_args(index):
    """(dupes row stride in int32, candidate width D)."""
    d = index.dupes
    return (d.shape[1] * d.shape[2] if index.split else d.shape[1]), index.D


def launch_probe(codes, lengths, kmers, valid, n, W, stride, NQ, index, out) -> None:
    if index.table.data_ptr() % 16:
        raise ValueError("probe: table rows must be 16-byte aligned")
    dev = out.device
    with torch.cuda.device(dev):
        err = library().gf_probe(
            _ptr(codes), _ptr(lengths), _ptr(kmers), _ptr(valid), n, W, stride, NQ,
            index.table.data_ptr(), index.vals.data_ptr() if index.split else None,
            int(index.split), index.S, index.shift, index.cbits, index.pos_bias,
            out.data_ptr(), _stream(out),
        )
    _done("probe", err)


def launch_vote(pr, B, NS, index, step, major_req, minor_req, P2, out) -> None:
    dstride, D = _dupe_args(index)
    with torch.cuda.device(out.device):
        err = library().gf_vote(
            pr.data_ptr(), B, NS, index.dupes.data_ptr(), dstride, D,
            int(index.split), index.cbits, index.pos_bias, step,
            major_req, minor_req, P2, out.data_ptr(), _stream(out),
        )
    _done("vote", err)


def launch_mask_segments(pr, lengths, gp, B, NK, index, mismatch_thr, out) -> None:
    dstride, D = _dupe_args(index)
    with torch.cuda.device(out.device):
        err = library().gf_mask_segments(
            pr.data_ptr(), lengths.data_ptr(), gp.data_ptr(), B, NK,
            index.dupes.data_ptr(), dstride, D, int(index.split), index.cbits,
            index.pos_bias, mismatch_thr, out.data_ptr(), _stream(out),
        )
    _done("mask_segments", err)
