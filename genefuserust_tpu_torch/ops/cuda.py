"""Build, load and launch the hand-written CUDA kernels of csrc/.

The sources are compiled at first use with `nvcc` for `sm_90a` into one
shared library with a plain C interface (build/, named by a digest of the
sources), loaded with ctypes. Every entry point takes device pointers and
the current stream, launches on that stream, allocates nothing and returns
`cudaGetLastError()`; a nonzero code raises here.

`LAUNCHES` counts the kernel launches made through the wrappers in
ops/map_read.py, ops/fused.py, ops/edit_distance.py and
profiling/gather_floor.py, one
per launch, so a run can show which kernels it used. The probe counts as
"probe" on kv tables (`probe_kernel`) and on split tables (its split
kernel, `probe_split_kernel`), and as "probe_kvs" and "probe_kv16" on
the single-probe tables (its variant, `probe_single_kernel`). The vote
kernel counts as "vote" in its gated mode and as "vote_counts" in its counts
mode (the contig-sharded index, where one launch of `vote_shards_kernel`
votes a device's shards and counts once). The wide-row paths count apart
from their kernels' main paths: "vote_wide" and "vote_counts_wide" (the
two modes of the wide vote's second launch; its first is the vote's; rows
whose keys pass its shared memory take a third launch, counted as
"vote_wide_global" and "vote_counts_wide_global"), "mask_segments_wide",
"shard_flags_wide" and "mask_from_flags_wide" (the launches on code rows
past 65,535 bases).
The glue of fused_scan_lanes counts each of its kernels under its own
name: "lane_unpack" and "lane_exceptions" (one of each for up to
MAX_LANES lanes), "compact_count" and "compact_place" (one of each a
compaction; no count launch for zero rows; the place launch also copies
the code rows of up to MAX_LANES lanes) and "survivor_rows" (the code
rows of each further MAX_LANES lanes).
The device-side pair merge (ops/merge.py, ops/fused.py; off the main
path) counts its kernels as "merge_bytes" (merge_batch), "merge_codes"
(the merge of the upload rows, with or without the three map-code lanes)
and "merge_rows" (the rows of the vote and pass-2 passes over merged codes
and upload rows), one a launch.
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
SOURCES = ("probe.cu", "vote.cu", "mask_segments.cu", "gather_sum.cu", "edit_distance.cu",
           "fused_glue.cu", "merge.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {"probe": 0, "probe_kvs": 0, "probe_kv16": 0, "vote": 0, "mask_segments": 0,
            "gather_sum": 0, "edit_distance": 0,
            "vote_counts": 0, "vote_wide": 0, "vote_counts_wide": 0, "mask_segments_wide": 0,
            "vote_wide_global": 0, "vote_counts_wide_global": 0,
            "merge_top2": 0, "shard_flags": 0, "shard_flags_wide": 0, "mask_from_flags": 0,
            "mask_from_flags_wide": 0,
            "lane_unpack": 0, "lane_exceptions": 0, "compact_count": 0, "compact_place": 0,
            "survivor_rows": 0, "merge_bytes": 0, "merge_codes": 0, "merge_rows": 0}
# lanes one unpack, exception, place or survivor_rows launch takes
# (MAX_LANES in csrc/fused_glue.cu)
MAX_LANES = 8

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


def library_path(sources=SOURCES, defines=(), csrc=CSRC) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *sources, *defines)).encode())
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgfkernels_{h.hexdigest()[:16]}.so")


def build(sources=SOURCES, defines=(), csrc=CSRC) -> str:
    """Compile `sources` of `csrc` (with `-D` `defines`) unless this exact
    build exists already -> the library path. One nvcc per source, all
    started together, then one link. The compiler's register/shared-memory
    report is kept beside the library as `<lib>.log`. The defaults build
    the port's library; a profiling script may build variants."""
    so = library_path(sources, defines, csrc)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    objs = [f"{tmp}.{s}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, os.path.join(csrc, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for s, p, out in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{out[-8000:]}")
        r = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                            "-o", f"{tmp}.tmp", *objs], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr[-8000:]}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(so + ".log", "w") as f:
        f.write("".join(logs) + r.stdout + r.stderr)
    os.replace(f"{tmp}.tmp", so)
    return so


_P, _I = ctypes.c_void_p, ctypes.c_int
_LLP, _IP = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# each entry point's arguments (all return a CUDA error code)
_ARGTYPES = {
    "gf_probe": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                 _P, _P, _P],
    "gf_probe_single": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P],
    "gf_probe_split": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                       _P],
    "gf_vote": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "gf_vote_wide": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                     _P, _P],
    "gf_vote_shards": [_I, _LLP, _LLP, _IP, _IP, _IP, _IP, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    "gf_vote_shards_wide": [_I, _LLP, _LLP, _IP, _IP, _IP, _IP, _I, _I, _I, _P, _I, _P, _P, _I,
                            _I, _P, _P],
    "gf_merge_top2": [_I, _LLP, _I, _I, _I, _I, _P, _P, _P],
    "gf_mask_segments": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "gf_shard_flags": [_I, _LLP, _LLP, _IP, _IP, _IP, _IP, _I, _P, _P, _I, _I, _I, _P, _P],
    "gf_mask_from_flags": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "gf_gather_tile_sums": [_P, _P, _I, _I, _I, _P, _P],
    "gf_edit_distance": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "gf_lanes_unpack": [_I, _LLP, _LLP, _LLP, _IP, _IP, _IP, _P],
    "gf_lane_exceptions": [_I, _LLP, _LLP, _LLP, _IP, _IP, _IP, _P, _I, _P],
    "gf_compact_tile": [],
    "gf_compact_count": [_P, _I, _P, _P, _P],
    "gf_compact_place": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _LLP, _LLP, _IP, _IP, _I, _P,
                         _P, _P],
    "gf_survivor_rows": [_I, _LLP, _LLP, _IP, _IP, _P, _I, _I, _I, _P, _P],
    "gf_merge_bytes": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "gf_merge_codes": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "gf_merge_rows": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P],
}


def load(path: str) -> ctypes.CDLL:
    """Load a built library and declare the entry points it has."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Raise unless `t` is a contiguous `ndim`-D `dtype` tensor on `device`:
    what a wrapper checks before it hands a pointer to a kernel."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def probe_name(index) -> str:
    """The counter of a probe launch on `index`'s table."""
    if not index.single_probe:
        return "probe"
    return "probe_kvs" if index.S == 4 else "probe_kv16"


def launch_probe(codes, lengths, kmers, valid, n, W, stride, NQ, index, out,
                 row_loads=None, lib=None, sector_loads=None, vals_loads=None) -> None:
    """`row_loads`: None, or a one-element int64 tensor on the card that the
    launch adds its table row loads to (split tables: key rows);
    `sector_loads` (single-probe tables only) likewise for the 32-byte
    sectors it requests, `vals_loads` (split tables only) for the vals
    elements it reads. `lib`: a variant build of probe.cu (a launch-shape
    sweep), else the port's library. Kv tables take gf_probe, split tables
    gf_probe_split, single-probe tables gf_probe_single."""
    if index.table.data_ptr() % 16 or (codes is not None and codes.data_ptr() % 16):
        raise ValueError("probe: table rows and code rows must be 16-byte aligned")
    if (index.single_probe or index.split) and index.table.data_ptr() % 32:
        raise ValueError("probe: single-probe rows and split key rows must start on a "
                         "32-byte sector")
    if index.split and index.vals.data_ptr() % 8:
        raise ValueError("probe: split vals must be 8-byte aligned")
    if sector_loads is not None and not index.single_probe:
        raise ValueError("probe: only the single-probe variant counts its sectors")
    if vals_loads is not None and not index.split:
        raise ValueError("probe: only the split kernel counts its vals elements")
    if n >= 1 << 31:
        raise ValueError(f"probe: {n} queries exceed the kernel's 2^31")
    dev = out.device
    lib = lib or library()
    with torch.cuda.device(dev):
        if index.split:
            err = lib.gf_probe_split(
                _ptr(codes), _ptr(lengths), _ptr(kmers), _ptr(valid), n, W, stride, NQ,
                index.table.data_ptr(), index.vals.data_ptr(), index.shift, out.data_ptr(),
                _ptr(row_loads), _ptr(vals_loads), _stream(out),
            )
        elif index.single_probe:
            err = lib.gf_probe_single(
                _ptr(codes), _ptr(lengths), _ptr(kmers), _ptr(valid), n, W, stride, NQ,
                index.table.data_ptr(), index.S, index.shift, index.cbits, index.pos_bias,
                index.empty_key, out.data_ptr(), _ptr(row_loads), _ptr(sector_loads),
                _stream(out),
            )
        else:
            err = lib.gf_probe(
                _ptr(codes), _ptr(lengths), _ptr(kmers), _ptr(valid), n, W, stride, NQ,
                index.table.data_ptr(), None, 0, index.S, index.shift, index.cbits,
                index.pos_bias, out.data_ptr(), _ptr(row_loads), _stream(out),
            )
    _done(probe_name(index), err)


def probe_split_shape(lib=None) -> tuple:
    """(queries a thread, threads a block) of the split kernel in `lib` (a
    variant build of probe.cu), else in the port's library."""
    q, t = ctypes.c_int(), ctypes.c_int()
    (lib or library()).gf_probe_split_shape(ctypes.byref(q), ctypes.byref(t))
    return q.value, t.value


def launch_vote(pr, B, NS, index, step, major_req, minor_req, P2, out, counts=False,
                wide=None, lengths=None, stats=None) -> None:
    """`counts`: write (B, 6) [c1, h1, l1, c2, h2, l2] rows, no gate (the
    kernel's counts mode, kept in its entry point; the port's counts vote
    is `launch_vote_shards`'s). `wide`: None, or the wide path's (3 + 3B)
    int64 list, its first three entries zero, that the rows past the warp
    path go to for `launch_vote_wide` (their keys would not fit in the
    block path's shared memory). `lengths`: None, or the rows' (B,) int32
    lengths: a row's samples past its length are skipped. `stats`: None,
    or the vote's (VOTE_STAT_SLOTS,) int64 row counter (map_read.vote); a
    library built before the counter reads it as its stream, so None there
    launches on the default stream."""
    dstride, D = _dupe_args(index)
    with torch.cuda.device(out.device):
        err = library().gf_vote(
            pr.data_ptr(), B, NS, _ptr(lengths), index.dupes.data_ptr(), dstride, D,
            int(index.split), index.cbits, index.pos_bias, step,
            major_req, minor_req, P2, int(counts), _ptr(wide), out.data_ptr(), _ptr(stats),
            _stream(out),
        )
    _done("vote_counts" if counts else "vote", err)


def launch_vote_wide(pr, B, NS, index, step, major_req, minor_req, wide, lengths, keys_cap,
                     out, scratch=None, counts=False) -> None:
    """The rows `launch_vote` listed in `wide`, a 1,024-thread block a row.
    Without `scratch`, the first pass: a row's keys in shared memory, a row
    of more than `keys_cap` listed again with its keys counted into
    wide[1]. With `scratch` (wide[1] int64), the second pass over those
    rows; it counts as "vote_wide_global" / "vote_counts_wide_global".
    `counts` as `launch_vote`'s."""
    dstride, D = _dupe_args(index)
    with torch.cuda.device(out.device):
        err = library().gf_vote_wide(
            pr.data_ptr(), B, NS, _ptr(lengths), index.dupes.data_ptr(), dstride, D,
            int(index.split), index.cbits, index.pos_bias, step, major_req, minor_req,
            int(counts), wide.data_ptr(), _ptr(scratch), keys_cap, int(scratch is not None),
            out.data_ptr(), _stream(out),
        )
    name = "vote_counts_wide" if counts else "vote_wide"
    _done(name if scratch is None else f"{name}_global", err)


def _shard_table(prs, indexes):
    """The by-value shard table of a launch over several shards (at most
    8): (n, their results' pointers, their dupe tables' pointers, dupe row
    strides, widths D, cbits, pos_biases, split); one table layout."""
    n = len(prs)
    ll, ii = ctypes.c_longlong * n, ctypes.c_int * n
    dupe = [_dupe_args(ix) for ix in indexes]
    return (n, ll(*(p.data_ptr() for p in prs)), ll(*(ix.dupes.data_ptr() for ix in indexes)),
            ii(*(d[0] for d in dupe)), ii(*(d[1] for d in dupe)),
            ii(*(ix.cbits for ix in indexes)), ii(*(ix.pos_bias for ix in indexes)),
            int(indexes[0].split))


def launch_vote_shards(prs, indexes, B, NS, step, P2, out, wide=None, lengths=None) -> None:
    """The counts-mode vote of the shards' (B, NS, 2) results `prs` in one
    launch (MAX_SHARDS in csrc/vote.cu at most) into `out` (S, B, 6);
    counted as "vote_counts". P2: the largest `vote_width` of the shards;
    `wide`, `lengths` as `launch_vote`'s (a (3 + 3 S B) list)."""
    with torch.cuda.device(out.device):
        err = library().gf_vote_shards(*_shard_table(prs, indexes), B, NS, _ptr(lengths), step,
                                       P2, _ptr(wide), out.data_ptr(), _stream(out))
    _done("vote_counts", err)


def launch_vote_shards_wide(prs, indexes, B, NS, step, wide, lengths, keys_cap, out,
                            scratch=None) -> None:
    """The rows `launch_vote_shards` listed in `wide`, as
    `launch_vote_wide`'s passes: "vote_counts_wide", or with `scratch`
    "vote_counts_wide_global"."""
    with torch.cuda.device(out.device):
        err = library().gf_vote_shards_wide(
            *_shard_table(prs, indexes), B, NS, _ptr(lengths), step, wide.data_ptr(),
            _ptr(scratch), keys_cap, int(scratch is not None), out.data_ptr(), _stream(out))
    _done("vote_counts_wide" if scratch is None else "vote_counts_wide_global", err)


def launch_merge_top2(votes, step, major_req, minor_req, gp, ok) -> None:
    """`votes`: the shards' (B, 6) rows, at most MAX_SHARDS in csrc/vote.cu;
    their pointers go by value."""
    n = len(votes)
    with torch.cuda.device(gp.device):
        err = library().gf_merge_top2(
            n, (ctypes.c_longlong * n)(*(v.data_ptr() for v in votes)), gp.shape[0], step,
            major_req, minor_req, gp.data_ptr(), ok.data_ptr(), _stream(gp))
    _done("merge_top2", err)


def _mask_name(name: str, NK: int) -> str:
    """The counter of a launch of csrc/mask_segments.cu: code rows past
    65,535 bases count as "<name>_wide" (mask+segments and mask from flags
    take their wide launch there, MASK_MAX_L; the shard flags keep their
    kernel)."""
    return f"{name}_wide" if NK + 15 > 0xFFFF else name


def launch_mask_segments(pr, lengths, gp, B, NK, index, mismatch_thr, out,
                         scratch=None, smem_cap=0) -> None:
    """Code rows past 65,535 bases take the wide launch: `smem_cap`, the
    shared memory (bytes) a block may give a long row's words; `scratch`,
    None or the words of rows past it (map_read._mask_scratch)."""
    dstride, D = _dupe_args(index)
    with torch.cuda.device(out.device):
        err = library().gf_mask_segments(
            pr.data_ptr(), lengths.data_ptr(), gp.data_ptr(), B, NK,
            index.dupes.data_ptr(), dstride, D, int(index.split), index.cbits,
            index.pos_bias, mismatch_thr, smem_cap, _ptr(scratch), out.data_ptr(),
            _stream(out),
        )
    _done(_mask_name("mask_segments", NK), err)


def launch_shard_flags(prs, indexes, lengths, gp, NK, words, accumulate: bool) -> None:
    """One launch over the shards' stride-1 probe results `prs` (at most
    MAX_FLAG_SHARDS in csrc/mask_segments.cu, one table layout); their
    pointers and dupe parameters go by value. `accumulate`: OR into
    `words`, else store every word."""
    with torch.cuda.device(words.device):
        err = library().gf_shard_flags(
            *_shard_table(prs, indexes), lengths.data_ptr(), gp.data_ptr(), words.shape[0], NK,
            int(accumulate), words.data_ptr(), _stream(words),
        )
    _done(_mask_name("shard_flags", NK), err)


def launch_mask_from_flags(words, lengths, gp, B, NK, mismatch_thr, out, scratch=None,
                           smem_cap=0) -> None:
    """`smem_cap` and `scratch` as `launch_mask_segments`'."""
    with torch.cuda.device(out.device):
        err = library().gf_mask_from_flags(
            words.data_ptr(), lengths.data_ptr(), gp.data_ptr(), B, NK, mismatch_thr,
            smem_cap, _ptr(scratch), out.data_ptr(), _stream(out),
        )
    _done(_mask_name("mask_from_flags", NK), err)


def launch_gather_tile_sums(idx, tbl, lanes: int, out, lib=None) -> None:
    """`lib`: a variant build of gather_sum.cu (a launch-shape sweep), else
    the port's library."""
    if tbl.data_ptr() % 16:
        raise ValueError("gather_tile_sums: table rows must be 16-byte aligned")
    with torch.cuda.device(out.device):
        err = (lib or library()).gf_gather_tile_sums(
            idx.data_ptr(), tbl.data_ptr(), out.shape[0], tbl.shape[1], lanes,
            out.data_ptr(), _stream(out),
        )
    _done("gather_sum", err)


def launch_edit_distance(pat, pat_lens, txt, txt_lens, W: int, out) -> None:
    B, Lp = pat.shape
    with torch.cuda.device(out.device):
        err = library().gf_edit_distance(
            pat.data_ptr(), pat_lens.data_ptr(), txt.data_ptr(), txt_lens.data_ptr(),
            B, Lp, txt.shape[1], W, out.data_ptr(), _stream(out),
        )
    _done("edit_distance", err)


def _lane_table(bufs, widths, offs, outs):
    """The by-value lane table of an unpack or exception launch: at most
    MAX_LANES (P_i, ceil(W_i / 4)) 2-bit lanes, their (P_i, W_i) code
    outputs and their first rows `offs` in the concatenated row space."""
    n = len(bufs)
    ll, ii = ctypes.c_longlong * n, ctypes.c_int * n
    return (n, ll(*(b.data_ptr() for b in bufs)), ll(*(o.data_ptr() for o in outs)), ll(*offs),
            ii(*(b.shape[0] for b in bufs)), ii(*widths), ii(*(b.shape[1] for b in bufs)))


def launch_lanes_unpack(bufs, widths, offs, outs, lib=None) -> None:
    with torch.cuda.device(outs[0].device):
        err = (lib or library()).gf_lanes_unpack(*_lane_table(bufs, widths, offs, outs),
                                                 _stream(outs[0]))
    _done("lane_unpack", err)


def launch_lane_exceptions(bufs, widths, offs, outs, exc, lib=None) -> None:
    with torch.cuda.device(outs[0].device):
        err = (lib or library()).gf_lane_exceptions(*_lane_table(bufs, widths, offs, outs),
                                                    exc.data_ptr(), exc.shape[0],
                                                    _stream(outs[0]))
    _done("lane_exceptions", err)


def compact_tile(lib=None) -> int:
    """Rows of a compaction tile in a build (GLUE_COMPACT_TILE)."""
    return (lib or library()).gf_compact_tile()


def launch_compact_count(v, okwords, tile_cnt, lib=None) -> None:
    with torch.cuda.device(v.device):
        err = (lib or library()).gf_compact_count(v.data_ptr(), v.shape[0], okwords.data_ptr(),
                                                  tile_cnt.data_ptr(), _stream(v))
    _done("compact_count", err)


def launch_compact_place(v, lens, cap: int, okwords, tile_cnt, out, slens, gp, lanes=(),
                         offs=(), codes=None, lib=None, stats=None) -> None:
    """`lanes`: at most MAX_LANES (P_i, W_i) uint8 code tensors, their rows
    at `offs` in the concatenated row space (the table goes by value);
    the rows they hold are copied into `codes` (c, Wmax) as they are
    placed. `stats`: None, or the vote's row counter, summed into
    out[cap, 1:3] (a `lib` from before the counter as `launch_vote`'s)."""
    n = len(lanes)
    ll, ii = ctypes.c_longlong * n, ctypes.c_int * n
    with torch.cuda.device(out.device):
        err = (lib or library()).gf_compact_place(
            v.data_ptr(), lens.data_ptr(), v.shape[0], cap, okwords.data_ptr(),
            tile_cnt.data_ptr(), out.data_ptr(), slens.data_ptr(), gp.data_ptr(), n,
            ll(*(t.data_ptr() for t in lanes)), ll(*offs), ii(*(t.shape[0] for t in lanes)),
            ii(*(t.shape[1] for t in lanes)), 0 if codes is None else codes.shape[1],
            _ptr(codes), _ptr(stats), _stream(out))
    _done("compact_place", err)


def launch_survivor_rows(lanes, offs, sidx, out) -> None:
    """`lanes`: at most MAX_LANES (P_i, W_i) uint8 code tensors, their rows
    at `offs` in the concatenated row space; the table goes by value."""
    n = len(lanes)
    ll, ii = ctypes.c_longlong * n, ctypes.c_int * n
    with torch.cuda.device(out.device):
        err = library().gf_survivor_rows(
            n, ll(*(t.data_ptr() for t in lanes)), ll(*offs), ii(*(t.shape[0] for t in lanes)),
            ii(*(t.shape[1] for t in lanes)), sidx.data_ptr(), sidx.stride(0), out.shape[0],
            out.shape[1], out.data_ptr(), _stream(out))
    _done("survivor_rows", err)


def launch_merge_bytes(b1, q1, l1, b2, q2, l2, merged, ints, out) -> None:
    """`ints` (3, B) int32 [olen, diff, out_len]; `out` (2, B, 2L) uint8
    [merged bytes, qualities]."""
    B, L = b1.shape
    with torch.cuda.device(out.device):
        err = library().gf_merge_bytes(b1.data_ptr(), q1.data_ptr(), l1.data_ptr(),
                                       b2.data_ptr(), q2.data_ptr(), l2.data_ptr(), B, L,
                                       merged.data_ptr(), ints.data_ptr(), out.data_ptr(),
                                       _stream(out))
    _done("merge_bytes", err)


def launch_merge_codes(buf, lens2, L: int, msum, m_codes, maps=None, lens3=None) -> None:
    """`maps`: None, or the (m, R1, R2) map-code lanes, written with their
    (3, B) lengths `lens3`."""
    m_map, r1_map, r2_map = maps if maps is not None else (None, None, None)
    with torch.cuda.device(msum.device):
        err = library().gf_merge_codes(buf.data_ptr(), lens2.data_ptr(), buf.shape[0], L,
                                       msum.data_ptr(), m_codes.data_ptr(), _ptr(m_map),
                                       _ptr(r1_map), _ptr(r2_map), _ptr(lens3), _stream(msum))
    _done("merge_codes", err)


def launch_merge_rows(m_codes, buf, L: int, idx, lane, out) -> None:
    """`idx` and `lane` (or None) int32 views with any stride; rows of
    `m_codes` and `buf` (either may be None) at `idx`."""
    nrows = (m_codes if m_codes is not None else buf).shape[0]
    with torch.cuda.device(out.device):
        err = library().gf_merge_rows(
            _ptr(m_codes), 0 if m_codes is None else m_codes.shape[1], _ptr(buf), L, nrows,
            idx.data_ptr(), idx.stride(0), _ptr(lane), 1 if lane is None else lane.stride(0),
            out.shape[0], out.shape[1], out.data_ptr(), _stream(out))
    _done("merge_rows", err)
