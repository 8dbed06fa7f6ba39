// The glue of the per-batch scan: lane unpack, survivor compaction with
// the vote bitmap, and the survivors' code rows.
//
// Replaces the XLA-jitted glue of genefuserust_tpu/ops/fused.py
// fused_scan_lanes around its two passes (on the TPU this was jnp; the
// TPU's only Pallas kernel is the probe, probe.cu):
//   lane_unpack_kernel    :488-493 with ops/pack.py unpack_seq2_jnp: a
//                         lane's 2-bit rows -> uint8 codes, 255 at its
//                         exception entries;
//   compact_kernel        :509-518 and :555-567: the stable survivor
//                         compaction (the argsort of where(ok, i, N + i)),
//                         the survivors' lengths and vote keys, the count
//                         and the okwords bitmap;
//   survivor_rows_kernel  :523-532: the survivors' code rows, taken from
//                         the unpacked lanes and padded with 255 to the
//                         widest lane.
//
// What bounds them on the H100: bytes, and at the main path's sizes the
// launches and, for the one-block compaction, its chain of dependent
// steps. A 65,536-pair batch (~80,000 lane rows) unpacks ~3.6 MB of 2-bit
// rows into ~14 MB of codes, reads ~1.6 MB of vote rows and writes ~0.3 MB
// of survivor rows: ~6 us at 3.35 TB/s. The plain torch glue wrote the
// whole (N, Wmax) matrix of every row to take ~1,024 rows from it, and
// sorted N keys to compact them.
//
// What the designs do about it:
//   - the unpack writes each output byte once, 16 bytes a thread, over a
//     flat view of the (P, W) codes, so that no row width needs to be a
//     multiple of 16. Each block owns a contiguous range of the flat
//     output; after a barrier over its range it applies the lane's
//     exception entries that fall inside it (every block reads the (E, 2)
//     list, from L2, E ~ 10^4 a batch), so one launch a lane does both;
//   - the compaction is one block of 32 warps that walks the rows in steps
//     of 8,192: a warp ballots 8 words of 32 consecutive rows (the words
//     are the bitmap, written as they are), the block scans the warps'
//     popcounts, and a survivor's slot is the running count before its
//     bit. Non-survivors are wanted only when fewer than c = min(cap, N)
//     rows survive, and then only the first c - S of them, which all lie
//     in rows [0, c): a second walk over those rows places them. No sort,
//     no atomics, so the order is fixed;
//   - the survivor rows are copied straight from the lanes (a table of
//     their pointers, offsets, rows and widths passed by value), 16 bytes
//     a thread where both rows allow it, 255 past a lane's width.
// tests/test_torch_fused_glue.py mirrors these steps (_kernel_lane_unpack,
// _kernel_compact, _kernel_survivor_rows) and holds them to JAX.
#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int UNPACK_THREADS = 512;
constexpr int UNPACK_MAX_BLOCKS = 264;  // 2 an SM: each block reads the whole exception list
constexpr int COMPACT_THREADS = 1024;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
static_assert(COMPACT_WARPS == 32, "compact_walk scans the warps' counts one a lane");
constexpr int COMPACT_WORDS = 8;  // 32-row words a warp ballots in a step
constexpr int COMPACT_STEP = COMPACT_WARPS * COMPACT_WORDS * 32;
constexpr int OUT_COLS = 13;  // fused_scan_lanes' result rows
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_MAX_BLOCKS = 132 * 16;
constexpr int MAX_LANES = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr uint8_t INVALID_CODE = 255;

// One lane: (P, Wb) 2-bit rows (LSB first) -> (P, W) codes, a flat chunk
// of 16 output bytes a thread; then the entries of exc (E, 2) [row, col]
// in the concatenated row space whose row is in [off, off + P) and whose
// column, a negative one taken from the row's end (W + col), is in [0, W)
// are set to 255.
__global__ void __launch_bounds__(UNPACK_THREADS)
lane_unpack_kernel(const uint8_t* __restrict__ buf, int P, int W, int Wb,
                   const int2* __restrict__ exc, int E, long long off,
                   uint8_t* __restrict__ out) {
  const long long total = (long long)P * W;
  const long long chunks = (total + 15) / 16;
  const long long per_block = (chunks + gridDim.x - 1) / gridDim.x;
  const long long c0 = (long long)blockIdx.x * per_block;
  const long long c1 = min(chunks, c0 + per_block);
  for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const long long j = 16 * c;
    const long long row = j / W;
    int col = (int)(j - row * W);
    const uint8_t* src = buf + row * Wb;
    uint32_t pb = (uint32_t)__ldg(src + (col >> 2)) >> (2 * (col & 3));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const int n = (int)min(16LL, total - j);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < n) {
        w[k >> 2] |= (pb & 3u) << (8 * (k & 3));
        pb >>= 2;
        if (++col == W) {
          col = 0;
          src += Wb;
          if (k + 1 < n) pb = __ldg(src);
        } else if ((col & 3) == 0 && k + 1 < n) {
          pb = __ldg(src + (col >> 2));
        }
      }
    }
    if (n == 16) {
      *reinterpret_cast<uint4*>(out + j) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < n) out[j + k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
    }
  }
  // the block's bytes are written: its exceptions land after them
  __syncthreads();
  const long long lo = 16 * c0, hi = min(total, 16 * c1);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int2 x = __ldg(exc + e);
    const long long r = (long long)x.x - off;
    const long long col = x.y < 0 ? (long long)x.y + W : (long long)x.y;
    if (r < 0 || r >= P || col < 0 || col >= W) continue;
    const long long at = r * W + col;
    if (at >= lo && at < hi) out[at] = INVALID_CODE;
  }
}

// Rows [0, limit) whose gate bit equals `want`, in row order, go to slots
// first + (their rank among such rows) while the slot is below c. Writes
// the bitmap words when `words` is set. -> the number of such rows (the
// same in every thread).
__device__ __forceinline__ int compact_walk(const int32_t* __restrict__ v,
                                            const int32_t* __restrict__ lens, int limit,
                                            bool want, int first, int c,
                                            int32_t* __restrict__ out,
                                            int32_t* __restrict__ slens,
                                            int32_t* __restrict__ gp,
                                            int32_t* __restrict__ words, int nw,
                                            int* warp_sum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int carry = 0;
  for (int base = 0; base < limit; base += COMPACT_STEP) {
    const int r0 = base + warp * COMPACT_WORDS * 32;
    bool take[COMPACT_WORDS];
    unsigned m[COMPACT_WORDS];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < COMPACT_WORDS; ++k) {
      const int i = r0 + 32 * k + lane;
      take[k] = i < limit && ((__ldg(v + 5LL * i) != 0) == want);
    }
#pragma unroll
    for (int k = 0; k < COMPACT_WORDS; ++k) {
      m[k] = __ballot_sync(FULL_MASK, take[k]);
      cnt += __popc(m[k]);
      if (words != nullptr && lane == k && (r0 >> 5) + k < nw)
        words[(r0 >> 5) + k] = (int32_t)m[k];
    }
    if (lane == 0) warp_sum[warp] = cnt;
    __syncthreads();
    int s = warp_sum[lane];  // COMPACT_WARPS == 32: one a lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += t;
    }
    const int step_total = __shfl_sync(FULL_MASK, s, 31);
    int at = first + carry + __shfl_sync(FULL_MASK, s, warp) - cnt;
    __syncthreads();  // warp_sum is rewritten by the next step
#pragma unroll
    for (int k = 0; k < COMPACT_WORDS; ++k) {
      const int slot = at + __popc(m[k] & below);
      if (take[k] && slot < c) {
        const int i = r0 + 32 * k + lane;
        out[(long long)slot * OUT_COLS] = i;
        out[(long long)slot * OUT_COLS + 1] = want;
        slens[slot] = want ? __ldg(lens + i) : 0;
        const int32_t* vr = v + 5LL * i;
        int4 g = make_int4(__ldg(vr + 1), __ldg(vr + 2), __ldg(vr + 3), __ldg(vr + 4));
        *reinterpret_cast<int4*>(gp + 4LL * slot) = g;
      }
      at += __popc(m[k]);
    }
    carry += step_total;
  }
  return carry;
}

// v (N, 5) [ok, h1, l1, h2, l2], lens (N,) -> out (cap + 1, 13): [sidx,
// svalid] of rows [0, c), the survivor count at [cap, 0], zeros elsewhere;
// slens (c,), gp (c, 4) and okwords (ceil(N / 32),).
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ lens, int N,
               int cap, int32_t* __restrict__ out, int32_t* __restrict__ slens,
               int32_t* __restrict__ gp, int32_t* __restrict__ okwords) {
  __shared__ int warp_sum[COMPACT_WARPS];
  const int c = min(cap, N);
  // the zeros: every cell the walks and the count do not write
  const int cells = (cap + 1) * OUT_COLS;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) {
    const int r = e / OUT_COLS, col = e - r * OUT_COLS;
    if (!((r < c && col < 2) || (r == cap && col == 0))) out[e] = 0;
  }
  const int S = compact_walk(v, lens, N, true, 0, c, out, slens, gp, okwords, (N + 31) / 32,
                             warp_sum);
  if (threadIdx.x == 0) out[(long long)cap * OUT_COLS] = S;
  // the first c - S non-survivors, all in rows [0, c)
  if (S < c) compact_walk(v, lens, c, false, S, c, out, slens, gp, nullptr, 0, warp_sum);
}

struct Lanes {
  const uint8_t* ptr[MAX_LANES];
  long long off[MAX_LANES];
  int rows[MAX_LANES];
  int width[MAX_LANES];
  int n;
};

__device__ __forceinline__ uint8_t code_at(const uint8_t* src, int j, int Wi) {
  return j < Wi ? __ldg(src + j) : INVALID_CODE;
}

// out (c, Wmax): row r is the code row sidx[r * sstride] of the lane that
// holds it, 255 past the lane's width. A row whose index no lane of this
// launch holds is left to another launch (more than MAX_LANES lanes).
__global__ void __launch_bounds__(ROWS_THREADS)
survivor_rows_kernel(Lanes lanes, const int32_t* __restrict__ sidx, int sstride, int c,
                     int Wmax, uint8_t* __restrict__ out) {
  const int cw = (Wmax + 15) / 16;
  const long long total = (long long)c * cw;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(t / cw);
    const int j = 16 * (int)(t - (long long)r * cw);
    const long long s = __ldg(sidx + (long long)r * sstride);
    const uint8_t* base = nullptr;
    long long loc = 0;
    int Wi = 0;
#pragma unroll
    for (int q = 0; q < MAX_LANES; ++q) {
      if (q < lanes.n && s >= lanes.off[q] && s < lanes.off[q] + lanes.rows[q]) {
        base = lanes.ptr[q];
        loc = s - lanes.off[q];
        Wi = lanes.width[q];
      }
    }
    if (base == nullptr) continue;
    const uint8_t* src = base + loc * Wi;
    uint8_t* dst = out + (long long)r * Wmax + j;
    const int n = min(16, Wmax - j);
    if (n == 16 && ((uintptr_t)dst & 15) == 0) {
      uint4 val;
      if (j + 16 <= Wi && ((uintptr_t)(src + j) & 15) == 0) {
        val = __ldg(reinterpret_cast<const uint4*>(src + j));
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[q] = (uint32_t)code_at(src, j + 4 * q, Wi) |
                 (uint32_t)code_at(src, j + 4 * q + 1, Wi) << 8 |
                 (uint32_t)code_at(src, j + 4 * q + 2, Wi) << 16 |
                 (uint32_t)code_at(src, j + 4 * q + 3, Wi) << 24;
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      for (int q = 0; q < n; ++q) dst[q] = code_at(src, j + q, Wi);
    }
  }
}

}  // namespace gf

extern "C" int gf_lane_unpack(const void* buf, int P, int W, int Wb, const void* exc, int E,
                              long long off, void* out, void* stream) {
  if (P < 0 || W < 1 || Wb < 1 || 4LL * Wb < W || E < 0 || (uintptr_t)out % 16 ||
      (uintptr_t)exc % 8)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)P * W + 15) / 16;
  if (chunks == 0) return (int)cudaSuccess;
  const long long blocks = (chunks + gf::UNPACK_THREADS - 1) / gf::UNPACK_THREADS;
  const int grid = (int)(blocks < gf::UNPACK_MAX_BLOCKS ? blocks : gf::UNPACK_MAX_BLOCKS);
  gf::lane_unpack_kernel<<<grid, gf::UNPACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, P, W, Wb, (const int2*)exc, E, off, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int gf_compact(const void* v, const void* lens, int N, int cap, void* out,
                          void* slens, void* gp, void* okwords, void* stream) {
  if (N < 0 || cap < 0 || (long long)(cap + 1LL) * gf::OUT_COLS >= (1LL << 31) ||
      (uintptr_t)gp % 16)
    return (int)cudaErrorInvalidValue;
  gf::compact_kernel<<<1, gf::COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, (const int32_t*)lens, N, cap, (int32_t*)out, (int32_t*)slens,
      (int32_t*)gp, (int32_t*)okwords);
  return (int)cudaGetLastError();
}

// ptrs, offs, rows, widths: host arrays of nlanes (1..MAX_LANES) entries,
// passed to the kernel by value.
extern "C" int gf_survivor_rows(int nlanes, const long long* ptrs, const long long* offs,
                                const int* rows, const int* widths, const void* sidx,
                                int sstride, int c, int Wmax, void* out, void* stream) {
  if (nlanes < 1 || nlanes > gf::MAX_LANES || c < 0 || Wmax < 1 || sstride < 1)
    return (int)cudaErrorInvalidValue;
  gf::Lanes lanes{};
  for (int q = 0; q < nlanes; ++q) {
    if (rows[q] < 0 || widths[q] < 1 || widths[q] > Wmax) return (int)cudaErrorInvalidValue;
    lanes.ptr[q] = (const uint8_t*)ptrs[q];
    lanes.off[q] = offs[q];
    lanes.rows[q] = rows[q];
    lanes.width[q] = widths[q];
  }
  lanes.n = nlanes;
  const long long total = (long long)c * ((Wmax + 15) / 16);
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + gf::ROWS_THREADS - 1) / gf::ROWS_THREADS;
  const int grid = (int)(blocks < gf::ROWS_MAX_BLOCKS ? blocks : gf::ROWS_MAX_BLOCKS);
  gf::survivor_rows_kernel<<<grid, gf::ROWS_THREADS, 0, (cudaStream_t)stream>>>(
      lanes, (const int32_t*)sidx, sstride, c, Wmax, (uint8_t*)out);
  return (int)cudaGetLastError();
}
