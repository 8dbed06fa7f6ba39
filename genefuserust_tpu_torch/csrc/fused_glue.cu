// The glue of the per-batch scan: lane unpack, survivor compaction with
// the vote bitmap, and the survivors' code rows.
//
// Replaces the XLA-jitted glue of genefuserust_tpu/ops/fused.py
// fused_scan_lanes around its two passes (on the TPU this was jnp; the
// TPU's only Pallas kernel is the probe, probe.cu):
//   lanes_unpack_kernel     :488-493 with ops/pack.py unpack_seq2_jnp:
//                           every lane's 2-bit rows -> uint8 codes;
//   lane_exceptions_kernel  :493, the scatter: 255 at each exception entry
//                           that falls in a lane;
//   compact_count_kernel    :560-567 and the count of :509-518: the
//                           okwords bitmap and each tile's survivor count;
//   compact_place_kernel    :509-518, :523-532 and :555-558: the stable
//                           survivor compaction (the argsort of where(ok, i,
//                           N + i)), the survivors' lengths and vote keys,
//                           the count, and the placed rows' code rows, taken
//                           from the unpacked lanes and padded with 255 to
//                           the widest lane;
//   survivor_rows_kernel    :523-532 for the rows of lanes past the place
//                           launch's MAX_LANES (a batch of more lanes).
//
// What bounds them on the H100: bytes, and at the main path's sizes the
// latency of a launch. A 65,536-pair batch (~80,000 lane rows) unpacks
// ~3.6 MB of 2-bit rows into ~14 MB of codes, reads ~1.6 MB of vote rows
// and writes ~0.3 MB of survivor rows: ~6 us at 3.35 TB/s. So each step
// is one launch a batch (or two short ones) spread over the whole card,
// with no chain of dependent steps inside a launch.
//
// What the designs do about it:
//   - the unpack is one launch for up to MAX_LANES lanes: a by-value table
//     of the lanes sends each 16-byte chunk of output to its lane, and each
//     lane's (P, W) codes lie at a 16-byte-aligned offset of one buffer.
//     Where W % 16 == 0 (the engine's widths) a chunk lies inside one row
//     and its 4 packed bytes are one aligned 32-bit load, spread in
//     registers into one 16-byte store; other widths step a chunk's bytes
//     through the rows;
//   - the exceptions follow in a second launch, a thread an entry: it
//     finds the lane that holds its row, drops it as JAX does (rows outside
//     every lane, columns outside [-W, W), a negative one counted from the
//     row's end) or writes 255. The write is idempotent, so unsorted,
//     repeated and pad entries need nothing, and stream order puts it
//     after the unpack;
//   - the compaction is two launches over tiles of COMPACT_TILE rows, a
//     block a tile. The count launch ballots the gate column 32 rows a
//     word (the words are the bitmap, written as they are) and writes the
//     tile's survivor count. The place launch re-reads its tile's words,
//     sums the earlier tiles' counts (its prefix) and all of them (S), and
//     gives row i the slot pre(i), the survivors in rows before it, if it
//     survives, else S + i - pre(i), its rank among the non-survivors after
//     the S survivors. A row is written where its slot is below
//     c = min(cap, N), so the non-survivors that fill rows [S, c) are
//     placed in the same pass, whatever tiles c spans. The blocks share out
//     the zeros of `out`. No atomics and no look-back, so the order is fixed
//     by the data; the tile counts are scratch that the count launch writes
//     whole, so nothing needs a reset;
//   - the place launch also copies each placed row's codes, straight from
//     its lane (a table of up to MAX_LANES lanes' pointers, offsets, rows
//     and widths passed by value), in 16-byte chunks where both rows allow
//     it, 255 past a lane's width: the copy needs the slot and source row
//     that the launch has just computed, so it costs no launch of its own:
//     the slots are spread evenly over the launch's blocks, each block
//     finding its slots' rows;
//   - the rows of lanes past the first MAX_LANES take survivor_rows_kernel,
//     16 bytes a thread, a launch for each further MAX_LANES lanes.
// tests/test_torch_fused_glue.py mirrors these steps (_kernel_lanes_unpack,
// _kernel_compact, _kernel_survivor_rows) and holds them to JAX.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Rows a compaction tile (a multiple of 256 up to 8,192; a build may set
// another). 256, one word a warp, was the fastest of 256-8,192 at the
// main path's ~80,000 rows on the H100 (chip_smoke.py --glue-sweep): the
// more blocks, the shorter each one's chain. Each place block sums every
// tile's count, ~N / 256 ints from L2.
#ifndef GLUE_COMPACT_TILE
#define GLUE_COMPACT_TILE 256
#endif

namespace gf {

constexpr int UNPACK_THREADS = 256;
constexpr int UNPACK_MAX_BLOCKS = 132 * 16;
constexpr int EXC_THREADS = 256;
constexpr int COMPACT_THREADS = 256;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int COMPACT_TILE = GLUE_COMPACT_TILE;
constexpr int COMPACT_WPW = COMPACT_TILE / (32 * COMPACT_WARPS);  // bitmap words a warp
static_assert(COMPACT_TILE % (32 * COMPACT_WARPS) == 0 && COMPACT_WPW >= 1 && COMPACT_WPW <= 32,
              "a warp holds its tile's words one a lane");
constexpr int OUT_COLS = 13;  // fused_scan_lanes' result rows
constexpr int PLACE_CHUNKS = 4;     // a lane's 16-byte chunks of a row loaded before stored
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_MAX_BLOCKS = 132 * 16;
constexpr int MAX_LANES = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr uint8_t INVALID_CODE = 255;

// The lanes of one unpack (and exception) launch, by value: lane q's
// (rows, wb) 2-bit rows at in, its (rows, width) codes at out, its first
// row in the concatenated row space at off, its 16-byte output chunks
// from chunk0[q] to chunk0[q + 1] of the launch's, and whether a chunk is
// one aligned 32-bit load (fast).
struct GlueLanes {
  const uint8_t* in[MAX_LANES];
  uint8_t* out[MAX_LANES];
  long long off[MAX_LANES];
  long long chunk0[MAX_LANES + 1];
  int rows[MAX_LANES];
  int width[MAX_LANES];
  int wb[MAX_LANES];
  int fast[MAX_LANES];
  int n;
};

// the low 4 codes of a packed byte, one a byte (LSB first)
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b & 0x3u) | ((b & 0xcu) << 6) | ((b & 0x30u) << 12) | ((b & 0xc0u) << 18);
}

// Every lane's (P, W) codes, 16 output bytes a thread over the lanes'
// concatenated chunks. The lane is selected with constant indexes (an
// unrolled scan of the table), so the table stays in the parameter bank.
__global__ void __launch_bounds__(UNPACK_THREADS)
lanes_unpack_kernel(GlueLanes lanes) {
  const long long chunks = lanes.chunk0[lanes.n];
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks;
       c += (long long)gridDim.x * blockDim.x) {
    const uint8_t* buf = lanes.in[0];
    uint8_t* out = lanes.out[0];
    long long first = 0;
    int P = lanes.rows[0], W = lanes.width[0], Wb = lanes.wb[0], fast = lanes.fast[0];
#pragma unroll
    for (int q = 1; q < MAX_LANES; ++q) {
      if (q < lanes.n && c >= lanes.chunk0[q]) {
        buf = lanes.in[q];
        out = lanes.out[q];
        first = lanes.chunk0[q];
        P = lanes.rows[q];
        W = lanes.width[q];
        Wb = lanes.wb[q];
        fast = lanes.fast[q];
      }
    }
    const long long j = 16 * (c - first);
    const long long row = j / W;
    int col = (int)(j - row * W);
    const uint8_t* src = buf + row * Wb;
    if (fast) {
      // W % 16 == 0: the chunk is 16 codes of one row, 4 aligned bytes
      const uint32_t p = __ldg(reinterpret_cast<const uint32_t*>(src + (col >> 2)));
      *reinterpret_cast<uint4*>(out + j) =
          make_uint4(spread4(p & 0xffu), spread4((p >> 8) & 0xffu),
                     spread4((p >> 16) & 0xffu), spread4(p >> 24));
      continue;
    }
    const long long total = (long long)P * W;
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
}

// exc (E, 2) [row, col]: an entry whose row lies in a lane ([off, off +
// P)) and whose column, a negative one taken from the row's end (W + col),
// lies in [0, W) sets that code to 255; every other entry is dropped.
__global__ void __launch_bounds__(EXC_THREADS)
lane_exceptions_kernel(GlueLanes lanes, const int2* __restrict__ exc, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int2 x = __ldg(exc + e);
#pragma unroll
  for (int q = 0; q < MAX_LANES; ++q) {
    if (q < lanes.n) {
      const long long r = (long long)x.x - lanes.off[q];
      const int W = lanes.width[q];
      const long long col = x.y < 0 ? (long long)x.y + W : (long long)x.y;
      if (r >= 0 && r < lanes.rows[q] && col >= 0 && col < W)
        lanes.out[q][r * W + col] = INVALID_CODE;
    }
  }
}

// Tile b: rows [b * COMPACT_TILE, ...) of v (N, 5) [ok, h1, l1, h2, l2].
// Warp w ballots its COMPACT_WPW words of 32 rows -> okwords (bit k of word
// i = row 32i + k) and tile_cnt[b], the tile's survivors.
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_count_kernel(const int32_t* __restrict__ v, int N, int32_t* __restrict__ okwords,
                     int32_t* __restrict__ tile_cnt) {
  __shared__ int warp_cnt[COMPACT_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (N + 31) >> 5;
  const int w0 = blockIdx.x * (COMPACT_TILE / 32) + warp * COMPACT_WPW;
  bool ok[COMPACT_WPW];
#pragma unroll
  for (int k = 0; k < COMPACT_WPW; ++k) {
    const int i = 32 * (w0 + k) + lane;
    ok[k] = i < N && __ldg(v + 5LL * i) != 0;
  }
  unsigned mine = 0u;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < COMPACT_WPW; ++k) {
    const unsigned m = __ballot_sync(FULL_MASK, ok[k]);
    cnt += __popc(m);
    if (lane == k) mine = m;
  }
  if (lane < COMPACT_WPW && w0 + lane < nw) okwords[w0 + lane] = (int32_t)mine;
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < COMPACT_WARPS; ++w) t += warp_cnt[w];
    tile_cnt[blockIdx.x] = t;
  }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// The lanes whose code rows a launch copies, by value: lane q's (rows[q],
// width[q]) uint8 codes at ptr[q], its first row at off[q] of the
// concatenated row space.
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

// Code row s of the lane of `lanes` that holds it -> its first code and
// width, or false where no lane of the table holds it. The lanes are
// scanned with constant indexes, so the table stays in the parameter bank.
__device__ __forceinline__ bool lane_row(const Lanes& lanes, long long s, const uint8_t*& src,
                                         int& Wi) {
  bool found = false;
#pragma unroll
  for (int q = 0; q < MAX_LANES; ++q) {
    if (q < lanes.n && s >= lanes.off[q] && s < lanes.off[q] + lanes.rows[q]) {
      src = lanes.ptr[q] + (s - lanes.off[q]) * lanes.width[q];
      Wi = lanes.width[q];
      found = true;
    }
  }
  return found;
}

// Bytes [j, j + 16) of a code row of width Wi padded with 255: one aligned
// 16-byte load where the row allows it.
__device__ __forceinline__ uint4 row_chunk(const uint8_t* src, int j, int Wi) {
  if (j + 16 <= Wi && ((uintptr_t)(src + j) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src + j));
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (uint32_t)code_at(src, j + 4 * q, Wi) | (uint32_t)code_at(src, j + 4 * q + 1, Wi) << 8 |
           (uint32_t)code_at(src, j + 4 * q + 2, Wi) << 16 |
           (uint32_t)code_at(src, j + 4 * q + 3, Wi) << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The chunk into bytes [j, min(j + 16, Wmax)) of an output row.
__device__ __forceinline__ void put_chunk(uint8_t* dst, int j, int Wmax, uint4 val) {
  if (j + 16 <= Wmax && ((uintptr_t)(dst + j) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst + j) = val;
    return;
  }
  const uint32_t w[4] = {val.x, val.y, val.z, val.w};
  const int n = min(16, Wmax - j);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) dst[j + k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

// The position of the n-th (from 0) one bit of m, which has more than n.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int k = __popc(m & ((1u << w) - 1u));
    if (n >= k) {
      n -= k;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The place launch's slot table for slots [r0, r1), every thread of the
// block calling: copy_tile[s - r0] = the tile t of slot s, copy_rank[s -
// r0] = its rank among t's survivors (>= 0) or -1 - its rank among t's
// other rows. Tile t holds the survivor slots [cs, cs + n), cs the
// survivors of the tiles before it (a block scan of the tile counts, a
// chunk of COMPACT_THREADS tiles at a time), and the other slots [cn, cn +
// rows - n), cn = S + the other rows of the tiles before it.
__device__ __forceinline__ void slot_table(const int32_t* __restrict__ tile_cnt, int ntiles,
                                           int N, int S, int r0, int r1, int* copy_tile,
                                           int* copy_rank, int* warp_tot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += COMPACT_THREADS) {
    const int t = t0 + threadIdx.x;
    const int n = t < ntiles ? __ldg(tile_cnt + t) : 0;
    int inc = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int cs = carry + inc - n;
#pragma unroll
    for (int w = 0; w < COMPACT_WARPS; ++w) {
      cs += w < warp ? warp_tot[w] : 0;
      carry += warp_tot[w];
    }
    __syncthreads();
    if (t < ntiles) {
      const int nrows = min(COMPACT_TILE, N - t * COMPACT_TILE);
      const int cn = S + t * COMPACT_TILE - cs;
      for (int s = max(r0, cs); s < min(r1, cs + n); ++s) {
        copy_tile[s - r0] = t;
        copy_rank[s - r0] = s - cs;
      }
      for (int s = max(r0, cn); s < min(r1, cn + nrows - n); ++s) {
        copy_tile[s - r0] = t;
        copy_rank[s - r0] = -1 - (s - cn);
      }
    }
  }
  __syncthreads();
}

// The row of a slot from its table entry (tile t, rank rk), a half-warp a
// slot, every lane of the warp calling: the rank-th one bit of the tile's
// words (their complement for another row, rows past N masked) -> the
// row, or -1 where the half-warp has no slot (active false).
__device__ __forceinline__ int slot_row(const int32_t* __restrict__ okwords, int nw, int N,
                                        bool active, int t, int rk) {
  const int lane = threadIdx.x & 31, half = lane >> 4, t16 = lane & 15;
  const bool surv = rk >= 0;
  const int rank = surv ? rk : -1 - rk;
  int row = -1, acc = 0;
  for (int g = 0; g < COMPACT_TILE / 32; g += 16) {
    const int wi = t * (COMPACT_TILE / 32) + g + t16;
    unsigned m = 0u;
    if (active && g + t16 < COMPACT_TILE / 32 && wi < nw) {
      m = (unsigned)__ldg(okwords + wi);
      if (!surv) m = ~m;
      if (32 * (wi + 1) > N) m &= (1u << (N - 32 * wi)) - 1u;
    }
    const int pc = __popc(m);
    int inc = pc;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, inc, o, 16);
      if (t16 >= o) inc += y;
    }
    const bool here = row < 0 && acc + inc - pc <= rank && rank < acc + inc;
    const unsigned hit = (__ballot_sync(FULL_MASK, here) >> (16 * half)) & 0xffffu;
    const int at = hit ? __ffs(hit) - 1 : 0;
    const unsigned ms = __shfl_sync(FULL_MASK, m, at, 16);
    const int skip = __shfl_sync(FULL_MASK, acc + inc - pc, at, 16);  // ones before word at
    if (hit) row = 32 * (t * (COMPACT_TILE / 32) + g + at) + nth_bit(ms, rank - skip);
    acc += __shfl_sync(FULL_MASK, inc, 15, 16);
  }
  return row;
}

// The tiles of compact_count_kernel, after it: row i of tile b takes slot
// pre(i) if it survives, else S + i - pre(i), and is written where the
// slot is below c = min(cap, N): out[slot, 0:2] = [i, ok], slens[slot] =
// ok ? lens[i] : 0, gp[slot] = v[i, 1:5], and, where a lane of `lanes`
// holds row i, rows[slot] = its code row padded with 255 to Wmax.
// out[cap, 0] = S; with `stats` (the vote's VOTE_STAT_SLOTS slots)
// out[cap, 1:3] = the rows the vote's warp path voted on and the rows it
// sorted; every other cell of out (cap + 1, 13) is zero.
// The rows to copy are not spread like the tiles: the non-survivors that
// fill slots [S, c) are the first rows, in the first few tiles (~926 of
// the main path's 1,024 in 4 tiles of 315). So block b copies slots
// [b * per, (b + 1) * per), per = ceil(c / blocks): a block scan of the
// tile counts gives each slot its tile and its rank among the tile's
// survivors (or non-survivors), and a half-warp finds that rank's bit in
// the tile's words and copies the row, 16 lanes a row, PLACE_CHUNKS chunks
// a lane loaded before they are stored. Copying a row where it is placed
// (the placing thread, or the placing warp 16 lanes a row) left most of
// the copy to the first 4 blocks and was slower on the H100 (PERF.md).
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_place_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ lens, int N,
                     int cap, const int32_t* __restrict__ okwords,
                     const int32_t* __restrict__ tile_cnt, int ntiles, int32_t* __restrict__ out,
                     int32_t* __restrict__ slens, int32_t* __restrict__ gp, Lanes lanes,
                     int Wmax, uint8_t* __restrict__ rows,
                     const unsigned long long* __restrict__ stats) {
  __shared__ int sums[3][COMPACT_WARPS];  // earlier tiles, all tiles, this warp's words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = min(cap, N);
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const int n = __ldg(tile_cnt + t);
    all += n;
    if (t < (int)blockIdx.x) before += n;
  }
  const int nw = (N + 31) >> 5;
  const int w0 = blockIdx.x * (COMPACT_TILE / 32) + warp * COMPACT_WPW;
  const unsigned word =
      lane < COMPACT_WPW && w0 + lane < nw ? (unsigned)__ldg(okwords + w0 + lane) : 0u;
  before = warp_sum(before);
  all = warp_sum(all);
  const int mine = warp_sum(__popc(word));
  if (lane == 0) {
    sums[0][warp] = before;
    sums[1][warp] = all;
    sums[2][warp] = mine;
  }
  __syncthreads();
  int pre = 0, S = 0;
#pragma unroll
  for (int w = 0; w < COMPACT_WARPS; ++w) {
    pre += sums[0][w] + (w < warp ? sums[2][w] : 0);
    S += sums[1][w];
  }
  // the zeros: every cell that no row, not the count and not the counter writes
  const long long cells = (long long)(cap + 1) * OUT_COLS;
  const int count_cols = stats != nullptr ? 3 : 1;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < cells;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / OUT_COLS;
    const int col = (int)(e - r * OUT_COLS);
    if (!((r < c && col < 2) || (r == cap && col < count_cols))) out[e] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[(long long)cap * OUT_COLS] = S;
  if (stats != nullptr && blockIdx.x == 0 && warp == 0) {
    unsigned long long t = lane < VOTE_STAT_SLOTS ? stats[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL_MASK, t, o);
    if (lane == 0) {
      out[(long long)cap * OUT_COLS + 1] = (int32_t)(uint32_t)t;
      out[(long long)cap * OUT_COLS + 2] = (int32_t)(t >> 32);
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < COMPACT_WPW; ++k) {
    const unsigned m = __shfl_sync(FULL_MASK, word, k);
    const int i = 32 * (w0 + k) + lane;
    const int p = pre + __popc(m & below);
    const bool ok = (m >> lane) & 1u;
    const int slot = ok ? p : S + i - p;
    const bool placed = i < N && slot < c;
    if (placed) {
      out[(long long)slot * OUT_COLS] = i;
      out[(long long)slot * OUT_COLS + 1] = ok;
      slens[slot] = ok ? __ldg(lens + i) : 0;
      const int32_t* vr = v + 5LL * i;
      *reinterpret_cast<int4*>(gp + 4LL * slot) =
          make_int4(__ldg(vr + 1), __ldg(vr + 2), __ldg(vr + 3), __ldg(vr + 4));
    }
    pre += __popc(m);
  }
  // block b copies slots [b * per, (b + 1) * per), a half-warp a slot, 16
  // lanes a row, PLACE_CHUNKS chunks a lane loaded before they are stored
  if (lanes.n == 0 || c == 0) return;
  __shared__ int copy_tile[COMPACT_THREADS], copy_rank[COMPACT_THREADS], warp_tot[COMPACT_WARPS];
  const int per = (c + gridDim.x - 1) / gridDim.x;  // <= COMPACT_TILE: c <= N
  const int lo = min(c, (int)blockIdx.x * per), hi = min(c, lo + per);
  const int half = lane >> 4, t16 = lane & 15;
  const int cw = (Wmax + 15) >> 4;
  for (int r0 = lo; r0 < hi; r0 += COMPACT_THREADS) {
    const int r1 = min(hi, r0 + COMPACT_THREADS);
    slot_table(tile_cnt, ntiles, N, S, r0, r1, copy_tile, copy_rank, warp_tot);
    for (int j0 = r0; j0 < r1; j0 += 2 * COMPACT_WARPS) {
      const int j = j0 + 2 * warp + half;
      const bool active = j < r1;
      const int row = slot_row(okwords, nw, N, active, active ? copy_tile[j - r0] : 0,
                               active ? copy_rank[j - r0] : 0);
      const uint8_t* src = nullptr;
      int Wi = 0;
      if (row < 0 || !lane_row(lanes, row, src, Wi)) continue;
      uint8_t* dst = rows + (long long)j * Wmax;
      for (int q0 = t16; q0 < cw; q0 += 16 * PLACE_CHUNKS) {
        uint4 val[PLACE_CHUNKS];
#pragma unroll
        for (int q = 0; q < PLACE_CHUNKS; ++q)
          if (q0 + 16 * q < cw) val[q] = row_chunk(src, 16 * (q0 + 16 * q), Wi);
#pragma unroll
        for (int q = 0; q < PLACE_CHUNKS; ++q)
          if (q0 + 16 * q < cw) put_chunk(dst, 16 * (q0 + 16 * q), Wmax, val[q]);
      }
    }
    __syncthreads();
  }
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

namespace {

// ins, outs, offs: host arrays of nlanes (1..MAX_LANES) entries, rows,
// widths, wbs too -> the launch's lane table, or false on a bad table.
bool glue_lanes(int nlanes, const long long* ins, const long long* outs, const long long* offs,
                const int* rows, const int* widths, const int* wbs, gf::GlueLanes& lanes) {
  if (nlanes < 1 || nlanes > gf::MAX_LANES) return false;
  lanes = gf::GlueLanes{};
  long long chunks = 0;
  for (int q = 0; q < nlanes; ++q) {
    const int P = rows[q], W = widths[q], Wb = wbs[q];
    if (P < 0 || W < 1 || Wb < 1 || 4LL * Wb < W || outs[q] % 16) return false;
    lanes.in[q] = (const uint8_t*)ins[q];
    lanes.out[q] = (uint8_t*)outs[q];
    lanes.off[q] = offs[q];
    lanes.rows[q] = P;
    lanes.width[q] = W;
    lanes.wb[q] = Wb;
    lanes.fast[q] = W % 16 == 0 && Wb % 4 == 0 && ins[q] % 4 == 0;
    lanes.chunk0[q] = chunks;
    chunks += ((long long)P * W + 15) / 16;
  }
  lanes.chunk0[nlanes] = chunks;
  lanes.n = nlanes;
  return true;
}

}  // namespace

extern "C" int gf_lanes_unpack(int nlanes, const long long* ins, const long long* outs,
                               const long long* offs, const int* rows, const int* widths,
                               const int* wbs, void* stream) {
  gf::GlueLanes lanes;
  if (!glue_lanes(nlanes, ins, outs, offs, rows, widths, wbs, lanes))
    return (int)cudaErrorInvalidValue;
  const long long chunks = lanes.chunk0[nlanes];
  if (chunks == 0) return (int)cudaSuccess;
  const long long blocks = (chunks + gf::UNPACK_THREADS - 1) / gf::UNPACK_THREADS;
  const int grid = (int)(blocks < gf::UNPACK_MAX_BLOCKS ? blocks : gf::UNPACK_MAX_BLOCKS);
  gf::lanes_unpack_kernel<<<grid, gf::UNPACK_THREADS, 0, (cudaStream_t)stream>>>(lanes);
  return (int)cudaGetLastError();
}

extern "C" int gf_lane_exceptions(int nlanes, const long long* ins, const long long* outs,
                                  const long long* offs, const int* rows, const int* widths,
                                  const int* wbs, const void* exc, int E, void* stream) {
  gf::GlueLanes lanes;
  if (!glue_lanes(nlanes, ins, outs, offs, rows, widths, wbs, lanes) || E < 0 ||
      (uintptr_t)exc % 8)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  gf::lane_exceptions_kernel<<<(E + gf::EXC_THREADS - 1) / gf::EXC_THREADS, gf::EXC_THREADS, 0,
                               (cudaStream_t)stream>>>(lanes, (const int2*)exc, E);
  return (int)cudaGetLastError();
}

extern "C" int gf_compact_tile() { return gf::COMPACT_TILE; }

// okwords (ceil(N / 32),), tile_cnt (ceil(N / COMPACT_TILE),)
extern "C" int gf_compact_count(const void* v, int N, void* okwords, void* tile_cnt,
                                void* stream) {
  if (N < 1 || N >= (1 << 30)) return (int)cudaErrorInvalidValue;
  gf::compact_count_kernel<<<(N + gf::COMPACT_TILE - 1) / gf::COMPACT_TILE,
                             gf::COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, N, (int32_t*)okwords, (int32_t*)tile_cnt);
  return (int)cudaGetLastError();
}

// after gf_compact_count on the same v (none for N = 0): out (cap + 1,
// 13), slens (c,), gp (c, 4), c = min(cap, N). nlanes (0..MAX_LANES) code
// lanes, ptrs, offs, rows, widths host arrays of their pointers, first
// rows, rows and widths (<= Wmax), passed by value: the rows that they
// hold are copied into `codes` (c, Wmax), 255 past a lane's width (none
// for nlanes 0 or c 0, and then codes may be NULL). stats: NULL, or the
// vote's VOTE_STAT_SLOTS uint64 slots (gf_vote's), summed into out[cap, 1:3].
extern "C" int gf_compact_place(const void* v, const void* lens, int N, int cap,
                                const void* okwords, const void* tile_cnt, void* out,
                                void* slens, void* gp, int nlanes, const long long* ptrs,
                                const long long* offs, const int* rows, const int* widths,
                                int Wmax, void* codes, const void* stats, void* stream) {
  if (N < 0 || N >= (1 << 30) || cap < 0 ||
      (long long)(cap + 1LL) * gf::OUT_COLS >= (1LL << 31) || (uintptr_t)gp % 16 ||
      nlanes < 0 || nlanes > gf::MAX_LANES ||
      (nlanes && (Wmax < 1 || (codes == nullptr && cap > 0 && N > 0))))
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
  const int ntiles = (N + gf::COMPACT_TILE - 1) / gf::COMPACT_TILE;
  gf::compact_place_kernel<<<ntiles > 0 ? ntiles : 1, gf::COMPACT_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)v, (const int32_t*)lens, N, cap, (const int32_t*)okwords,
      (const int32_t*)tile_cnt, ntiles, (int32_t*)out, (int32_t*)slens, (int32_t*)gp, lanes,
      Wmax, (uint8_t*)codes, (const unsigned long long*)stats);
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
