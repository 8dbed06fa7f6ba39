// Kernel 2: the pass-1 vote, one warp per read.
//
// Replaces the XLA-jitted vote of the TPU scan, genefuserust_tpu/ops/
// map_read.py map_read_pass1 after the probe: expand_candidates(_kv),
// the gplong of (contig, pos - i), top2_votes (a two-key lax.sort plus a
// run-length scan) and the count*2 >= major/minor gate. On the TPU this
// stage was jnp; the TPU's only Pallas kernel is the probe (probe.cu).
//
// What bounds it on the H100: bytes. A read's input is its NS (contig,
// pos) probe results, 8*NS contiguous bytes, plus the dupe rows its DUPE
// samples name; its output is 20 bytes. At the main path's 65,536 x 89
// batch that is ~47 MB, ~0.014 ms at 3.35 TB/s. The counting is small: a
// regular hit is one candidate and a miss none, so a read holds at most
// NS valid candidates unless a sample hits a dupe row (up to D each).
//
// What the design does about it. The first design (one block per read)
// sorted all NS*D candidate slots, mostly empty, in shared memory with a
// barrier per sort stage. Here:
//   - one warp per read, 8 reads per block; the lanes load the row's
//     int2 results coalesced and expand only DUPE samples' rows;
//   - the warp compacts the n valid keys into its 2 KB slice of shared
//     memory (ballot + popc; no atomics, so the order is fixed);
//   - it sorts them in registers, K = 1, 2, 4 or 8 keys a lane (chosen
//     from n: 32 * K >= n), with a bitonic network whose partners are
//     64-bit shuffles (lane distance < 32) or registers (>= 32);
//   - run starts compare each key with its neighbour, and a run's length
//     is the distance to the next start, found in the ballot masks of run
//     starts; two warp max reductions over (count << 32 | N - 1 - index)
//     give the top two, ties to the smaller key as top2_votes; a missing
//     entry takes count 0 and the smallest slot key (the first sorted key,
//     or INVALID_KEY when a slot is empty and smaller).
// A read with more than WARP_CAP valid keys (dupe-heavy; at most NS*D) is
// flagged. After the warps are done the block meets at one barrier, and
// if any warp was flagged, the whole block takes each flagged read: it
// expands the valid keys into shared memory (atomic slots; the sort makes
// the order irrelevant), bitonic-sorts just those, and reduces as above.
// That barrier costs about nothing: a block retires only when its last
// warp is done anyway. Nothing but the (B, 5) result goes to device memory.
#include <climits>

#include "common.cuh"

namespace gf {

constexpr int VOTE_THREADS = 256;
constexpr int VOTE_WARPS = VOTE_THREADS / 32;
constexpr int WARP_CAP = 256;  // valid keys a warp sorts in registers (8 a lane)
constexpr unsigned FULL = 0xffffffffu;
constexpr long long PAD_KEY = LLONG_MAX;  // sorts after every candidate

// a key that may be voted for: not gplong 0 and not an INT32_MAX contig
__device__ __forceinline__ bool votable(long long k) {
  return k != 0 && (int)(k >> 32) != 0x7FFFFFFF;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ long long block_max(long long v, long long* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : -1LL);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// Scores are (count << 32) | (N - 1 - index) of a run start, -1 for none:
// the max is the largest count, then the smallest key. A missing entry
// gets count 0 and the smallest slot key.
__device__ __forceinline__ void write_vote(int32_t* o, long long best1, long long g1,
                                           long long best2, long long g2,
                                           long long slot_min, int step, int major_req,
                                           int minor_req) {
  const int c1 = best1 < 0 ? 0 : (int)(best1 >> 32);
  const int c2 = best2 < 0 ? 0 : (int)(best2 >> 32);
  if (best1 < 0) g1 = slot_min;
  if (best2 < 0) g2 = slot_min;
  o[0] = (c1 * step >= major_req) && (c2 * step >= minor_req);
  o[1] = (int32_t)(g1 >> 32);
  o[2] = (int32_t)(uint32_t)g1;
  o[3] = (int32_t)(g2 >> 32);
  o[4] = (int32_t)(uint32_t)g2;
}

// The smallest key over all NS*D slots: empty slots hold INVALID_KEY.
__device__ __forceinline__ long long slot_min(long long first_sorted, int n, int P) {
  if (n == 0) return INVALID_KEY;
  return n < P ? min(first_sorted, INVALID_KEY) : first_sorted;
}

// The row's valid candidate keys into slice[0, min(n, WARP_CAP)) -> n, the
// number of valid candidates (the same in every lane).
__device__ __forceinline__ int warp_compact(const int2* __restrict__ row, int NS,
                                            const int32_t* __restrict__ dupes, int dstride,
                                            int D, bool split, int cbits, int pos_bias,
                                            int step, int lane, long long* slice) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int s0 = 0; s0 < NS; s0 += 32) {
    const int s = s0 + lane;
    const int2 r = s < NS ? __ldg(row + s) : make_int2(EMPTY, 0);
    const bool reg = r.x >= 0;
    const unsigned rm = __ballot_sync(FULL, reg);
    if (reg) {
      const int at = n + __popc(rm & below);
      if (at < WARP_CAP) slice[at] = gplong(r.x, r.y, s * step);
    }
    n += __popc(rm);
    // DUPE samples, one at a time: the lanes read that row's D slots
    unsigned dm = __ballot_sync(FULL, r.x == DUPE && D > 1);
    while (dm) {
      const int src = __ffs(dm) - 1;
      dm &= dm - 1;
      const int drow = __shfl_sync(FULL, r.y, src);
      const int kmer = (s0 + src) * step;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        int32_t cc = 0, cp = 0;
        const bool v =
            d < D && expand(DUPE, drow, d, D, split, dupes, dstride, cbits, pos_bias, cc, cp);
        const unsigned vm = __ballot_sync(FULL, v);
        if (v) {
          const int at = n + __popc(vm & below);
          if (at < WARP_CAP) slice[at] = gplong(cc, cp, kmer);
        }
        n += __popc(vm);
      }
    }
  }
  return n;
}

// key of sorted element e (e = 32 k + lane), in every lane
template <int K>
__device__ __forceinline__ long long key_at(const long long (&v)[K], int e) {
  long long x = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if ((e >> 5) == k) x = v[k];
  return __shfl_sync(FULL, x, e & 31);
}

// The vote of one read whose n <= 32 * K valid keys are in `slice`.
template <int K>
__device__ __forceinline__ void warp_vote(const long long* slice, int n, int P, int lane,
                                          int step, int major_req, int minor_req,
                                          int32_t* o) {
  constexpr int N = 32 * K;
  constexpr int LOG_N = K == 1 ? 5 : K == 2 ? 6 : K == 4 ? 7 : 8;
  static_assert(N == 1 << LOG_N, "K is 1, 2, 4 or 8");
  long long v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = k * 32 + lane;
    v[k] = e < n ? slice[e] : PAD_KEY;
  }
  // bitonic sort, ascending in e = 32 k + lane
#pragma unroll
  for (int ls = 1; ls <= LOG_N; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int size = 1 << ls, j = 1 << lj;
      if (j >= 32) {
        const int jr = j >> 5;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & jr) continue;
          const bool asc = ((k * 32) & size) == 0;
          const long long a = v[k], b = v[k | jr];
          v[k] = asc ? min(a, b) : max(a, b);
          v[k | jr] = asc ? max(a, b) : min(a, b);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const long long other = __shfl_xor_sync(FULL, v[k], j);
          const int e = k * 32 + lane;
          const bool keep_min = ((e & size) == 0) == ((e & j) == 0);
          v[k] = keep_min ? min(v[k], other) : max(v[k], other);
        }
      }
    }
  }
  // run starts; a start's run ends at the next start (the padding, when
  // n < N, is a run of its own)
  unsigned starts[K];
  bool start[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long up = __shfl_up_sync(FULL, v[k], 1);
    const long long last = __shfl_sync(FULL, v[k > 0 ? k - 1 : 0], 31);
    start[k] = lane > 0 ? up != v[k] : (k == 0 || last != v[k]);
    starts[k] = __ballot_sync(FULL, start[k]);
  }
  long long sc[K];
  long long best1 = -1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sc[k] = -1;
    if (start[k] && votable(v[k])) {
      const int e = k * 32 + lane;
      int next = N;
#pragma unroll
      for (int kk = K - 1; kk > k; --kk)
        if (starts[kk]) next = kk * 32 + __ffs(starts[kk]) - 1;
      const unsigned above = starts[k] & ~((2u << lane) - 1u);
      if (above) next = k * 32 + __ffs(above) - 1;
      sc[k] = ((long long)(next - e) << 32) | (unsigned)(N - 1 - e);
    }
    best1 = max(best1, sc[k]);
  }
  best1 = warp_max(best1);
  const int e1 = best1 < 0 ? 0 : N - 1 - (int)(best1 & 0xFFFFFFFFLL);
  long long best2 = -1;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k * 32 + lane != e1) best2 = max(best2, sc[k]);
  best2 = warp_max(best2);
  const int e2 = best2 < 0 ? 0 : N - 1 - (int)(best2 & 0xFFFFFFFFLL);
  const long long g1 = key_at<K>(v, e1), g2 = key_at<K>(v, e2);
  const long long first = __shfl_sync(FULL, v[0], 0);
  if (lane == 0)
    write_vote(o, best1, g1, best2, g2, slot_min(first, n, P), step, major_req, minor_req);
}

// first index in [lo, n) whose key exceeds k (keys ascending)
__device__ __forceinline__ int upper_bound(const long long* keys, int lo, int n,
                                           long long k) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long run_score(const long long* keys, int i, int n, int Pn,
                                               int skip) {
  const long long k = keys[i];
  if (i == skip || (i > 0 && keys[i - 1] == k) || !votable(k)) return -1;
  const int cnt = upper_bound(keys, i + 1, n, k) - i;
  return ((long long)cnt << 32) | (unsigned)(Pn - 1 - i);
}

// The vote of one read by the whole block, over its valid keys only;
// `keys` holds at least next_pow2(NS * D) slots.
__device__ void block_vote(const int2* __restrict__ row, int NS,
                           const int32_t* __restrict__ dupes, int dstride, int D, bool split,
                           int cbits, int pos_bias, int step, int major_req, int minor_req,
                           long long* keys, long long* red, int* count, int32_t* o) {
  const int P = NS * D;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int s = p / D, d = p - s * D;
    const int2 r = __ldg(row + s);
    int32_t cc, cp;
    if (expand(r.x, r.y, d, D, split, dupes, dstride, cbits, pos_bias, cc, cp))
      keys[atomicAdd(count, 1)] = gplong(cc, cp, s * step);
  }
  __syncthreads();
  const int n = *count;
  int Pn = 1;
  while (Pn < n) Pn <<= 1;
  for (int p = n + threadIdx.x; p < Pn; p += blockDim.x) keys[p] = PAD_KEY;
  __syncthreads();
  for (int k = 2; k <= Pn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < Pn; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const long long a = keys[i], c = keys[ixj];
          if ((a > c) == ((i & k) == 0)) { keys[i] = c; keys[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
  long long best1 = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    best1 = max(best1, run_score(keys, i, n, Pn, -1));
  best1 = block_max(best1, red);
  const int i1 = best1 < 0 ? 0 : Pn - 1 - (int)(best1 & 0xFFFFFFFFLL);
  long long best2 = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    best2 = max(best2, run_score(keys, i, n, Pn, i1));
  best2 = block_max(best2, red);
  if (threadIdx.x == 0) {
    const int i2 = best2 < 0 ? 0 : Pn - 1 - (int)(best2 & 0xFFFFFFFFLL);
    write_vote(o, best1, keys[i1], best2, keys[i2], slot_min(keys[0], n, P), step,
               major_req, minor_req);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(VOTE_THREADS)
vote_kernel(const int32_t* __restrict__ pr, int B, int NS,
            const int32_t* __restrict__ dupes, int dstride, int D, bool split, int cbits,
            int pos_bias, int step, int major_req, int minor_req,
            int32_t* __restrict__ out) {
  extern __shared__ long long smem[];
  __shared__ long long red[33];
  __shared__ int over_row[VOTE_WARPS];
  __shared__ int count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * VOTE_WARPS + warp;
  const int2* rows = reinterpret_cast<const int2*>(pr);
  bool over = false;
  if (b < B) {
    long long* slice = smem + warp * WARP_CAP;
    const int n = warp_compact(rows + (long long)b * NS, NS, dupes, dstride, D, split, cbits,
                               pos_bias, step, lane, slice);
    __syncwarp();
    const int P = NS * D;
    int32_t* o = out + (long long)b * 5;
    if (n <= 32) warp_vote<1>(slice, n, P, lane, step, major_req, minor_req, o);
    else if (n <= 64) warp_vote<2>(slice, n, P, lane, step, major_req, minor_req, o);
    else if (n <= 128) warp_vote<4>(slice, n, P, lane, step, major_req, minor_req, o);
    else if (n <= WARP_CAP) warp_vote<8>(slice, n, P, lane, step, major_req, minor_req, o);
    else over = true;
  }
  if (lane == 0) over_row[warp] = over ? b : -1;
  if (!__syncthreads_or(over)) return;
  // the warp slices are free now: the block-wide path reuses them
  for (int w = 0; w < VOTE_WARPS; ++w) {
    const int ob = over_row[w];
    if (ob >= 0)
      block_vote(rows + (long long)ob * NS, NS, dupes, dstride, D, split, cbits, pos_bias,
                 step, major_req, minor_req, smem, red, &count, out + (long long)ob * 5);
  }
}

}  // namespace gf

// pr: (B, NS, 2) int32 pass-1 probe results (sample s at k-mer s*step).
// dupes: split (nd, D, 2) pairs / kv (nd, 8) payloads, row stride dstride.
// out: (B, 5) int32 [ok, h1, l1, h2, l2]. P2: power of two >= NS*D, the
// block-wide path's key buffer.
extern "C" int gf_vote(const void* pr, int B, int NS, const void* dupes, int dstride,
                       int D, int split, int cbits, int pos_bias, int step,
                       int major_req, int minor_req, int P2, void* out, void* stream) {
  const size_t n_keys = P2 > gf::VOTE_WARPS * gf::WARP_CAP ? (size_t)P2
                                                           : (size_t)gf::VOTE_WARPS * gf::WARP_CAP;
  const size_t smem = n_keys * sizeof(long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf::vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + gf::VOTE_WARPS - 1) / gf::VOTE_WARPS;
  gf::vote_kernel<<<grid, gf::VOTE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pr, B, NS, (const int32_t*)dupes, dstride, D, split != 0, cbits,
      pos_bias, step, major_req, minor_req, (int32_t*)out);
  return (int)cudaGetLastError();
}
