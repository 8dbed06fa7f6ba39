// Kernel 2: the pass-1 vote, one warp per read.
//
// Replaces the XLA-jitted vote of the TPU scan, genefuserust_tpu/ops/
// map_read.py map_read_pass1 after the probe: expand_candidates(_kv),
// the gplong of (contig, pos - i), top2_votes (a two-key lax.sort plus a
// run-length scan) and the count*2 >= major/minor gate. On the TPU this
// stage was jnp; the TPU's only Pallas kernel is the probe (probe.cu).
//
// What bounds it on the H100. Its bytes: a read's input is its NS
// (contig, pos) probe results, 8*NS contiguous bytes, plus the dupe rows
// its DUPE samples name; its output is 20 bytes. At the main path's
// 65,536 x 89 batch that is ~47 MB, ~0.014 ms at 3.35 TB/s. The counting
// is small: a regular hit is one candidate and a miss none, so a read
// holds at most NS valid candidates unless a sample hits a dupe row (up
// to D each). But the kernel ran at 9% of that bound, and the time went to
// instructions: a bitonic sort of every read's keys in registers (K = 4
// for the 65-128 keys of an on-target read: 28 stages of 64-bit shuffles
// and min/max selects) took 77% of the kernel on the cancer15 cell's
// batches and 65% on oncokb1100's (a build without it, PERF.md §6).
// Yet a read holds few distinct keys: a substitution turns k-mers into
// misses, not other keys, so an on-target read is one diagonal (contig,
// pos - i) and what its DUPE samples and stray hits add. Those batches
// hold 1.2 and 4.6 distinct keys a read on average, none past 16.
//
// What the design does about it. The first design (one block per read)
// sorted all NS*D candidate slots, mostly empty, in shared memory with a
// barrier per sort stage. Here:
//   - one warp per read, 8 reads per block; the lanes load the row's
//     int2 results coalesced and expand only DUPE samples' rows;
//   - the warp compacts the n valid keys into its 2 KB slice of shared
//     memory (ballot + popc; no atomics, so the order is fixed) and holds
//     them in registers, K = 1, 2, 4 or 8 keys a lane (32 * K >= n);
//   - it peels the distinct keys (warp_peel): each step takes the first
//     key left, counts its slots with a compare and a ballot a register
//     and marks them counted, and keeps the top two (count, key) and the
//     least key; after the first key, as a rule the diagonal, the slots
//     left move to one register when they fit, so later steps cost one
//     compare and one ballot. A read of more than PEEL_CAP (16) distinct
//     keys (none in those batches; dupe-heavy reads) is sorted instead,
//     over the same untouched slice (warp_vote):
//   - the sort: a bitonic network whose partners are 64-bit shuffles
//     (lane distance < 32) or registers (>= 32); run starts compare each
//     key with its neighbour, and a run's length is the distance to the
//     next start, found in the ballot masks of run starts; two warp max
//     reductions over (count << 32 | N - 1 - index) give the top two;
//   - both give the same rows bit for bit, top2_votes': ties to the
//     smaller key (signed), and a missing entry takes count 0 and the
//     smallest slot key (the least key, or INVALID_KEY when a slot is
//     empty and smaller);
//   - each block adds its rows voted and rows sorted to a counter, one
//     atomic a block over VOTE_STAT_SLOTS slots, for the engine's
//     vote.rows and vote.rows_sorted.
// The peel keeps more in registers than the sort alone: ptxas gave
// vote_kernel 60 registers (4 blocks of 256 an SM) where the sort alone
// had 48 (5 blocks), and with fewer warps in flight the rows' loads waited
// longer. VOTE_MIN_BLOCKS 6 caps it at 40 registers (6 blocks an SM; 200
// bytes of spill stores), 18-20% faster than no cap on the cells' batches
// (8 blocks, 32 registers and 768 bytes spilled: as fast on cancer15's, 8%
// faster on oncokb1100's; PERF.md §6). What bounds it now: on those
// batches it takes 0.274 and 0.521 ms where a build without the vote takes
// 0.167 and 0.316, so the loads and the compaction (the split table's
// DUPE rows read one sample at a time) are most of it, the peel the rest.
// A read with more than WARP_CAP valid keys (dupe-heavy; at most NS*D) is
// flagged. After the warps are done the block meets at one barrier, and
// if any warp was flagged, the whole block takes each flagged read: it
// expands the valid keys into shared memory (atomic slots; the sort makes
// the order irrelevant), bitonic-sorts just those, and reduces as above.
// That barrier costs about nothing: a block retires only when its last
// warp is done anyway. Nothing but the (B, 5) result and the counter go
// to device memory.
//
// Rows too wide for the block path's shared memory (NS * D past
// MAX_BLOCK_KEYS, code rows of more than ~4,096 bases) take the wide path:
// the same vote (map_read_pass1's, or sharded_index.py's counts vote) on
// rows that are mostly padding. A batch holding one long read pads every
// row to it, so what bounds the wide path is the rows' own lengths, not
// the padded width: a 150-base row of a 70,016-base batch holds 68
// samples of 35,001, and a long row's valid keys (2,267 at 70,000 bases)
// are a small share of its NS * D slots. The design:
//   - vote_kernel takes the rows' lengths and walks only the samples
//     inside a row (s * step <= min(len, L) - 16: every later sample is a
//     miss); a row of more than VOTE_WALK_MAX samples is listed for the
//     block without a walk (one warp would walk its chunks of 32 samples
//     one after another), and so is a walked row of more than WARP_CAP
//     valid keys;
//   - vote_wide_kernel gives a listed row a block of 1,024 threads. The
//     warps count the row's valid keys over ranges of whole chunks, then
//     ballot-compact them into shared memory at each warp's scanned
//     offset (no atomics, the order is fixed), a DUPE sample's D slots
//     read for that sample alone; the block bitonic-sorts just the n keys
//     (the slots up to next_pow2(n) act as +inf and are never stored);
//     each thread walks a tile of sorted keys, a run's start reaching
//     later tiles by a block max-scan, so a run's count comes from
//     neighbour compares; two block max reductions give the top two. The
//     results are block_vote's bit for bit, slot_min taking the padded
//     row's P = NS * D.
// A row whose count passes the shared-memory cap (28,672 keys) is listed
// again, with an offset into a global scratch that the wrapper then sizes
// from those counts, and a second launch of the kernel sorts it there.
//
// Counts mode (the contig-sharded index): the same vote, its two entries
// written as [c1, h1, l1, c2, h2, l2] with no gate, for a device's shards
// in one launch (vote_shards_kernel, vote_shards_wide_kernel);
// merge_top2_kernel then merges the shards' entries and applies the gate.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace gf {

constexpr int VOTE_THREADS = 256;
constexpr int VOTE_WARPS = VOTE_THREADS / 32;
// blocks of VOTE_THREADS that vote_kernel and vote_shards_kernel must fit
// on an SM at once, which caps their registers at 40: the warp path waits
// on its rows' loads, and more resident warps hide more of that wait
constexpr int VOTE_MIN_BLOCKS = 6;
constexpr int WARP_CAP = 256;  // valid keys a warp votes on in registers (8 a lane)
constexpr int PEEL_CAP = 16;  // distinct keys a warp counts one by one before it sorts
constexpr unsigned FULL = 0xffffffffu;
constexpr long long PAD_KEY = LLONG_MAX;  // sorts after every candidate
constexpr int MAX_BLOCK_KEYS = 16384;  // the block path's keys in shared memory (128 KB)
constexpr int VOTE_WIDE_THREADS = 1024;
constexpr int VOTE_WIDE_GROUP = 4;  // chunks of 32 samples whose loads go out together
constexpr int VOTE_SMEM_KEYS = 28672;  // the wide path's keys in shared memory (224 KB)
constexpr int VOTE_WALK_MAX = 2048;  // samples a warp walks on the wide path (~4,110 bases)
constexpr int MAX_SHARDS = 8;  // merge_top2_kernel, built for 1 to 8 shards
constexpr int MERGE_ROWS = 64;  // merge_top2_kernel's rows a block, a thread a row

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
// gets count 0 and the smallest slot key. The row is [ok, h1, l1, h2, l2],
// or in counts mode [c1, h1, l1, c2, h2, l2].
__device__ __forceinline__ void write_vote(int32_t* o, long long best1, long long g1,
                                           long long best2, long long g2,
                                           long long slot_min, int step, int major_req,
                                           int minor_req, bool counts) {
  const int c1 = best1 < 0 ? 0 : (int)(best1 >> 32);
  const int c2 = best2 < 0 ? 0 : (int)(best2 >> 32);
  if (best1 < 0) g1 = slot_min;
  if (best2 < 0) g2 = slot_min;
  if (counts) {
    o[0] = c1;
    o[1] = (int32_t)(g1 >> 32);
    o[2] = (int32_t)(uint32_t)g1;
    o[3] = c2;
    o[4] = (int32_t)(g2 >> 32);
    o[5] = (int32_t)(uint32_t)g2;
    return;
  }
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
                                          int step, int major_req, int minor_req, bool counts,
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
    write_vote(o, best1, g1, best2, g2, slot_min(first, n, P), step, major_req, minor_req,
               counts);
}

// The top two (count, key) of the keys peeled so far, and the least key.
struct Peeled {
  int c1 = 0, c2 = 0;  // count 0: no entry
  long long g1 = 0, g2 = 0, least = LLONG_MAX;
  int d = 0;  // keys peeled
};

// Peels the keys of the slots `left` (ballot masks, uniform in the warp)
// of v[K], one a step: the first slot left (ffs of the first nonzero
// mask) gives the key, a compare and a ballot a register count its slots,
// which are then marked counted. A votable key is scored as warp_vote
// scores its run: the larger count first, then the smaller key (signed,
// the sort's order). At most `steps` steps (PEEL_CAP take any start to
// the end or to the cap) -> false once a key is left past PEEL_CAP keys
// peeled.
template <int K>
__device__ __forceinline__ bool peel_keys(const long long (&v)[K], unsigned (&left)[K],
                                          Peeled& p, int steps) {
  for (int step = 0; step < steps; ++step) {
    int kf = -1;
    unsigned mf = 0;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (left[k]) {
        kf = k;
        mf = left[k];
      }
    if (kf < 0) return true;
    if (p.d == PEEL_CAP) return false;
    ++p.d;
    long long x = v[0];
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (k == kf) x = v[k];
    const long long key = __shfl_sync(FULL, x, __ffs(mf) - 1);
    int c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned eq = __ballot_sync(FULL, v[k] == key) & left[k];
      c += __popc(eq);
      left[k] &= ~eq;
    }
    p.least = min(p.least, key);
    if (votable(key)) {
      if (c > p.c1 || (c == p.c1 && key < p.g1)) {
        p.c2 = p.c1;
        p.g2 = p.g1;
        p.c1 = c;
        p.g1 = key;
      } else if (c > p.c2 || (c == p.c2 && key < p.g2)) {
        p.c2 = c;
        p.g2 = key;
      }
    }
  }
  return true;
}

// The vote of one read whose n <= 32 * K valid keys are in `slice`, by
// peeling its distinct keys (peel_keys). After the first key (as a rule
// the read's diagonal, most of its slots) a read of K > 1 whose slots left
// fit one register moves them to slice[n, n + 32) and peels the rest there,
// a compare and a ballot a step instead of K; slice[0, n) stays as it was.
// The least key is the sort's first. -> false, with nothing written, for a
// read of more than PEEL_CAP distinct keys.
template <int K>
__device__ __forceinline__ bool warp_peel(long long* slice, int n, int P, int lane, int step,
                                          int major_req, int minor_req, bool counts,
                                          int32_t* o) {
  long long v[K];
  unsigned left[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = k * 32 + lane, m = n - k * 32;
    v[k] = e < n ? slice[e] : 0;
    left[k] = m >= 32 ? FULL : m > 0 ? (1u << m) - 1u : 0u;
  }
  Peeled p;
  if (!peel_keys<K>(v, left, p, 1)) return false;
  int rest = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) rest += __popc(left[k]);
  if (K > 1 && rest > 0 && rest <= 32 && n + rest <= WARP_CAP) {
    const unsigned below = (1u << lane) - 1u;
    int at = n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((left[k] >> lane) & 1u) slice[at + __popc(left[k] & below)] = v[k];
      at += __popc(left[k]);
    }
    __syncwarp();
    const long long w[1] = {lane < rest ? slice[n + lane] : 0};
    unsigned l1[1] = {rest == 32 ? FULL : (1u << rest) - 1u};
    if (!peel_keys<1>(w, l1, p, PEEL_CAP)) return false;
  } else if (!peel_keys<K>(v, left, p, PEEL_CAP)) {
    return false;
  }
  if (lane == 0)
    write_vote(o, p.c1 ? (long long)p.c1 << 32 : -1, p.g1, p.c2 ? (long long)p.c2 << 32 : -1,
               p.g2, slot_min(p.least, n, P), step, major_req, minor_req, counts);
  return true;
}

// The warp path's vote of one read: the peel, or past PEEL_CAP distinct
// keys the sort over the same slice -> whether it sorted.
template <int K>
__device__ __forceinline__ bool vote_warp(long long* slice, int n, int P, int lane,
                                          int step, int major_req, int minor_req, bool counts,
                                          int32_t* o) {
  if (warp_peel<K>(slice, n, P, lane, step, major_req, minor_req, counts, o)) return false;
  warp_vote<K>(slice, n, P, lane, step, major_req, minor_req, counts, o);
  return true;
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
// `keys` (shared memory) holds at least next_pow2(NS * D) slots.
__device__ void block_vote(const int2* __restrict__ row, int NS,
                           const int32_t* __restrict__ dupes, int dstride, int D, bool split,
                           int cbits, int pos_bias, int step, int major_req, int minor_req,
                           bool counts, long long* keys, long long* red, int* count,
                           int32_t* o) {
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
               major_req, minor_req, counts);
  }
  __syncthreads();
}

// Samples of row b inside its length, all NS without lengths: sample s is
// the k-mer at s * step, inside when s * step <= len - KMER.
__device__ __forceinline__ int row_samples(const int32_t* __restrict__ lengths, int b, int NS,
                                           int step) {
  if (lengths == nullptr) return NS;
  const int len = __ldg(lengths + b);
  return len < KMER ? 0 : min(NS, (len - KMER) / step + 1);
}

// The wide path's int64 list: [rows listed, their keys in the global
// scratch, rows past the shared-memory cap, listed rows x B, rows past
// the cap x B, their offsets in the global scratch x B].
constexpr int WL_ROWS = 0, WL_KEYS = 1, WL_OVER = 2, WL_HEAD = 3;

// A vote kernel's rows: the (B, NS) results of one table (vote_kernel,
// vote_wide_kernel) or of one shard (vote_shards_kernel,
// vote_shards_wide_kernel), the parameters of its dupe table, and where
// its rows' votes go (5 or 6 int32 a row).
struct VoteRows {
  const int2* pr;
  const int32_t* dupes;
  int dstride, D, cbits, pos_bias;
  int32_t* out;
};

// The body of vote_kernel and vote_shards_kernel: row b = blockIdx.x *
// VOTE_WARPS + warp of `v`. lengths: NULL, or the rows' lengths; a row's
// warp then walks only its samples inside them. wide: NULL, or the wide
// path's list: the rows past the warp path (more than VOTE_WALK_MAX
// samples inside, or more than WARP_CAP valid keys) are listed there, as
// first + b, for the wide kernel instead of taken by the block here.
// stats: NULL, or VOTE_STAT_SLOTS slots that each block adds its rows
// voted on the warp path + its rows sorted << 32 to, in slot blockIdx.x %
// VOTE_STAT_SLOTS (one atomic a block, spread so that no slot serialises).
__device__ __forceinline__ void vote_rows(const VoteRows& v, int B, int NS,
                                          const int32_t* __restrict__ lengths, bool split,
                                          int step, int major_req, int minor_req, bool counts,
                                          long long* __restrict__ wide, long long first,
                                          unsigned long long* __restrict__ stats) {
  extern __shared__ long long smem[];
  __shared__ long long red[33];
  __shared__ int over_row[VOTE_WARPS];
  __shared__ unsigned long long tally[VOTE_WARPS];
  __shared__ int count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * VOTE_WARPS + warp;
  const int cols = counts ? 6 : 5;
  bool over = false;
  unsigned long long mine = 0;  // 1 voted on the warp path, + 1 << 32 sorted
  if (b < B) {
    const int ns = row_samples(lengths, b, NS, step);
    if (wide != nullptr && ns > VOTE_WALK_MAX) {
      over = true;
    } else {
      long long* slice = smem + warp * WARP_CAP;
      const int n = warp_compact(v.pr + (long long)b * NS, ns, v.dupes, v.dstride, v.D, split,
                                 v.cbits, v.pos_bias, step, lane, slice);
      __syncwarp();
      const int P = NS * v.D;
      int32_t* o = v.out + (long long)b * cols;
      bool sorted = false;
      if (n <= 32)
        sorted = vote_warp<1>(slice, n, P, lane, step, major_req, minor_req, counts, o);
      else if (n <= 64)
        sorted = vote_warp<2>(slice, n, P, lane, step, major_req, minor_req, counts, o);
      else if (n <= 128)
        sorted = vote_warp<4>(slice, n, P, lane, step, major_req, minor_req, counts, o);
      else if (n <= WARP_CAP)
        sorted = vote_warp<8>(slice, n, P, lane, step, major_req, minor_req, counts, o);
      else
        over = true;
      mine = over ? 0ull : 1ull + ((unsigned long long)sorted << 32);
    }
  }
  if (lane == 0) {
    over_row[warp] = over ? b : -1;
    tally[warp] = mine;
  }
  const bool any_over = __syncthreads_or(over);
  if (stats != nullptr && threadIdx.x == 0) {
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < VOTE_WARPS; ++w) t += tally[w];
    if (t) atomicAdd(stats + blockIdx.x % VOTE_STAT_SLOTS, t);
  }
  if (!any_over) return;
  if (wide != nullptr) {
    if (threadIdx.x < VOTE_WARPS && over_row[threadIdx.x] >= 0) {
      auto* head = reinterpret_cast<unsigned long long*>(wide);
      wide[WL_HEAD + atomicAdd(head + WL_ROWS, 1ull)] = first + over_row[threadIdx.x];
    }
    return;
  }
  // the warp slices are free now: the block-wide path reuses them
  for (int w = 0; w < VOTE_WARPS; ++w) {
    const int ob = over_row[w];
    if (ob >= 0)
      block_vote(v.pr + (long long)ob * NS, NS, v.dupes, v.dstride, v.D, split, v.cbits,
                 v.pos_bias, step, major_req, minor_req, counts, smem, red, &count,
                 v.out + (long long)ob * cols);
  }
}

// The vote of one table's rows, listed in `wide` as b (vote_rows).
__global__ void __launch_bounds__(VOTE_THREADS, VOTE_MIN_BLOCKS)
vote_kernel(const int32_t* __restrict__ pr, int B, int NS, const int32_t* __restrict__ lengths,
            const int32_t* __restrict__ dupes, int dstride, int D, bool split, int cbits,
            int pos_bias, int step, int major_req, int minor_req, bool counts,
            long long* __restrict__ wide, int32_t* __restrict__ out,
            unsigned long long* __restrict__ stats) {
  vote_rows(VoteRows{reinterpret_cast<const int2*>(pr), dupes, dstride, D, cbits, pos_bias, out},
            B, NS, lengths, split, step, major_req, minor_req, counts, wide, 0, stats);
}

// Samples [s0, s1) of a row, one warp: their valid candidate keys -> their
// number; with WRITE also ballot-compacted into keys[base, ...) in a fixed
// order. The loads of VOTE_WIDE_GROUP chunks of 32 samples go out
// together; a DUPE sample's D slots are read for that sample alone.
template <bool WRITE>
__device__ __forceinline__ int warp_keys(const int2* __restrict__ row, int s0, int s1,
                                         const int32_t* __restrict__ dupes, int dstride, int D,
                                         bool split, int cbits, int pos_bias, int step, int lane,
                                         long long* keys, long long base) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int c0 = s0; c0 < s1; c0 += 32 * VOTE_WIDE_GROUP) {
    int2 r[VOTE_WIDE_GROUP];
#pragma unroll
    for (int j = 0; j < VOTE_WIDE_GROUP; ++j) {
      const int s = c0 + 32 * j + lane;
      r[j] = s < s1 ? __ldg(row + s) : make_int2(EMPTY, 0);
    }
#pragma unroll
    for (int j = 0; j < VOTE_WIDE_GROUP; ++j) {
      const int s = c0 + 32 * j + lane;
      const bool reg = r[j].x >= 0;
      const unsigned rm = __ballot_sync(FULL, reg);
      if (WRITE && reg) keys[base + n + __popc(rm & below)] = gplong(r[j].x, r[j].y, s * step);
      n += __popc(rm);
      unsigned dm = __ballot_sync(FULL, r[j].x == DUPE && D > 1);
      while (dm) {
        const int src = __ffs(dm) - 1;
        dm &= dm - 1;
        const int drow = __shfl_sync(FULL, r[j].y, src);
        const int kmer = (c0 + 32 * j + src) * step;
        for (int d0 = 0; d0 < D; d0 += 32) {
          const int d = d0 + lane;
          int32_t cc = 0, cp = 0;
          const bool v =
              d < D && expand(DUPE, drow, d, D, split, dupes, dstride, cbits, pos_bias, cc, cp);
          const unsigned vm = __ballot_sync(FULL, v);
          if (WRITE && v) keys[base + n + __popc(vm & below)] = gplong(cc, cp, kmer);
          n += __popc(vm);
        }
      }
    }
  }
  return n;
}

// keys[0, n) sorted ascending by the block: a bitonic network over
// next_pow2(n) slots whose comparators all put the smaller key at the
// lower index (each merge starts by comparing mirrored halves), so the
// slots past n act as +inf, are never stored, and a comparator that
// reaches one does nothing.
__device__ void block_sort(long long* keys, int n) {
  int Pn = 1;
  while (Pn < n) Pn <<= 1;
  for (int k = 2; k <= Pn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int flip = j == k >> 1 ? k - 1 : j;
      for (int q = threadIdx.x; q < Pn >> 1; q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j of i is clear
        const int p = i ^ flip;
        if (p < n) {
          const long long a = keys[i], c = keys[p];
          if (a > c) {
            keys[i] = c;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The vote of one wide row from its n valid keys in `keys` (shared memory,
// or the row's slice of the global scratch), by the block: sorted, then
// counted run by run. Each thread walks a tile of consecutive sorted keys;
// a run starting in an earlier tile gets its start from a block max-scan
// of the tiles' last starts; a run scores at its last key as (count << 32)
// | (n - 1 - start), and each thread keeps its best two. P: the padded
// row's NS * D slots, for slot_min.
__device__ void sorted_vote(long long* keys, int n, int P, int step, int major_req,
                            int minor_req, bool counts, long long* red, int* sm, int32_t* o) {
  block_sort(keys, n);
  const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int t0 = min(n, (int)threadIdx.x * per), t1 = min(n, t0 + per);
  int last = -1;
  for (int i = t0; i < t1; ++i)
    if (i == 0 || keys[i - 1] != keys[i]) last = i;
  int all;
  int start = block_excl_max(last, sm, all);
  long long b1 = -1, b2 = -1;
  for (int i = t0; i < t1; ++i) {
    const long long k = keys[i];
    if (i == 0 || keys[i - 1] != k) start = i;
    if ((i + 1 == n || keys[i + 1] != k) && votable(k)) {
      const long long sc = ((long long)(i + 1 - start) << 32) | (unsigned)(n - 1 - start);
      if (sc > b1) {
        b2 = b1;
        b1 = sc;
      } else if (sc > b2) {
        b2 = sc;
      }
    }
  }
  const long long best1 = block_max(b1, red);
  const long long best2 = block_max(b1 == best1 ? b2 : b1, red);
  if (threadIdx.x == 0) {
    const int i1 = best1 < 0 ? 0 : n - 1 - (int)(best1 & 0xFFFFFFFFLL);
    const int i2 = best2 < 0 ? 0 : n - 1 - (int)(best2 & 0xFFFFFFFFLL);
    write_vote(o, best1, keys[i1], best2, keys[i2], slot_min(keys[0], n, P), step, major_req,
               minor_req, counts);
  }
  __syncthreads();  // the keys and slots are the next row's
}

// The body of vote_wide_kernel and vote_shards_wide_kernel: the rows a
// vote kernel listed (global_pass: the rows listed again here, past
// keys_cap), block g taking entries g, g + grid, ... of the list's N; the
// entry e of row b of rows.at(e, b), e then what that row is listed again
// as. A row's warps take ranges of whole chunks of 32 samples: they count
// its valid keys, then (unless the row is past keys_cap on the first
// pass: it is listed for the global pass with its offset in the scratch)
// write them at their scanned offsets into shared memory or the row's
// scratch slice.
template <class Rows>
__device__ __forceinline__ void vote_wide_rows(const Rows& rows, int N, int NS,
                                               const int32_t* __restrict__ lengths, bool split,
                                               int step, int major_req, int minor_req,
                                               bool counts, long long* __restrict__ wide,
                                               long long* __restrict__ scratch, int keys_cap,
                                               bool global_pass) {
  extern __shared__ long long keys_s[];
  __shared__ long long red[33];
  __shared__ int sm[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int cols = counts ? 6 : 5;
  const long long* list = wide + WL_HEAD + (global_pass ? N : 0);
  const long long n_rows = wide[global_pass ? WL_OVER : WL_ROWS];
  for (long long i = blockIdx.x; i < n_rows; i += gridDim.x) {
    long long e = list[i];
    int b;
    const VoteRows v = rows.at(e, b);
    const int2* row = v.pr + (long long)b * NS;
    const int ns = row_samples(lengths, b, NS, step);
    const int per_warp = ((ns + 31) / 32 + warps - 1) / warps;
    const int s0 = min(ns, warp * per_warp * 32), s1 = min(ns, s0 + per_warp * 32);
    const int mine = warp_keys<false>(row, s0, s1, v.dupes, v.dstride, v.D, split, v.cbits,
                                      v.pos_bias, step, lane, nullptr, 0);
    if (lane == 0) sm[warp] = mine;
    __syncthreads();
    int base = 0, n = 0;
    for (int w = 0; w < warps; ++w) {
      base += w < warp ? sm[w] : 0;
      n += sm[w];
    }
    __syncthreads();
    long long* keys = keys_s;
    if (global_pass) {
      keys = scratch + wide[WL_HEAD + 2 * N + i];
    } else if (n > keys_cap) {
      if (threadIdx.x == 0) {
        auto* head = reinterpret_cast<unsigned long long*>(wide);
        const long long k = (long long)atomicAdd(head + WL_OVER, 1ull);
        wide[WL_HEAD + N + k] = e;
        wide[WL_HEAD + 2 * N + k] = (long long)atomicAdd(head + WL_KEYS, (unsigned long long)n);
      }
      continue;
    }
    warp_keys<true>(row, s0, s1, v.dupes, v.dstride, v.D, split, v.cbits, v.pos_bias, step, lane,
                    keys, base);
    __syncthreads();
    sorted_vote(keys, n, NS * v.D, step, major_req, minor_req, counts, red, sm,
                v.out + (long long)b * cols);
  }
}

// One table's rows: entry e is row b = e.
struct OneTable {
  VoteRows v;
  __device__ __forceinline__ VoteRows at(long long& e, int& b) const {
    b = (int)e;
    e = b;
    return v;
  }
};

// The rows vote_kernel listed (vote_wide_rows over its B entries).
__global__ void __launch_bounds__(VOTE_WIDE_THREADS)
vote_wide_kernel(const int32_t* __restrict__ pr, int B, int NS,
                 const int32_t* __restrict__ lengths, const int32_t* __restrict__ dupes,
                 int dstride, int D, bool split, int cbits, int pos_bias, int step,
                 int major_req, int minor_req, bool counts, long long* __restrict__ wide,
                 long long* __restrict__ scratch, int keys_cap, bool global_pass,
                 int32_t* __restrict__ out) {
  const VoteRows v{reinterpret_cast<const int2*>(pr), dupes, dstride, D, cbits, pos_bias, out};
  vote_wide_rows(OneTable{v}, B, NS, lengths, split, step, major_req, minor_req, counts, wide,
                 scratch, keys_cap, global_pass);
}

// The contig-sharded index's top-2 merge and gate, one thread a row
// (genefuserust_tpu/parallel/sharded_index.py _merge_top2 and the gate of
// build_sharded_map_read). Its 2S candidates, [c1 of shards 0..S-1, c2 of
// shards 0..S-1], are ordered by count descending, then (hi, lo unsigned)
// ascending; a count <= 0 ties with every other such entry and sorts after
// the rest; ties keep the candidates' order (a stable sort: JAX's sort
// leaves the order of those ties open, and they reach only rows the gate
// fails). The first two are the top two.
//
// What bounds it: a launch. At the sharded scan's 8,192 rows and 4 shards
// it reads 0.8 MB and writes 0.16 MB, 0.3 us at 3.35 TB/s. So the shards'
// rows are read where the vote wrote them (a by-value table of their
// pointers; no stack of them first), MERGE_ROWS rows a block spread over
// the card, and what pass 2 takes is written as it takes it: the keys
// (B, 4) [h1, l1, h2, l2] in one 16-byte store a row and the gate (B,) as
// bytes, no slicing after. A kernel for each shard count keeps just its
// 2S candidates in registers, and a tournament of top twos finds the two
// in log2(2S) rounds of compares rather than a chain of 2 x 2S. A shard's
// 24-byte row is three 8-byte loads (staging the block's rows through
// shared memory first, in coalesced loads, was slower on the H100).
__device__ __forceinline__ bool merge_before(int ca, int ha, int la, int cb, int hb, int lb) {
  if ((ca > 0) != (cb > 0)) return ca > 0;
  if (ca <= 0) return false;
  if (ca != cb) return ca > cb;
  if (ha != hb) return ha < hb;
  return (uint32_t)la < (uint32_t)lb;
}

// the shards' (B, 6) counts-mode rows, by value
struct MergeShards {
  const int2* rows[MAX_SHARDS];
};

struct Cand {
  int c, h, l;
};

__device__ __forceinline__ bool cand_before(const Cand& a, const Cand& b) {
  return merge_before(a.c, a.h, a.l, b.c, b.h, b.l);
}

// The top two of candidates x[LO, LO + N) in the merge's order, every
// candidate of the range before every later one on ties: the two halves'
// top twos, the left's first unless the right's first precedes it, and
// the second the better of the two that can be second. A tournament: log2
// N rounds of compares on the critical path, not 2N in a chain. (N = 1
// leaves `second` as it was.)
template <int LO, int N>
__device__ __forceinline__ void top2(const Cand* x, Cand& first, Cand& second) {
  if constexpr (N == 1) {
    first = x[LO];
  } else {
    constexpr int H = N / 2;
    Cand a1, a2, b1, b2;
    top2<LO, H>(x, a1, a2);
    top2<LO + H, N - H>(x, b1, b2);
    const bool right = cand_before(b1, a1);
    first = right ? b1 : a1;
    if constexpr (H == 1 && N - H == 1) {
      second = right ? a1 : b1;
    } else if constexpr (H == 1) {  // the left half is one candidate
      second = right ? (cand_before(b2, a1) ? b2 : a1) : b1;
    } else if constexpr (N - H == 1) {  // the right half is one candidate
      second = right ? a1 : (cand_before(b1, a2) ? b1 : a2);
    } else {
      second = right ? (cand_before(b2, a1) ? b2 : a1) : (cand_before(b1, a2) ? b1 : a2);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(MERGE_ROWS)
merge_top2_kernel(MergeShards shards, int B, int step, int major_req, int minor_req,
                  int4* __restrict__ gp, uint8_t* __restrict__ ok) {
  const int b = blockIdx.x * MERGE_ROWS + threadIdx.x;
  // x[s] is shard s's first entry, x[S + s] its second: the order of
  // [c1 of 0..S-1, c2 of 0..S-1]
  Cand x[2 * S];
  if (b >= B) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int2* r = shards.rows[s] + 3LL * b;
    const int2 x0 = __ldg(r), x1 = __ldg(r + 1), x2 = __ldg(r + 2);
    x[s] = Cand{x0.x, x0.y, x1.x};
    x[S + s] = Cand{x1.y, x2.x, x2.y};
  }
  Cand g1, g2;
  top2<0, 2 * S>(x, g1, g2);
  gp[b] = make_int4(g1.h, g1.l, g2.h, g2.l);
  ok[b] = (max(g1.c, 0) * step >= major_req) && (max(g2.c, 0) * step >= minor_req);
}

// The counts-mode vote of a device's shards in one launch (genefuserust_tpu/
// parallel/sharded_index.py per_shard's top2_votes, :209-215, run for every
// shard of a device as one shard_map program runs them).
//
// What bounds it: bytes, but far below them, launches. At the sharded
// scan's call of 4 shards x 8,192 rows of 105 samples the rows' own
// samples are 12.8 MB (0.0038 ms at 3.35 TB/s); one shard's launch has
// 1,024 blocks of 8 warps, so four launches back to back each fill the
// card and drain it again. Here one launch takes the shards on its grid's
// y axis (a block's 8 warps take 8 rows of one shard, so the block path's
// barrier and the shard's parameters stay uniform in a block), runs
// vote_kernel's body (vote_rows: warp path, block path, wide list), and
// writes each shard's rows into its slice of one (S, B, 6) tensor, where
// merge_top2_kernel reads them. The wide list holds s * B + b, a row's
// shard and row, for all the shards, so one vote_shards_wide_kernel launch
// (vote_wide_kernel's body, vote_wide_rows) takes every long row of the
// device, and the count of keys past shared memory is one read for all of
// them. On an H100 80GB HBM3 (700 W) the one launch takes 0.038 ms of that
// call where the four took 0.055.
struct VoteShards {
  const int2* pr[MAX_SHARDS];
  const int32_t* dupes[MAX_SHARDS];
  int dstride[MAX_SHARDS];
  int D[MAX_SHARDS];
  int cbits[MAX_SHARDS];
  int pos_bias[MAX_SHARDS];
};

// shard s's rows, their votes at out + 6 s B; selected with constant
// indexes so that the table stays in the parameter bank
__device__ __forceinline__ VoteRows shard_rows(const VoteShards& t, int s, int B, int32_t* out) {
  int32_t* o = out + (long long)s * B * 6;
  VoteRows v{t.pr[0], t.dupes[0], t.dstride[0], t.D[0], t.cbits[0], t.pos_bias[0], o};
#pragma unroll
  for (int q = 1; q < MAX_SHARDS; ++q)
    if (q == s)
      v = VoteRows{t.pr[q], t.dupes[q], t.dstride[q], t.D[q], t.cbits[q], t.pos_bias[q], o};
  return v;
}

// vote_rows in counts mode for shard blockIdx.y; out (S, B, 6); wide
// entries s * B + b (a (3 + 3 S B) list)
__global__ void __launch_bounds__(VOTE_THREADS, VOTE_MIN_BLOCKS)
vote_shards_kernel(const VoteShards shards, int B, int NS, const int32_t* __restrict__ lengths,
                   bool split, int step, long long* __restrict__ wide,
                   int32_t* __restrict__ out) {
  const int s = blockIdx.y;
  vote_rows(shard_rows(shards, s, B, out), B, NS, lengths, split, step, 0, 0, true, wide,
            (long long)s * B, nullptr);
}

// The shards' rows: entry e = s * B + b is row b of shard s.
struct ShardTables {
  const VoteShards& t;
  int B;
  int32_t* out;
  __device__ __forceinline__ VoteRows at(long long& e, int& b) const {
    const int s = (int)(e / B);
    b = (int)(e - (long long)s * B);
    return shard_rows(t, s, B, out);
  }
};

// vote_wide_rows in counts mode over vote_shards_kernel's list of N = S B
// entries
__global__ void __launch_bounds__(VOTE_WIDE_THREADS)
vote_shards_wide_kernel(const VoteShards shards, int B, int N, int NS,
                        const int32_t* __restrict__ lengths, bool split, int step,
                        long long* __restrict__ wide, long long* __restrict__ scratch,
                        int keys_cap, bool global_pass, int32_t* __restrict__ out) {
  vote_wide_rows(ShardTables{shards, B, out}, N, NS, lengths, split, step, 0, 0, true, wide,
                 scratch, keys_cap, global_pass);
}

}  // namespace gf

// pr: (B, NS, 2) int32 pass-1 probe results (sample s at k-mer s*step).
// lengths: NULL, or (B,) int32 lengths of the code rows the results came
// from (a row's samples past its length are then skipped: the probe gives
// them EMPTY). dupes: split (nd, D, 2) pairs / kv (nd, 8) payloads, row
// stride dstride. out: (B, 5) int32 [ok, h1, l1, h2, l2], or with counts
// (B, 6) int32 [c1, h1, l1, c2, h2, l2]. P2: power of two >= NS*D, the
// block-wide path's key buffer. wide: NULL, or the wide path's list, a
// (3 + 3B) int64 tensor whose first three entries are zero, that the rows
// past the warp path go to for gf_vote_wide (needed when P2 >
// MAX_BLOCK_KEYS: the block path's keys would not fit in shared memory).
// stats: NULL, or VOTE_STAT_SLOTS uint64 slots that the launch adds its
// counts to: the low 32 bits the rows voted on the warp path, the high 32
// bits those of them that it sorted (vote_rows).
extern "C" int gf_vote(const void* pr, int B, int NS, const void* lengths, const void* dupes,
                       int dstride, int D, int split, int cbits, int pos_bias, int step,
                       int major_req, int minor_req, int P2, int counts, void* wide, void* out,
                       void* stats, void* stream) {
  if (wide == nullptr && P2 > gf::MAX_BLOCK_KEYS) return (int)cudaErrorInvalidValue;
  const size_t warp_keys = (size_t)gf::VOTE_WARPS * gf::WARP_CAP;
  const size_t n_keys = wide == nullptr && (size_t)P2 > warp_keys ? (size_t)P2 : warp_keys;
  const size_t smem = n_keys * sizeof(long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf::vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + gf::VOTE_WARPS - 1) / gf::VOTE_WARPS;
  gf::vote_kernel<<<grid, gf::VOTE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pr, B, NS, (const int32_t*)lengths, (const int32_t*)dupes, dstride, D,
      split != 0, cbits, pos_bias, step, major_req, minor_req, counts != 0, (long long*)wide,
      (int32_t*)out, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// The rows gf_vote listed in `wide`, with as many 1,024-thread blocks as
// are resident at once (at most B). First pass (global_pass 0, scratch
// NULL): a row of at most keys_cap (<= VOTE_SMEM_KEYS) valid keys is
// voted with its keys in shared memory; a longer one is listed again and
// its keys counted into list[1]. Second pass (global_pass 1, only when
// list[1] > 0): those rows, their keys in `scratch` (list[1] int64). Other
// arguments as gf_vote's, the same lengths in both passes.
extern "C" int gf_vote_wide(const void* pr, int B, int NS, const void* lengths,
                            const void* dupes, int dstride, int D, int split, int cbits,
                            int pos_bias, int step, int major_req, int minor_req, int counts,
                            void* wide, void* scratch, int keys_cap, int global_pass, void* out,
                            void* stream) {
  if (B < 1 || keys_cap < 1 || keys_cap > gf::VOTE_SMEM_KEYS ||
      (global_pass != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      global_pass ? 0
                  : (size_t)std::min<long long>(keys_cap, (long long)NS * D) * sizeof(long long);
  cudaError_t e = cudaFuncSetAttribute(gf::vote_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf::vote_wide_kernel,
                                                         gf::VOTE_WIDE_THREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = std::min(B, sms * per_sm);
  gf::vote_wide_kernel<<<grid, gf::VOTE_WIDE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pr, B, NS, (const int32_t*)lengths, (const int32_t*)dupes, dstride, D,
      split != 0, cbits, pos_bias, step, major_req, minor_req, counts != 0, (long long*)wide,
      (long long*)scratch, keys_cap, global_pass != 0, (int32_t*)out);
  return (int)cudaGetLastError();
}

// rows: S host entries, the pointers of the shards' (B, 6) int32
// counts-mode rows (8-byte aligned), passed by value; gp: (B, 4) int32
// [h1, l1, h2, l2] of the merged top two (16-byte aligned); ok: (B,)
// bytes, c1 * step >= major_req && c2 * step >= minor_req on the merged
// counts (a count below 0 as 0).
extern "C" int gf_merge_top2(int S, const long long* rows, int B, int step, int major_req,
                             int minor_req, void* gp, void* ok, void* stream) {
  if (S < 1 || S > gf::MAX_SHARDS || B < 0 || (uintptr_t)gp % 16)
    return (int)cudaErrorInvalidValue;
  gf::MergeShards shards{};
  for (int s = 0; s < S; ++s) {
    if (rows[s] % 8) return (int)cudaErrorInvalidValue;
    shards.rows[s] = (const int2*)rows[s];
  }
  if (B == 0) return (int)cudaSuccess;
  const int grid = (B + gf::MERGE_ROWS - 1) / gf::MERGE_ROWS;
  cudaStream_t st = (cudaStream_t)stream;
  int4* g = (int4*)gp;
  uint8_t* o = (uint8_t*)ok;
  switch (S) {  // a kernel for each shard count: its candidates in registers
#define GF_MERGE(n)                                                                         \
  case n:                                                                                   \
    gf::merge_top2_kernel<n><<<grid, gf::MERGE_ROWS, 0, st>>>(shards, B, step, major_req, \
                                                              minor_req, g, o);             \
    break;
    GF_MERGE(1) GF_MERGE(2) GF_MERGE(3) GF_MERGE(4) GF_MERGE(5) GF_MERGE(6) GF_MERGE(7)
    GF_MERGE(8)
#undef GF_MERGE
  }
  return (int)cudaGetLastError();
}

// The shards' table of gf_vote_shards / gf_vote_shards_wide from host
// arrays of S entries (1..MAX_SHARDS): each shard's (B, NS, 2) pass-1
// probe results and dupe table (device pointers), its dupe row stride,
// width D, cbits and pos_bias; -> false for a bad S.
static bool vote_shards_table(int S, const long long* prs, const long long* dupes,
                              const int* dstrides, const int* Ds, const int* cbits,
                              const int* pos_biases, gf::VoteShards& t, int& maxD) {
  if (S < 1 || S > gf::MAX_SHARDS) return false;
  t = gf::VoteShards{};
  maxD = 1;
  for (int s = 0; s < S; ++s) {
    t.pr[s] = (const int2*)prs[s];
    t.dupes[s] = (const int32_t*)dupes[s];
    t.dstride[s] = dstrides[s];
    t.D[s] = Ds[s];
    t.cbits[s] = cbits[s];
    t.pos_bias[s] = pos_biases[s];
    maxD = std::max(maxD, Ds[s]);
  }
  return true;
}

// The counts-mode vote of S shards of one table layout in one launch: out
// (S, B, 6) int32, shard s's [c1, h1, l1, c2, h2, l2] rows at out + 6 s B,
// each equal to gf_vote's in counts mode on that shard alone. lengths, P2
// (here the largest over the shards), step as gf_vote's; wide: NULL, or the
// shards' wide list, a (3 + 3 S B) int64 tensor whose first three entries
// are zero, whose entries are s * B + b, for gf_vote_shards_wide.
extern "C" int gf_vote_shards(int S, const long long* prs, const long long* dupes,
                              const int* dstrides, const int* Ds, const int* cbits,
                              const int* pos_biases, int split, int B, int NS,
                              const void* lengths, int step, int P2, void* wide, void* out,
                              void* stream) {
  gf::VoteShards t;
  int maxD;
  if (!vote_shards_table(S, prs, dupes, dstrides, Ds, cbits, pos_biases, t, maxD) || B < 0 ||
      (wide == nullptr && P2 > gf::MAX_BLOCK_KEYS))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t warp_keys = (size_t)gf::VOTE_WARPS * gf::WARP_CAP;
  const size_t n_keys = wide == nullptr && (size_t)P2 > warp_keys ? (size_t)P2 : warp_keys;
  const size_t smem = n_keys * sizeof(long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf::vote_shards_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + gf::VOTE_WARPS - 1) / gf::VOTE_WARPS, S);
  gf::vote_shards_kernel<<<grid, gf::VOTE_THREADS, smem, (cudaStream_t)stream>>>(
      t, B, NS, (const int32_t*)lengths, split != 0, step, (long long*)wide, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The rows gf_vote_shards listed in `wide`, as gf_vote_wide's two passes
// (keys_cap, scratch, global_pass as there); the shards' table and out as
// gf_vote_shards'.
extern "C" int gf_vote_shards_wide(int S, const long long* prs, const long long* dupes,
                                   const int* dstrides, const int* Ds, const int* cbits,
                                   const int* pos_biases, int split, int B, int NS,
                                   const void* lengths, int step, void* wide, void* scratch,
                                   int keys_cap, int global_pass, void* out, void* stream) {
  gf::VoteShards t;
  int maxD;
  if (!vote_shards_table(S, prs, dupes, dstrides, Ds, cbits, pos_biases, t, maxD) || B < 1 ||
      keys_cap < 1 || keys_cap > gf::VOTE_SMEM_KEYS || (global_pass != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      global_pass ? 0
                  : (size_t)std::min<long long>(keys_cap, (long long)NS * maxD) * sizeof(long long);
  cudaError_t e = cudaFuncSetAttribute(gf::vote_shards_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf::vote_shards_wide_kernel,
                                                         gf::VOTE_WIDE_THREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int N = S * B;
  const int grid = std::min(N, sms * per_sm);
  gf::vote_shards_wide_kernel<<<grid, gf::VOTE_WIDE_THREADS, smem, (cudaStream_t)stream>>>(
      t, B, N, NS, (const int32_t*)lengths, split != 0, step, (long long*)wide,
      (long long*)scratch, keys_cap, global_pass != 0, (int32_t*)out);
  return (int)cudaGetLastError();
}
