// Kernel 3: pass-2 mask and segments, one warp per vote survivor.
//
// Replaces the XLA-jitted pass 2 of the TPU scan, genefuserust_tpu/ops/
// map_read.py map_read_pass2 after the probe: the per-candidate flags
// (3 within +-1 of the top gplong, else 2 within +-1 of the second;
// _eq_pm1), their max over the dupe slots, the 16-wide window max into a
// per-base mask, the mismatch count and extract_segments for targets 3
// and 2. On the TPU this stage was jnp (cummax/cummin scans); the TPU's
// only Pallas kernel is the probe (probe.cu).
//
// What bounds it on the H100: not bytes (a survivor reads one contiguous
// (NK, 2) probe row plus the dupe rows it names, a few KB) and not
// operations, but one launch plus a chain of two dependent global loads
// (the probe row, then the dupe rows its DUPE entries name), followed by
// a few hundred dependent integer steps per read.
//
// What the design does about it: one warp per survivor, several a block,
// no __syncthreads. The flags are ballots, one lane per k-mer in chunks of
// 32, with MASK_GROUP chunks' probe-row loads and then their dupe-row
// loads (a kv dupe row is two 16-byte loads) issued before any compare.
// Every later step runs on 32-bit words of per-base bits (bit j of word w
// is base 32w + j), one lane per word: the 16-wide window is four
// shift-ORs of (this word, previous word); mask 3 is M3, mask 2 is
// M2 & ~M3; the mismatches are popcounts. extract_segments' chain rules
// become ALLOWED_GAP shift steps on two words (linked: an ok base at most
// ALLOWED_GAP before with no blocked base between; a chain ends where the
// next ok base is not linked), chain heads are carried by a warp
// max-scan, and the first longest chain is one warp max over keys packed
// as (length + 1) << 16 | (0xFFFF - end). tests/test_torch_map_read.py
// mirrors these steps (_kernel_mask_segments) and holds them to JAX.
//
// Rows wider than MASK_MAX_L bases take the wide launch (WIDE): chain keys
// are 64-bit, (length + 1) << 32 | (0xFFFFFFFF - end). A batch holding one
// long read pads every row to it, so what bounds the wide launch is the
// rows' own lengths: a 150-base row of a 70,016-base batch needs 5 of its
// 2,188 words, and a long row is serial work for one warp. The design:
//   - every loop of a row stops at its own last word, ceil(min(len, L) /
//     32) (the words past it hold no in-bounds base), so a short row costs
//     what it costs on the narrow launch;
//   - a block is MASK_WIDE_WARPS warps, a row a warp; a row of at most
//     MASK_WARP_WORDS words (2,048 bases) keeps its words in its warp's
//     slice of shared memory and runs the narrow steps;
//   - a longer row is taken by the whole block after its warps' rows: the
//     flag chunks spread over the warps (raw ballots into shared memory,
//     then the window a word a thread, so neighbour words cross warp
//     ranges after a barrier), then linked and chain ends a word a
//     thread, the chain heads carried across warps and rounds by a block
//     exclusive max-scan, the longest chains and the mismatch count by
//     block reductions. Its words stay in shared memory up to the cap
//     (224 KB: 14,336 words, 458,752 bases) and go to a global slice of
//     the block's only past it.
//
// The contig-sharded index (parallel/sharded_index.py) splits the kernel
// at its flags: shard_flags_kernel ORs the per-k-mer flags of a device's
// shards into two bit planes a 32-k-mer word (flag 3; flag >= 2), which
// is the max of the flags over the shards (genefuserust_tpu/parallel/
// sharded_index.py build_sharded_map_read, the pmax before the window),
// and mask_from_flags_kernel runs everything after the ballots on those
// words: the window, the mismatch count and the chains.
//
// What bounds the shard flags: bytes, the shards' probe results of the
// rows' own k-mers (at most ~55 MB for a call of 8,192 rows of width 224
// over 4 shards). The design: one launch over a device's shards (a by-value
// table), a warp a row and span of 32 words, each row's loads stopping at
// its own last k-mer, the OR over the shards in registers and each word
// stored once, so no zero-fill and no read-modify-write. What bounds mask
// from flags on short rows: the instructions the warps start (a few
// hundred dependent steps a row, under 1 MB of words), so the narrow
// launch puts a row on a segment of 8 or 16 lanes when its words fit, 4
// or 2 rows a warp, with neighbour words by segment shuffles and no
// shared memory.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace gf {

constexpr int MASK_WARPS = 4;  // survivors a block
constexpr int MASK_GROUP = 4;  // chunks of 32 k-mers whose loads go out together
constexpr int MASK_MAX_L = 0xFFFF;  // a chain end is kept in 16 bits (WIDE: 32)
constexpr uint32_t FULL = 0xFFFFFFFFu;

// word w's bits of the bases t < lim
__device__ __forceinline__ uint32_t below(int w, int lim) {
  const int lo = 32 * w;
  if (lim >= lo + 32) return FULL;
  return lim > lo ? (1u << (lim - lo)) - 1u : 0u;
}

// base t is set when one of the 16 k-mers t-15..t is: (this, previous)
// k-mer words -> this mask word
__device__ __forceinline__ uint32_t window16(uint32_t f, uint32_t pf) {
  uint64_t v = ((uint64_t)f << 32) | pf;
  v |= v << 1;
  v |= v << 2;
  v |= v << 4;
  v |= v << 8;
  return (uint32_t)(v >> 32);
}

// this word's ok bases with an ok base at most ALLOWED_GAP before and no
// blocked base between, from (this, previous) words
__device__ __forceinline__ uint32_t linked(uint32_t ok, uint32_t pok, uint32_t blk,
                                           uint32_t pblk) {
  const uint64_t o = ((uint64_t)ok << 32) | pok, b = ((uint64_t)blk << 32) | pblk;
  uint64_t z = 0;
#pragma unroll
  for (int s = 0; s < ALLOWED_GAP; ++s) z = (o | (z & ~b)) << 1;
  return ok & (uint32_t)(z >> 32);
}

// this word's bases whose next ok base is linked, from (this, next) words
__device__ __forceinline__ uint32_t next_linked(uint32_t lk, uint32_t nlk, uint32_t ok,
                                                uint32_t nok) {
  const uint64_t l = ((uint64_t)nlk << 32) | lk, o = ((uint64_t)nok << 32) | ok;
  uint64_t n = 0;
#pragma unroll
  for (int s = 0; s < ALLOWED_GAP; ++s) n = (l | (n & ~o)) >> 1;
  return (uint32_t)n;
}

// a candidate's flag: |key - g| <= 1 in exact i64 (keys and tops are >= 0)
__device__ __forceinline__ int match(long long key, long long g1, long long g2) {
  if ((unsigned long long)(key - g1 + 1) <= 2ULL) return 3;
  if ((unsigned long long)(key - g2 + 1) <= 2ULL) return 2;
  return 0;
}

template <bool SPLIT>
struct DupeRow;

// kv: a row of 8 packed payloads, the first D read; two 16-byte loads
template <>
struct DupeRow<false> {
  int4 lo, hi;
  __device__ __forceinline__ void load(const int32_t* __restrict__ dupes, int row, int dstride,
                                       int) {
    const int4* p = reinterpret_cast<const int4*>(dupes + (size_t)row * dstride);
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }
  __device__ __forceinline__ int flag(int i, long long g1, long long g2, int D, int cbits,
                                      int pos_bias) const {
    const int32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int f = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d >= D) break;
      int32_t cc, cp;
      decode((uint32_t)v[d], cbits, pos_bias, cc, cp);
      if (cc >= 0) f = max(f, match(gplong(cc, cp, i), g1, g2));
    }
    return f;
  }
};

// split: D (contig, pos) pairs, EMPTY-padded; the first 8 loaded ahead
template <>
struct DupeRow<true> {
  const int2* row;
  int2 p[8];
  __device__ __forceinline__ void load(const int32_t* __restrict__ dupes, int r, int dstride,
                                       int D) {
    row = reinterpret_cast<const int2*>(dupes + (size_t)r * dstride);
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (d < D) p[d] = __ldg(row + d);
  }
  __device__ __forceinline__ int flag(int i, long long g1, long long g2, int D, int,
                                      int) const {
    int f = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (d < D && p[d].x != EMPTY) f = max(f, match(gplong(p[d].x, p[d].y, i), g1, g2));
    for (int d = 8; d < D; ++d) {
      const int2 q = __ldg(row + d);
      if (q.x != EMPTY) f = max(f, match(gplong(q.x, q.y, i), g1, g2));
    }
    return f;
  }
};

// A chain key: (length + 1, max end - end) packed in 32 bits, or in 64
// for WIDE rows; the larger key is the longer chain, then the earlier.
template <bool WIDE>
using chain_t = std::conditional_t<WIDE, unsigned long long, uint32_t>;

template <bool WIDE>
__device__ __forceinline__ chain_t<WIDE> pack_chain(int head, int end) {
  if constexpr (WIDE)
    return ((unsigned long long)(end - head + 1) << 32) | (0xFFFFFFFFu - (uint32_t)end);
  else
    return ((uint32_t)(end - head + 1) << 16) | (uint32_t)(0xFFFF - end);
}

template <bool WIDE>
__device__ __forceinline__ chain_t<WIDE> warp_max_chain(chain_t<WIDE> k) {
  if constexpr (WIDE) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) k = max(k, __shfl_xor_sync(FULL, k, o));
    return k;
  } else {
    return __reduce_max_sync(FULL, k);
  }
}

// The best chain key of one chunk of 32 words (one a lane): each chain
// end's head is the last head at or before it, in the word or carried by
// a max-scan over the lanes; `carry` is the last head before the chunk
// and becomes the last head through it.
template <bool WIDE>
__device__ __forceinline__ chain_t<WIDE> chain_key(int w, uint32_t hd, uint32_t e, int& carry,
                                                   int lane) {
  int scan = hd ? 32 * w + 31 - __clz(hd) : -1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, scan, o);
    if (lane >= o) scan = max(scan, v);
  }
  const int up = __shfl_up_sync(FULL, scan, 1);
  const int before = max(carry, lane ? up : -1);
  carry = max(carry, __shfl_sync(FULL, scan, 31));
  chain_t<WIDE> key = 0;
  while (e) {
    const int bit = __ffs(e) - 1;
    e &= e - 1;
    const uint32_t hb = hd & (FULL >> (31 - bit));
    const int head = hb ? 32 * w + 31 - __clz(hb) : before;
    key = max(key, pack_chain<WIDE>(head, 32 * w + bit));
  }
  return warp_max_chain<WIDE>(key);
}

template <bool WIDE>
__device__ __forceinline__ void segment(chain_t<WIDE> key, int32_t& valid, int32_t& start,
                                        int32_t& end) {
  if (key == 0) {  // no chain: JAX's argmax of all -1 gives (start -1, end 0)
    valid = 0;
    start = -1;
    end = 0;
    return;
  }
  constexpr int SH = WIDE ? 32 : 16;
  constexpr chain_t<WIDE> MAXE = WIDE ? 0xFFFFFFFFull : 0xFFFFu;
  const int n = (int)(key >> SH) - 1;
  end = (int)(MAXE - (key & MAXE));
  start = end - n;
  valid = n > THRESHOLD_LEN;
}

// A warp's four word arrays of nw words each: mask 3, mask >= 2, linked
// bases of targets 3 and 2, in its slice of shared memory. The narrow
// mask_segments_kernel runs with WIDE = false and scratch NULL only (the
// wide launch has kernels of its own); it keeps the parameter list it had
// when it also served wide rows, because dropping the unused template and
// pointer changes its machine code (cuobjdump -sass), and its time is
// held to the earlier build's.
template <bool WIDE>
__device__ __forceinline__ uint32_t* warp_words(uint32_t* smem, uint32_t* scratch, int warp,
                                                int b, int nw) {
  return WIDE ? scratch + (size_t)b * 4 * nw : smem + (size_t)warp * 4 * nw;
}

// Everything after the mask words: linked bases, heads and chain ends of
// targets 3 and 2, the longest chains, the (10,) output row. m3/m2 hold
// the row's nw mask words; miss is its mismatch count.
template <bool WIDE>
__device__ __forceinline__ void segments_from_words(uint32_t* m3, int nw, int len, int lim,
                                                    int miss, int mismatch_thr, int32_t h1,
                                                    int32_t l1, int32_t h2, int32_t l2,
                                                    int lane, int32_t* __restrict__ o) {
  uint32_t* m2 = m3 + nw;
  uint32_t* lk3 = m2 + nw;
  uint32_t* lk2 = lk3 + nw;
  // linked bases: target 3 (ok = mask 3, nothing blocks) and target 2
  // (ok = mask 2, blocked = mask 3), from (this, previous) words
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + lane;
    if (w < nw) {
      const uint32_t a3 = m3[w] & below(w, lim), a2 = m2[w] & below(w, lim);
      const uint32_t p3 = w ? m3[w - 1] & below(w - 1, lim) : 0u;
      const uint32_t p2 = w ? m2[w - 1] & below(w - 1, lim) : 0u;
      lk3[w] = linked(a3, p3, 0u, 0u);
      lk2[w] = linked(a2 & ~a3, p2 & ~p3, a3, p3);
    }
  }
  __syncwarp();
  // heads (ok, not linked, before the last in-bounds base), chain ends
  // (member whose next ok base is not linked), the longest chains
  chain_t<WIDE> best3 = 0, best2 = 0;
  int carry3 = -1, carry2 = -1;
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + lane;
    uint32_t hd3 = 0, hd2 = 0, e3 = 0, e2 = 0;
    if (w < nw) {
      const bool more = w + 1 < nw;
      const uint32_t a3 = m3[w] & below(w, lim), a2 = m2[w] & below(w, lim);
      const uint32_t n3 = more ? m3[w + 1] & below(w + 1, lim) : 0u;
      const uint32_t n2 = more ? m2[w + 1] & below(w + 1, lim) : 0u;
      const uint32_t k3 = lk3[w], k2 = lk2[w];
      const uint32_t nk3 = more ? lk3[w + 1] : 0u, nk2 = more ? lk2[w + 1] : 0u;
      const uint32_t o2 = a2 & ~a3, no2 = n2 & ~n3, last = below(w, len - 1);
      hd3 = a3 & ~k3 & last;
      hd2 = o2 & ~k2 & last;
      e3 = (k3 | hd3) & ~next_linked(k3, nk3, a3, n3);
      e2 = (k2 | hd2) & ~next_linked(k2, nk2, o2, no2);
    }
    best3 = max(best3, chain_key<WIDE>(w, hd3, e3, carry3, lane));
    best2 = max(best2, chain_key<WIDE>(w, hd2, e2, carry2, lane));
  }
  if (lane == 0) {
    int32_t v3, s3, x3, v2, s2, x2;
    segment<WIDE>(best3, v3, s3, x3);
    segment<WIDE>(best2, v2, s2, x2);
    const int32_t ok = miss <= mismatch_thr;
    o[0] = v3 & ok;
    o[1] = v2 & ok;
    o[2] = s3;
    o[3] = s2;
    o[4] = x3;
    o[5] = x2;
    o[6] = h1;
    o[7] = h2;
    o[8] = l1;
    o[9] = l2;
  }
}

// A k-mer's flag from its probe result (and the dupe row it names).
template <bool SPLIT>
__device__ __forceinline__ int kmer_flag(int2 r, const DupeRow<SPLIT>& dr, int i, long long g1,
                                         long long g2, int D, int cbits, int pos_bias) {
  if (r.x >= 0) return match(gplong(r.x, r.y, i), g1, g2);
  if (r.x == DUPE && D > 1) return dr.flag(i, g1, g2, D, cbits, pos_bias);
  return 0;
}

template <bool SPLIT, bool WIDE>
__global__ void __launch_bounds__(32 * MASK_WARPS)
mask_segments_kernel(const int32_t* __restrict__ pr, const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ gp, int B, int NK,
                     const int32_t* __restrict__ dupes, int dstride, int D, int cbits,
                     int pos_bias, int mismatch_thr, uint32_t* __restrict__ scratch,
                     int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp: nothing below waits on the block
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  uint32_t* m3 = warp_words<WIDE>(smem, scratch, warp, b, nw);
  uint32_t* m2 = m3 + nw;
  const int len = __ldg(lengths + b);
  const int lim = min(len, L);
  const int32_t h1 = __ldg(gp + 4 * b), l1 = __ldg(gp + 4 * b + 1);
  const int32_t h2 = __ldg(gp + 4 * b + 2), l2 = __ldg(gp + 4 * b + 3);
  const long long g1 = gplong_hl(h1, l1), g2 = gplong_hl(h2, l2);
  const int2* row = reinterpret_cast<const int2*>(pr) + (size_t)b * NK;

  // flags -> mask words; chunk c of k-mers gives mask word c
  uint32_t pf3 = 0, pf2 = 0;
  int miss = 0;
  for (int c0 = 0; c0 < nw; c0 += MASK_GROUP) {
    int2 r[MASK_GROUP];
    DupeRow<SPLIT> dr[MASK_GROUP];
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int i = (c0 + j) * 32 + lane;
      r[j] = i < NK ? __ldg(row + i) : make_int2(EMPTY, 0);
    }
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j)
      if (r[j].x == DUPE && D > 1) dr[j].load(dupes, r[j].y, dstride, D);
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int c = c0 + j;
      if (c >= nw) break;
      const int f = kmer_flag<SPLIT>(r[j], dr[j], c * 32 + lane, g1, g2, D, cbits, pos_bias);
      const uint32_t f3 = __ballot_sync(FULL, f == 3), f2 = __ballot_sync(FULL, f >= 2);
      const uint32_t w3 = window16(f3, pf3), w2 = window16(f2, pf2);
      pf3 = f3;
      pf2 = f2;
      if (lane == 0) {
        m3[c] = w3;
        m2[c] = w2;
      }
      miss += __popc(~w2 & below(c, lim));
    }
  }
  __syncwarp();
  segments_from_words<WIDE>(m3, nw, len, lim, miss, mismatch_thr, h1, l1, h2, l2, lane,
                            out + (size_t)b * 10);
}

// ---------------- the sharded pass 2: shard flags, mask from flags ----------------

constexpr int MAX_FLAG_SHARDS = 8;  // shards one shard_flags launch takes
constexpr int FLAGS_WARPS = 4;      // rows a block of shard_flags (a row a warp)
constexpr int FLAGS_SPAN = 32;      // words of a row a warp takes: its chunks, one word a lane

// A shard_flags launch's shards, by value: each one's stride-1 probe
// results (B, NK) and its dupe table with its parameters.
struct FlagShards {
  const int2* pr[MAX_FLAG_SHARDS];
  const int32_t* dupes[MAX_FLAG_SHARDS];
  int dstride[MAX_FLAG_SHARDS];
  int D[MAX_FLAG_SHARDS];
  int cbits[MAX_FLAG_SHARDS];
  int pos_bias[MAX_FLAG_SHARDS];
  int n;
};

// Shard s of the table, selected with constant indexes (an unrolled scan),
// so that the table stays in the parameter bank.
struct FlagShard {
  const int2* pr;
  const int32_t* dupes;
  int dstride, D, cbits, pos_bias;
};

__device__ __forceinline__ FlagShard flag_shard(const FlagShards& t, int s) {
  FlagShard f{t.pr[0], t.dupes[0], t.dstride[0], t.D[0], t.cbits[0], t.pos_bias[0]};
#pragma unroll
  for (int q = 1; q < MAX_FLAG_SHARDS; ++q)
    if (q == s) f = FlagShard{t.pr[q], t.dupes[q], t.dstride[q], t.D[q], t.cbits[q], t.pos_bias[q]};
  return f;
}

// The shards' flags ORed into words (B, nw, 2) [flag 3 bits, flag >= 2
// bits], bit j of word c = k-mer 32c + j: the max of the flags over the
// shards. A warp takes words [FLAGS_SPAN * blockIdx.y, + FLAGS_SPAN) of
// row b, a word a lane. Only the row's own k-mers, those below len - 15, are loaded
// and flagged: the probe writes EMPTY for every later one, which flags
// nothing. For each shard, MASK_GROUP chunks' probe loads and then their
// dupe-row loads go out before any compare, as in mask_segments_kernel;
// the row's keys are read once. The OR over the shards stays in the
// lanes' registers; then each lane stores its word once (`accumulate` 0:
// every word of the span, zero past the row's own k-mers) or ORs it into
// the stored word (`accumulate` 1: a later group of shards, the row's own
// words only).
template <bool SPLIT>
__global__ void __launch_bounds__(32 * FLAGS_WARPS)
shard_flags_kernel(const FlagShards shards, const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ gp, int B, int NK, int accumulate,
                   uint2* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * FLAGS_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  const int c0 = blockIdx.y * FLAGS_SPAN;
  const int nk = max(0, min(__ldg(lengths + b), L) - (KMER - 1));  // the row's own k-mers
  const int ce = min(c0 + FLAGS_SPAN, (nk + 31) >> 5);  // past the span's last own chunk
  uint32_t a3 = 0, a2 = 0;
  if (ce > c0) {
    const long long g1 = gplong_hl(__ldg(gp + 4 * b), __ldg(gp + 4 * b + 1));
    const long long g2 = gplong_hl(__ldg(gp + 4 * b + 2), __ldg(gp + 4 * b + 3));
    for (int s = 0; s < shards.n; ++s) {
      const FlagShard sh = flag_shard(shards, s);
      const int2* row = sh.pr + (size_t)b * NK;
      for (int c = c0; c < ce; c += MASK_GROUP) {
        int2 r[MASK_GROUP];
        DupeRow<SPLIT> dr[MASK_GROUP];
#pragma unroll
        for (int j = 0; j < MASK_GROUP; ++j) {
          const int i = (c + j) * 32 + lane;
          r[j] = i < nk ? __ldg(row + i) : make_int2(EMPTY, 0);
        }
#pragma unroll
        for (int j = 0; j < MASK_GROUP; ++j)
          if (r[j].x == DUPE && sh.D > 1) dr[j].load(sh.dupes, r[j].y, sh.dstride, sh.D);
#pragma unroll
        for (int j = 0; j < MASK_GROUP; ++j) {
          if (c + j >= ce) break;
          const int f = kmer_flag<SPLIT>(r[j], dr[j], (c + j) * 32 + lane, g1, g2, sh.D,
                                         sh.cbits, sh.pos_bias);
          const uint32_t f3 = __ballot_sync(FULL, f == 3), f2 = __ballot_sync(FULL, f >= 2);
          if (lane == c + j - c0) {
            a3 |= f3;
            a2 |= f2;
          }
        }
      }
    }
  }
  const int w = c0 + lane;
  uint2* out = words + (size_t)b * nw + w;
  if (!accumulate) {
    if (w < nw) *out = make_uint2(a3, a2);
  } else if (w < ce) {
    const uint2 v = *out;
    *out = make_uint2(v.x | a3, v.y | a2);
  }
}

// mask_from_flags' narrow launch: a row on a segment of SEG lanes (8, 16
// or 32, the least that holds the batch's nw words; 32 / SEG rows a warp),
// a word a lane, in rounds of SEG words up to the row's own last word
// (ceil(min(len, L) / 32); only SEG = 32 takes more than one round). No
// shared memory: a word's neighbours come by segment shuffles, a round's
// first and last lanes take them from the round before and after.

// A row's word on its lane: its flag words f3, f2, its in-bounds mask
// words a3 (mask 3) and a2 (mask >= 2), its linked bases k3, k2.
struct SegWord {
  uint32_t f3, f2, a3, a2, k3, k2;
};

// Word w of a row (a lane's): the window of (this, previous) flag words,
// its mismatches added to miss, and its linked bases from (this, previous)
// mask words. The previous word is the segment's previous lane's, or on
// the segment's first lane `prev`, the previous round's last word (zero
// before the first).
template <int SEG>
__device__ __forceinline__ SegWord seg_word(const uint2* __restrict__ row, int w, int nwr,
                                            int lim, int sl, const SegWord& prev, int& miss) {
  SegWord s;
  const uint2 f = w < nwr ? __ldg(row + w) : make_uint2(0u, 0u);
  s.f3 = f.x;
  s.f2 = f.y;
  uint32_t p3 = __shfl_up_sync(FULL, f.x, 1, SEG), p2 = __shfl_up_sync(FULL, f.y, 1, SEG);
  if (sl == 0) {
    p3 = prev.f3;
    p2 = prev.f2;
  }
  const uint32_t in = below(w, lim), m2 = window16(f.y, p2);
  s.a3 = window16(f.x, p3) & in;
  s.a2 = m2 & in;
  miss += __popc(~m2 & in);
  uint32_t q3 = __shfl_up_sync(FULL, s.a3, 1, SEG), q2 = __shfl_up_sync(FULL, s.a2, 1, SEG);
  if (sl == 0) {
    q3 = prev.a3;
    q2 = prev.a2;
  }
  s.k3 = linked(s.a3, q3, 0u, 0u);
  s.k2 = linked(s.a2 & ~s.a3, q2 & ~q3, s.a3, q3);
  return s;
}

// the segment's last lane's word, on every lane of the segment
template <int SEG>
__device__ __forceinline__ SegWord seg_last(const SegWord& s) {
  return SegWord{__shfl_sync(FULL, s.f3, SEG - 1, SEG), __shfl_sync(FULL, s.f2, SEG - 1, SEG),
                 __shfl_sync(FULL, s.a3, SEG - 1, SEG), __shfl_sync(FULL, s.a2, SEG - 1, SEG),
                 __shfl_sync(FULL, s.k3, SEG - 1, SEG), __shfl_sync(FULL, s.k2, SEG - 1, SEG)};
}

// the segment's next lane's value of v, or on its last lane `after`'s
// value on the segment's first lane (the next round's first word)
template <int SEG>
__device__ __forceinline__ uint32_t seg_next(uint32_t v, uint32_t after, int sl) {
  const uint32_t n = __shfl_down_sync(FULL, v, 1, SEG), a = __shfl_sync(FULL, after, 0, SEG);
  return sl == SEG - 1 ? a : n;
}

// The best chain key of word w's chain ends e (16-bit ends): each end's
// head is the last head at or before it, in the word or carried by a
// segmented max-scan over the round's lanes; `carry` is the last head
// before the round and becomes the last head through it. The key is the
// lane's own: the segment's best is taken once, after the last round.
template <int SEG>
__device__ __forceinline__ uint32_t seg_chain_key(int w, uint32_t hd, uint32_t e, int& carry,
                                                  int sl) {
  int scan = hd ? 32 * w + 31 - __clz(hd) : -1;
#pragma unroll
  for (int o = 1; o < SEG; o <<= 1) {
    const int v = __shfl_up_sync(FULL, scan, o, SEG);
    if (sl >= o) scan = max(scan, v);
  }
  const int up = __shfl_up_sync(FULL, scan, 1, SEG);
  const int before = max(carry, sl ? up : -1);
  carry = max(carry, __shfl_sync(FULL, scan, SEG - 1, SEG));
  uint32_t key = 0;
  while (e) {
    const int bit = __ffs(e) - 1;
    e &= e - 1;
    const uint32_t hb = hd & (FULL >> (31 - bit));
    const int head = hb ? 32 * w + 31 - __clz(hb) : before;
    key = max(key, pack_chain<false>(head, 32 * w + bit));
  }
  return key;
}

template <int SEG>
__device__ __forceinline__ uint32_t seg_max(uint32_t v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o, SEG));
  return v;
}

template <int SEG>
__device__ __forceinline__ int seg_sum(int v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, SEG);
  return v;
}

template <int SEG>
__global__ void __launch_bounds__(32 * MASK_WARPS)
mask_from_flags_kernel(const uint2* __restrict__ words, const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ gp, int B, int NK, int mismatch_thr,
                       int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, sl = lane & (SEG - 1);
  const int first = (blockIdx.x * MASK_WARPS + (threadIdx.x >> 5)) * (32 / SEG);
  if (first >= B) return;  // a whole warp
  const int b = first + lane / SEG;
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  const int len = b < B ? __ldg(lengths + b) : 0;
  const int lim = min(len, L), nwr = (lim + 31) >> 5;
  const uint2* row = words + (size_t)b * nw;  // read below nwr only (0 past B)
  const int rounds = SEG == 32 ? (nwr + 31) >> 5 : 1;  // SEG < 32: nwr <= nw <= SEG
  int miss = 0, carry3 = -1, carry2 = -1;
  uint32_t best3 = 0, best2 = 0;
  SegWord cur = seg_word<SEG>(row, sl, nwr, lim, sl, SegWord{}, miss);
  for (int r = 0; r < rounds; ++r) {
    const int w = r * SEG + sl;
    SegWord nxt{};
    if (r + 1 < rounds) nxt = seg_word<SEG>(row, w + SEG, nwr, lim, sl, seg_last<SEG>(cur), miss);
    // heads (ok, not linked, before the last in-bounds base), chain ends
    // (member whose next ok base is not linked), from (this, next) words
    const uint32_t n3 = seg_next<SEG>(cur.a3, nxt.a3, sl), n2 = seg_next<SEG>(cur.a2, nxt.a2, sl);
    const uint32_t nk3 = seg_next<SEG>(cur.k3, nxt.k3, sl);
    const uint32_t nk2 = seg_next<SEG>(cur.k2, nxt.k2, sl);
    const uint32_t o2 = cur.a2 & ~cur.a3, no2 = n2 & ~n3, last = below(w, len - 1);
    const uint32_t hd3 = cur.a3 & ~cur.k3 & last, hd2 = o2 & ~cur.k2 & last;
    const uint32_t e3 = (cur.k3 | hd3) & ~next_linked(cur.k3, nk3, cur.a3, n3);
    const uint32_t e2 = (cur.k2 | hd2) & ~next_linked(cur.k2, nk2, o2, no2);
    best3 = max(best3, seg_chain_key<SEG>(w, hd3, e3, carry3, sl));
    best2 = max(best2, seg_chain_key<SEG>(w, hd2, e2, carry2, sl));
    cur = nxt;
  }
  best3 = seg_max<SEG>(best3);
  best2 = seg_max<SEG>(best2);
  miss = seg_sum<SEG>(miss);
  if (sl == 0 && b < B) {
    int32_t v3, s3, x3, v2, s2, x2;
    segment<false>(best3, v3, s3, x3);
    segment<false>(best2, v2, s2, x2);
    const int32_t ok = miss <= mismatch_thr;
    int32_t* o = out + (size_t)b * 10;
    o[0] = v3 & ok;
    o[1] = v2 & ok;
    o[2] = s3;
    o[3] = s2;
    o[4] = x3;
    o[5] = x2;
    o[6] = __ldg(gp + 4 * b);
    o[7] = __ldg(gp + 4 * b + 2);
    o[8] = __ldg(gp + 4 * b + 1);
    o[9] = __ldg(gp + 4 * b + 3);
  }
}

// The segment of a narrow mask_from_flags launch: the least of 8, 16 and
// 32 lanes that holds a row's nw words.
inline int flags_segment(int NK) {
  const int nw = (NK + KMER - 1 + 31) / 32;
  return nw <= 8 ? 8 : nw <= 16 ? 16 : 32;
}

// ---------------- the wide launch: a row a warp, long rows a block ----------------

// The best chain key over word w's chain ends e: each end's head is the
// last head hd at or before it in the word, else `before` (the last head
// in an earlier word); 64-bit keys.
__device__ __forceinline__ unsigned long long word_chains(int w, uint32_t hd, uint32_t e,
                                                          int before) {
  unsigned long long key = 0;
  while (e) {
    const int bit = __ffs(e) - 1;
    e &= e - 1;
    const uint32_t hb = hd & (FULL >> (31 - bit));
    const int head = hb ? 32 * w + 31 - __clz(hb) : before;
    key = max(key, pack_chain<true>(head, 32 * w + bit));
  }
  return key;
}

// The (10,) output row from the two targets' best 64-bit chain keys.
__device__ __forceinline__ void write_segments(unsigned long long best3,
                                               unsigned long long best2, int miss,
                                               int mismatch_thr, int32_t h1, int32_t l1,
                                               int32_t h2, int32_t l2, int32_t* __restrict__ o) {
  int32_t v3, s3, x3, v2, s2, x2;
  segment<true>(best3, v3, s3, x3);
  segment<true>(best2, v2, s2, x2);
  const int32_t ok = miss <= mismatch_thr;
  o[0] = v3 & ok;
  o[1] = v2 & ok;
  o[2] = s3;
  o[3] = s2;
  o[4] = x3;
  o[5] = x2;
  o[6] = h1;
  o[7] = h2;
  o[8] = l1;
  o[9] = l2;
}

// linked bases of word w for targets 3 and 2 (ok = mask 3, nothing
// blocks; ok = mask 2, blocked = mask 3), from (this, previous) words
__device__ __forceinline__ void word_linked(const uint32_t* m3, const uint32_t* m2, int w,
                                            int lim, uint32_t& lk3, uint32_t& lk2) {
  const uint32_t a3 = m3[w] & below(w, lim), a2 = m2[w] & below(w, lim);
  const uint32_t p3 = w ? m3[w - 1] & below(w - 1, lim) : 0u;
  const uint32_t p2 = w ? m2[w - 1] & below(w - 1, lim) : 0u;
  lk3 = linked(a3, p3, 0u, 0u);
  lk2 = linked(a2 & ~a3, p2 & ~p3, a3, p3);
}

// heads (ok, not linked, before the last in-bounds base) and chain ends
// (member whose next ok base is not linked) of word w of nw, both targets
__device__ __forceinline__ void word_heads_ends(const uint32_t* m3, const uint32_t* m2,
                                                const uint32_t* lk3, const uint32_t* lk2,
                                                int w, int nw, int len, int lim, uint32_t& hd3,
                                                uint32_t& hd2, uint32_t& e3, uint32_t& e2) {
  const bool more = w + 1 < nw;
  const uint32_t a3 = m3[w] & below(w, lim), a2 = m2[w] & below(w, lim);
  const uint32_t n3 = more ? m3[w + 1] & below(w + 1, lim) : 0u;
  const uint32_t n2 = more ? m2[w + 1] & below(w + 1, lim) : 0u;
  const uint32_t k3 = lk3[w], k2 = lk2[w];
  const uint32_t nk3 = more ? lk3[w + 1] : 0u, nk2 = more ? lk2[w + 1] : 0u;
  const uint32_t o2 = a2 & ~a3, no2 = n2 & ~n3, last = below(w, len - 1);
  hd3 = a3 & ~k3 & last;
  hd2 = o2 & ~k2 & last;
  e3 = (k3 | hd3) & ~next_linked(k3, nk3, a3, n3);
  e2 = (k2 | hd2) & ~next_linked(k2, nk2, o2, no2);
}

// A short row of the wide launch by its warp, the narrow kernel's steps on
// the row's own nw words: its flags, mask words and chains, the words in
// m3 (four arrays of nw words: mask 3, mask >= 2, linked bases of targets
// 3 and 2).
template <bool SPLIT>
__device__ __forceinline__ void warp_mask_row(const int2* __restrict__ row, int NK, int nw,
                                              int len, int lim, const int32_t* __restrict__ gpb,
                                              const int32_t* __restrict__ dupes, int dstride,
                                              int D, int cbits, int pos_bias, int mismatch_thr,
                                              uint32_t* m3, int lane, int32_t* __restrict__ o) {
  uint32_t* m2 = m3 + nw;
  const int32_t h1 = __ldg(gpb), l1 = __ldg(gpb + 1);
  const int32_t h2 = __ldg(gpb + 2), l2 = __ldg(gpb + 3);
  const long long g1 = gplong_hl(h1, l1), g2 = gplong_hl(h2, l2);

  // flags -> mask words; chunk c of k-mers gives mask word c
  uint32_t pf3 = 0, pf2 = 0;
  int miss = 0;
  for (int c0 = 0; c0 < nw; c0 += MASK_GROUP) {
    int2 r[MASK_GROUP];
    DupeRow<SPLIT> dr[MASK_GROUP];
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int i = (c0 + j) * 32 + lane;
      r[j] = i < NK ? __ldg(row + i) : make_int2(EMPTY, 0);
    }
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j)
      if (r[j].x == DUPE && D > 1) dr[j].load(dupes, r[j].y, dstride, D);
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int c = c0 + j;
      if (c >= nw) break;
      const int f = kmer_flag<SPLIT>(r[j], dr[j], c * 32 + lane, g1, g2, D, cbits, pos_bias);
      const uint32_t f3 = __ballot_sync(FULL, f == 3), f2 = __ballot_sync(FULL, f >= 2);
      const uint32_t w3 = window16(f3, pf3), w2 = window16(f2, pf2);
      pf3 = f3;
      pf2 = f2;
      if (lane == 0) {
        m3[c] = w3;
        m2[c] = w2;
      }
      miss += __popc(~w2 & below(c, lim));
    }
  }
  __syncwarp();
  segments_from_words<true>(m3, nw, len, lim, miss, mismatch_thr, h1, l1, h2, l2, lane, o);
}

constexpr int MASK_WIDE_WARPS = 16;  // rows a block of the wide launch
constexpr int MASK_WARP_WORDS = 64;  // the longest row a warp takes there: 2,048 bases
constexpr int MASK_SMEM_CAP = 224 * 1024;  // a block's words in shared memory, at most

// The wide launch's static shared memory: the rows its block takes, and
// the block scans' and reductions' slots.
struct WideShared {
  int block_row[MASK_WIDE_WARPS];
  int sm[32];
  unsigned long long red[32];
};

__device__ __forceinline__ unsigned long long block_max_u64(unsigned long long v,
                                                            unsigned long long* red) {
  v = warp_max_chain<true>(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v = max(v, red[w]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* sm) {
  v = (int)__reduce_add_sync(FULL, (unsigned)v);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += sm[w];
  __syncthreads();
  return v;
}

// segments_from_words by the whole block, a word a thread: m3 holds the
// row's four arrays of nw words, the mask words written; miss is its
// mismatch count. The chain heads are carried across warps and rounds of
// blockDim.x words by block max-scans.
__device__ void block_segments(uint32_t* m3, int nw, int len, int lim, int miss,
                               int mismatch_thr, const int32_t* __restrict__ gpb,
                               WideShared& sh, int32_t* __restrict__ o) {
  uint32_t* m2 = m3 + nw;
  uint32_t* lk3 = m2 + nw;
  uint32_t* lk2 = lk3 + nw;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) word_linked(m3, m2, w, lim, lk3[w], lk2[w]);
  __syncthreads();
  unsigned long long best3 = 0, best2 = 0;
  int carry3 = -1, carry2 = -1;
  for (int w0 = 0; w0 < nw; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    uint32_t hd3 = 0, hd2 = 0, e3 = 0, e2 = 0;
    if (w < nw) word_heads_ends(m3, m2, lk3, lk2, w, nw, len, lim, hd3, hd2, e3, e2);
    int all3, all2;
    const int before3 = block_excl_max(hd3 ? 32 * w + 31 - __clz(hd3) : -1, sh.sm, all3);
    const int before2 = block_excl_max(hd2 ? 32 * w + 31 - __clz(hd2) : -1, sh.sm, all2);
    best3 = max(best3, word_chains(w, hd3, e3, max(carry3, before3)));
    best2 = max(best2, word_chains(w, hd2, e2, max(carry2, before2)));
    carry3 = max(carry3, all3);
    carry2 = max(carry2, all2);
  }
  best3 = block_max_u64(best3, sh.red);
  best2 = block_max_u64(best2, sh.red);
  if (threadIdx.x == 0)
    write_segments(best3, best2, miss, mismatch_thr, __ldg(gpb), __ldg(gpb + 1),
                         __ldg(gpb + 2), __ldg(gpb + 3), o);
  __syncthreads();  // the words and slots are the next row's
}

// A long row's flags and mask words by the whole block: each warp ballots
// a range of chunks of 32 k-mers into raw flag words (in the linked
// arrays' slots), then after a barrier each thread windows a word with its
// neighbour -> the mismatch count; then block_segments.
template <bool SPLIT>
__device__ void block_mask_row(const int2* __restrict__ row, int NK, int nw, int len, int lim,
                               const int32_t* __restrict__ gpb,
                               const int32_t* __restrict__ dupes, int dstride, int D,
                               int cbits, int pos_bias, int mismatch_thr, uint32_t* m3,
                               WideShared& sh, int32_t* __restrict__ o) {
  uint32_t* m2 = m3 + nw;
  uint32_t* f3 = m2 + nw;
  uint32_t* f2 = f3 + nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long g1 = gplong_hl(__ldg(gpb), __ldg(gpb + 1));
  const long long g2 = gplong_hl(__ldg(gpb + 2), __ldg(gpb + 3));
  const int per = (nw + warps - 1) / warps;
  const int cb = min(nw, warp * per), ce = min(nw, cb + per);
  for (int c0 = cb; c0 < ce; c0 += MASK_GROUP) {
    int2 r[MASK_GROUP];
    DupeRow<SPLIT> dr[MASK_GROUP];
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int i = (c0 + j) * 32 + lane;
      r[j] = c0 + j < ce && i < NK ? __ldg(row + i) : make_int2(EMPTY, 0);
    }
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j)
      if (r[j].x == DUPE && D > 1) dr[j].load(dupes, r[j].y, dstride, D);
#pragma unroll
    for (int j = 0; j < MASK_GROUP; ++j) {
      const int c = c0 + j;
      if (c >= ce) break;
      const int f = kmer_flag<SPLIT>(r[j], dr[j], c * 32 + lane, g1, g2, D, cbits, pos_bias);
      const uint32_t b3 = __ballot_sync(FULL, f == 3), b2 = __ballot_sync(FULL, f >= 2);
      if (lane == 0) {
        f3[c] = b3;
        f2[c] = b2;
      }
    }
  }
  __syncthreads();
  int miss = 0;
  for (int c = threadIdx.x; c < nw; c += blockDim.x) {
    const uint32_t w2 = window16(f2[c], c ? f2[c - 1] : 0u);
    m3[c] = window16(f3[c], c ? f3[c - 1] : 0u);
    m2[c] = w2;
    miss += __popc(~w2 & below(c, lim));
  }
  miss = block_sum(miss, sh.sm);  // its barriers also publish the mask words
  block_segments(m3, nw, len, lim, miss, mismatch_thr, gpb, sh, o);
}

// The wide launch's row split: row b's own words, and whether it is a
// block's row (past MASK_WARP_WORDS words) -> its words' address. Rows of
// a block's rows keep their words in shared memory when 4 * nwr words fit
// in the block's smem_words, else in the block's slice of `scratch`.
__device__ __forceinline__ uint32_t* block_words(uint32_t* smem, int smem_words,
                                                 uint32_t* scratch, int nw, int nwr) {
  return 4 * nwr <= smem_words ? smem : scratch + (size_t)blockIdx.x * 4 * nw;
}

template <bool SPLIT>
__global__ void __launch_bounds__(32 * MASK_WIDE_WARPS)
mask_segments_wide_kernel(const int32_t* __restrict__ pr, const int32_t* __restrict__ lengths,
                          const int32_t* __restrict__ gp, int B, int NK,
                          const int32_t* __restrict__ dupes, int dstride, int D, int cbits,
                          int pos_bias, int mismatch_thr, int smem_words,
                          uint32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ WideShared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * MASK_WIDE_WARPS + warp;
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  const int2* rows = reinterpret_cast<const int2*>(pr);
  const int len = b < B ? __ldg(lengths + b) : 0;
  const int nwr = (min(len, L) + 31) >> 5;
  const bool big = b < B && nwr > MASK_WARP_WORDS;
  if (b < B && !big)
    warp_mask_row<SPLIT>(rows + (size_t)b * NK, NK, nwr, len, min(len, L), gp + 4 * b,
                               dupes, dstride, D, cbits, pos_bias, mismatch_thr,
                               smem + (size_t)warp * 4 * MASK_WARP_WORDS, lane,
                               out + (size_t)b * 10);
  if (lane == 0) sh.block_row[warp] = big ? b : -1;
  if (!__syncthreads_or(big)) return;
  for (int w = 0; w < MASK_WIDE_WARPS; ++w) {
    const int rb = sh.block_row[w];
    if (rb < 0) continue;
    const int rlen = __ldg(lengths + rb), rlim = min(rlen, L), rnw = (rlim + 31) >> 5;
    block_mask_row<SPLIT>(rows + (size_t)rb * NK, NK, rnw, rlen, rlim, gp + 4 * rb, dupes,
                          dstride, D, cbits, pos_bias, mismatch_thr,
                          block_words(smem, smem_words, scratch, nw, rnw), sh,
                          out + (size_t)rb * 10);
  }
}

// A short row of mask_from_flags_wide_kernel by its warp: the window and
// the mismatch count one word a lane over the row's own nw words, then the
// same chains; `row` holds the padded row's words.
__device__ __forceinline__ void warp_flags_row(const uint2* __restrict__ row, int nw, int len,
                                               int lim, const int32_t* __restrict__ gpb,
                                               int mismatch_thr, uint32_t* m3, int lane,
                                               int32_t* __restrict__ o) {
  uint32_t* m2 = m3 + nw;
  int miss = 0;
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int c = w0 + lane;
    if (c < nw) {
      const uint2 f = __ldg(row + c), pf = c ? __ldg(row + c - 1) : make_uint2(0u, 0u);
      const uint32_t w2 = window16(f.y, pf.y);
      m3[c] = window16(f.x, pf.x);
      m2[c] = w2;
      miss += __popc(~w2 & below(c, lim));
    }
  }
  miss = (int)__reduce_add_sync(FULL, (unsigned)miss);
  __syncwarp();
  segments_from_words<true>(m3, nw, len, lim, miss, mismatch_thr, __ldg(gpb), __ldg(gpb + 1),
                            __ldg(gpb + 2), __ldg(gpb + 3), lane, o);
}

// mask_segments_wide_kernel from merged flag words: a row a warp, long
// rows a block (the window a word a thread, then block_segments).
__global__ void __launch_bounds__(32 * MASK_WIDE_WARPS)
mask_from_flags_wide_kernel(const uint2* __restrict__ words,
                            const int32_t* __restrict__ lengths, const int32_t* __restrict__ gp,
                            int B, int NK, int mismatch_thr, int smem_words,
                            uint32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ WideShared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * MASK_WIDE_WARPS + warp;
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  const int len = b < B ? __ldg(lengths + b) : 0;
  const int nwr = (min(len, L) + 31) >> 5;
  const bool big = b < B && nwr > MASK_WARP_WORDS;
  if (b < B && !big)
    warp_flags_row(words + (size_t)b * nw, nwr, len, min(len, L), gp + 4 * b,
                         mismatch_thr, smem + (size_t)warp * 4 * MASK_WARP_WORDS, lane,
                         out + (size_t)b * 10);
  if (lane == 0) sh.block_row[warp] = big ? b : -1;
  if (!__syncthreads_or(big)) return;
  for (int w = 0; w < MASK_WIDE_WARPS; ++w) {
    const int rb = sh.block_row[w];
    if (rb < 0) continue;
    const int rlen = __ldg(lengths + rb), rlim = min(rlen, L), rnw = (rlim + 31) >> 5;
    uint32_t* m3 = block_words(smem, smem_words, scratch, nw, rnw);
    uint32_t* m2 = m3 + rnw;
    const uint2* row = words + (size_t)rb * nw;
    int miss = 0;
    for (int c = threadIdx.x; c < rnw; c += blockDim.x) {
      const uint2 f = __ldg(row + c), pf = c ? __ldg(row + c - 1) : make_uint2(0u, 0u);
      const uint32_t w2 = window16(f.y, pf.y);
      m3[c] = window16(f.x, pf.x);
      m2[c] = w2;
      miss += __popc(~w2 & below(c, rlim));
    }
    miss = block_sum(miss, sh.sm);
    block_segments(m3, rnw, rlen, rlim, miss, mismatch_thr, gp + 4 * rb, sh,
                   out + (size_t)rb * 10);
  }
}

// Warps a block and dynamic shared memory of a narrow mask launch: the
// rows keep their words in shared memory, 16 bytes a mask word.
struct MaskLaunch {
  dim3 grid, block;
  size_t smem;
};

inline MaskLaunch mask_launch(int B, int NK) {
  const int nw = (NK + KMER - 1 + 31) / 32;
  const size_t warp_bytes = 16 * (size_t)nw;
  const int warps =
      (int)std::max<size_t>(1, std::min<size_t>(MASK_WARPS, 48 * 1024 / warp_bytes));
  return {dim3((B + warps - 1) / warps), dim3(32 * warps), warps * warp_bytes};
}

// The wide launch's shared memory: the warps' slices, or a long row's
// 16 bytes a word when they fit in `cap` bytes; a row past what the
// launch holds takes the block's slice of scratch (4 * nw words a block).
struct WideLaunch {
  dim3 grid, block;
  size_t smem;
  bool needs_scratch;
};

inline WideLaunch wide_launch(int B, int NK, int cap) {
  const size_t nw = (NK + KMER - 1 + 31) / 32;
  const size_t slices = (size_t)MASK_WIDE_WARPS * 16 * MASK_WARP_WORDS, row = 16 * nw;
  const size_t smem = row <= (size_t)cap ? std::max(slices, row) : slices;
  return {dim3((B + MASK_WIDE_WARPS - 1) / MASK_WIDE_WARPS), dim3(32 * MASK_WIDE_WARPS), smem,
          row > smem};
}

template <typename K>
inline cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace gf

// pr: (B, NK, 2) int32 full-stride probe results of the survivors' code
// rows (width L = NK + 15); gp: (B, 4) int32 [h1, l1, h2, l2] from the
// vote. out: (B, 10) int32 [valid0, valid1, start0, start1, end0, end1,
// h1, h2, l1, l2] (segment 0 = top target 3, 1 = second target 2). kv
// dupe rows (split == 0) are 8 payloads, 16-byte aligned. Rows wider than
// 65,535 bases take the wide launch: smem_cap (at most MASK_SMEM_CAP) is
// the shared memory a block may give a long row's words; scratch: NULL
// when 16 * ceil(L / 32) bytes fit in max(smem_cap, the warps' 16 KB),
// else ceil(B / MASK_WIDE_WARPS) * 4 * ceil(L / 32) uint32.
extern "C" int gf_mask_segments(const void* pr, const void* lengths, const void* gp,
                                int B, int NK, const void* dupes, int dstride, int D,
                                int split, int cbits, int pos_bias, int mismatch_thr,
                                int smem_cap, void* scratch, void* out, void* stream) {
  const bool wide = NK + gf::KMER - 1 > gf::MASK_MAX_L;
  if (B < 0 || NK < 1 || smem_cap < 0 || smem_cap > gf::MASK_SMEM_CAP)
    return (int)cudaErrorInvalidValue;
  if (!split && D > 1 && (D > 8 || dstride % 4 || dstride < 8 || (uintptr_t)dupes % 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  auto p = (const int32_t*)pr;
  auto n = (const int32_t*)lengths;
  auto g = (const int32_t*)gp;
  auto d = (const int32_t*)dupes;
  auto o = (int32_t*)out;
  if (!wide) {
    const gf::MaskLaunch m = gf::mask_launch(B, NK);
    auto kern = split ? gf::mask_segments_kernel<true, false> : gf::mask_segments_kernel<false, false>;
    kern<<<m.grid, m.block, m.smem, st>>>(p, n, g, B, NK, d, dstride, D, cbits, pos_bias,
                                          mismatch_thr, nullptr, o);
    return (int)cudaGetLastError();
  }
  const gf::WideLaunch m = gf::wide_launch(B, NK, smem_cap);
  if (m.needs_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto kern = split ? gf::mask_segments_wide_kernel<true> : gf::mask_segments_wide_kernel<false>;
  cudaError_t e = gf::allow_smem(kern, m.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<m.grid, m.block, m.smem, st>>>(p, n, g, B, NK, d, dstride, D, cbits, pos_bias,
                                        mismatch_thr, (int)(m.smem / 4), (uint32_t*)scratch, o);
  return (int)cudaGetLastError();
}

// The pass-2 flags of n (1..MAX_FLAG_SHARDS) shards in one launch. prs,
// dupes: host arrays of n device pointers, each shard's (B, NK, 2)
// stride-1 probe results and its dupe table; dstrides, Ds, cbits,
// pos_biases: host arrays of n; lengths (B,); gp (B, 4) the merged [h1,
// l1, h2, l2]. words (B, ceil((NK + 15) / 32), 2) uint32 [flag 3, flag >=
// 2]: every word stored (accumulate 0) or the rows' own words ORed into
// (accumulate 1, a later group of the same rows' shards).
extern "C" int gf_shard_flags(int n, const long long* prs, const long long* dupes,
                              const int* dstrides, const int* Ds, const int* cbits,
                              const int* pos_biases, int split, const void* lengths,
                              const void* gp, int B, int NK, int accumulate, void* words,
                              void* stream) {
  if (n < 1 || n > gf::MAX_FLAG_SHARDS || B < 0 || NK < 1) return (int)cudaErrorInvalidValue;
  gf::FlagShards t{};
  for (int s = 0; s < n; ++s) {
    if (!split && Ds[s] > 1 &&
        (Ds[s] > 8 || dstrides[s] % 4 || dstrides[s] < 8 || dupes[s] % 16))
      return (int)cudaErrorInvalidValue;
    t.pr[s] = (const int2*)prs[s];
    t.dupes[s] = (const int32_t*)dupes[s];
    t.dstride[s] = dstrides[s];
    t.D[s] = Ds[s];
    t.cbits[s] = cbits[s];
    t.pos_bias[s] = pos_biases[s];
  }
  t.n = n;
  if (B == 0) return (int)cudaSuccess;
  const int nw = (NK + gf::KMER - 1 + 31) / 32;
  const dim3 grid((B + gf::FLAGS_WARPS - 1) / gf::FLAGS_WARPS,
                  (nw + gf::FLAGS_SPAN - 1) / gf::FLAGS_SPAN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kern = split ? gf::shard_flags_kernel<true> : gf::shard_flags_kernel<false>;
  kern<<<grid, 32 * gf::FLAGS_WARPS, 0, (cudaStream_t)stream>>>(
      t, (const int32_t*)lengths, (const int32_t*)gp, B, NK, accumulate, (uint2*)words);
  return (int)cudaGetLastError();
}

// gf_mask_segments from merged flag words (B, ceil((NK + 15) / 32), 2):
// the same out rows; smem_cap and scratch as gf_mask_segments'.
extern "C" int gf_mask_from_flags(const void* words, const void* lengths, const void* gp,
                                  int B, int NK, int mismatch_thr, int smem_cap, void* scratch,
                                  void* out, void* stream) {
  const bool wide = NK + gf::KMER - 1 > gf::MASK_MAX_L;
  if (B < 0 || NK < 1 || smem_cap < 0 || smem_cap > gf::MASK_SMEM_CAP)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  auto w = (const uint2*)words;
  auto n = (const int32_t*)lengths;
  auto g = (const int32_t*)gp;
  auto o = (int32_t*)out;
  if (!wide) {
    const int seg = gf::flags_segment(NK), rows = gf::MASK_WARPS * 32 / seg;
    auto kern = seg == 8 ? gf::mask_from_flags_kernel<8>
                : seg == 16 ? gf::mask_from_flags_kernel<16> : gf::mask_from_flags_kernel<32>;
    kern<<<(B + rows - 1) / rows, 32 * gf::MASK_WARPS, 0, st>>>(w, n, g, B, NK, mismatch_thr, o);
    return (int)cudaGetLastError();
  }
  const gf::WideLaunch m = gf::wide_launch(B, NK, smem_cap);
  if (m.needs_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = gf::allow_smem(gf::mask_from_flags_wide_kernel, m.smem);
  if (e != cudaSuccess) return (int)e;
  gf::mask_from_flags_wide_kernel<<<m.grid, m.block, m.smem, st>>>(
      w, n, g, B, NK, mismatch_thr, (int)(m.smem / 4), (uint32_t*)scratch, o);
  return (int)cudaGetLastError();
}
