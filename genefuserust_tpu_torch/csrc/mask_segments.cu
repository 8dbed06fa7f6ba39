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
// Rows wider than MASK_MAX_L bases (WIDE): the keys are 64-bit, (length +
// 1) << 32 | (0xFFFFFFFF - end), and the warp's words live in a global
// scratch slice the wrapper allocates, since they may not fit in shared
// memory; every step is the same.
//
// The contig-sharded index (parallel/sharded_index.py) splits the kernel
// at its flags: shard_flags_kernel ORs each shard's per-k-mer flags into
// two bit planes a 32-k-mer word (flag 3; flag >= 2), which is the max of
// the flags over the shards (genefuserust_tpu/parallel/sharded_index.py
// build_sharded_map_read, the pmax before the window), and
// mask_from_flags_kernel runs everything after the ballots on those
// words: the window, the mismatch count and the chains.
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
// bases of targets 3 and 2. Shared memory, or (WIDE) the row's slice of
// global scratch.
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

// One shard's flags ORed into words (B, nw, 2) [flag 3 bits, flag >= 2
// bits], bit j of word c = k-mer 32c + j; one warp a (row, chunk of 32
// k-mers). Shards on one device run in stream order, so a plain
// read-modify-write by the chunk's warp is the OR.
template <bool SPLIT>
__global__ void __launch_bounds__(32 * MASK_WARPS)
shard_flags_kernel(const int32_t* __restrict__ pr, const int32_t* __restrict__ gp, int B,
                   int NK, const int32_t* __restrict__ dupes, int dstride, int D, int cbits,
                   int pos_bias, uint2* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int nkc = (NK + 31) >> 5, nw = (NK + KMER - 1 + 31) >> 5;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= (long long)B * nkc) return;
  const int b = (int)(item / nkc), c = (int)(item - (long long)b * nkc);
  const long long g1 = gplong_hl(__ldg(gp + 4 * b), __ldg(gp + 4 * b + 1));
  const long long g2 = gplong_hl(__ldg(gp + 4 * b + 2), __ldg(gp + 4 * b + 3));
  const int i = c * 32 + lane;
  const int2 r = i < NK ? __ldg(reinterpret_cast<const int2*>(pr) + (size_t)b * NK + i)
                        : make_int2(EMPTY, 0);
  DupeRow<SPLIT> dr;
  if (r.x == DUPE && D > 1) dr.load(dupes, r.y, dstride, D);
  const int f = kmer_flag<SPLIT>(r, dr, i, g1, g2, D, cbits, pos_bias);
  const uint32_t f3 = __ballot_sync(FULL, f == 3), f2 = __ballot_sync(FULL, f >= 2);
  if (lane == 0) {
    uint2* w = words + (size_t)b * nw + c;
    const uint2 v = *w;
    *w = make_uint2(v.x | f3, v.y | f2);
  }
}

// mask_segments_kernel from merged flag words (B, nw, 2): the window and
// the mismatch count one word a lane, then the same chains.
template <bool WIDE>
__global__ void __launch_bounds__(32 * MASK_WARPS)
mask_from_flags_kernel(const uint2* __restrict__ words, const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ gp, int B, int NK, int mismatch_thr,
                       uint32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  uint32_t* m3 = warp_words<WIDE>(smem, scratch, warp, b, nw);
  uint32_t* m2 = m3 + nw;
  const int len = __ldg(lengths + b);
  const int lim = min(len, L);
  const uint2* row = words + (size_t)b * nw;
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
  segments_from_words<WIDE>(m3, nw, len, lim, miss, mismatch_thr, __ldg(gp + 4 * b),
                            __ldg(gp + 4 * b + 1), __ldg(gp + 4 * b + 2),
                            __ldg(gp + 4 * b + 3), lane, out + (size_t)b * 10);
}

// Warps a block and dynamic shared memory of a mask launch: narrow rows
// keep their words in shared memory (16 bytes a mask word), WIDE rows in
// scratch.
struct MaskLaunch {
  dim3 grid, block;
  size_t smem;
};

inline MaskLaunch mask_launch(int B, int NK, bool wide) {
  const int nw = (NK + KMER - 1 + 31) / 32;
  const size_t warp_bytes = wide ? 0 : 16 * (size_t)nw;
  const int warps = wide ? MASK_WARPS
                         : (int)std::max<size_t>(
                               1, std::min<size_t>(MASK_WARPS, 48 * 1024 / warp_bytes));
  return {dim3((B + warps - 1) / warps), dim3(32 * warps), warps * warp_bytes};
}

}  // namespace gf

// pr: (B, NK, 2) int32 full-stride probe results of the survivors' code
// rows (width L = NK + 15); gp: (B, 4) int32 [h1, l1, h2, l2] from the
// vote. out: (B, 10) int32 [valid0, valid1, start0, start1, end0, end1,
// h1, h2, l1, l2] (segment 0 = top target 3, 1 = second target 2). kv
// dupe rows (split == 0) are 8 payloads, 16-byte aligned. scratch: NULL
// for L <= 65535; for wider rows, 4 * B * ceil(L / 32) uint32.
extern "C" int gf_mask_segments(const void* pr, const void* lengths, const void* gp,
                                int B, int NK, const void* dupes, int dstride, int D,
                                int split, int cbits, int pos_bias, int mismatch_thr,
                                void* scratch, void* out, void* stream) {
  const bool wide = NK + gf::KMER - 1 > gf::MASK_MAX_L;
  if (B < 0 || NK < 1 || (wide && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  if (!split && D > 1 && (D > 8 || dstride % 4 || dstride < 8 || (uintptr_t)dupes % 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const gf::MaskLaunch m = gf::mask_launch(B, NK, wide);
  cudaStream_t st = (cudaStream_t)stream;
  auto p = (const int32_t*)pr;
  auto n = (const int32_t*)lengths;
  auto g = (const int32_t*)gp;
  auto d = (const int32_t*)dupes;
  auto w = (uint32_t*)scratch;
  auto o = (int32_t*)out;
  auto kern = split ? (wide ? gf::mask_segments_kernel<true, true>
                            : gf::mask_segments_kernel<true, false>)
                    : (wide ? gf::mask_segments_kernel<false, true>
                            : gf::mask_segments_kernel<false, false>);
  kern<<<m.grid, m.block, m.smem, st>>>(p, n, g, B, NK, d, dstride, D, cbits, pos_bias,
                                        mismatch_thr, w, o);
  return (int)cudaGetLastError();
}

// One shard's pass-2 flags: pr (B, NK, 2) its full-stride probe results,
// gp (B, 4) the merged [h1, l1, h2, l2]; ORed into words (B, ceil((NK +
// 15) / 32), 2) uint32 [flag 3, flag >= 2] (zeroed before the first shard).
extern "C" int gf_shard_flags(const void* pr, const void* gp, int B, int NK, const void* dupes,
                              int dstride, int D, int split, int cbits, int pos_bias,
                              void* words, void* stream) {
  if (B < 0 || NK < 1) return (int)cudaErrorInvalidValue;
  if (!split && D > 1 && (D > 8 || dstride % 4 || dstride < 8 || (uintptr_t)dupes % 16))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * ((NK + 31) / 32);
  if (items == 0) return (int)cudaSuccess;
  const long long grid = (items + gf::MASK_WARPS - 1) / gf::MASK_WARPS;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto kern = split ? gf::shard_flags_kernel<true> : gf::shard_flags_kernel<false>;
  kern<<<(unsigned)grid, 32 * gf::MASK_WARPS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pr, (const int32_t*)gp, B, NK, (const int32_t*)dupes, dstride, D, cbits,
      pos_bias, (uint2*)words);
  return (int)cudaGetLastError();
}

// gf_mask_segments from merged flag words (B, ceil((NK + 15) / 32), 2):
// the same out rows; scratch as gf_mask_segments'.
extern "C" int gf_mask_from_flags(const void* words, const void* lengths, const void* gp,
                                  int B, int NK, int mismatch_thr, void* scratch, void* out,
                                  void* stream) {
  const bool wide = NK + gf::KMER - 1 > gf::MASK_MAX_L;
  if (B < 0 || NK < 1 || (wide && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const gf::MaskLaunch m = gf::mask_launch(B, NK, wide);
  auto kern = wide ? gf::mask_from_flags_kernel<true> : gf::mask_from_flags_kernel<false>;
  kern<<<m.grid, m.block, m.smem, (cudaStream_t)stream>>>(
      (const uint2*)words, (const int32_t*)lengths, (const int32_t*)gp, B, NK, mismatch_thr,
      (uint32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}
