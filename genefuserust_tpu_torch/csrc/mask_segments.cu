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
#include <algorithm>

#include "common.cuh"

namespace gf {

constexpr int MASK_WARPS = 4;  // survivors a block
constexpr int MASK_GROUP = 4;  // chunks of 32 k-mers whose loads go out together
constexpr int MASK_MAX_L = 0xFFFF;  // a chain end is kept in 16 bits
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

// The best chain key of one chunk of 32 words (one a lane): each chain
// end's head is the last head at or before it, in the word or carried by
// a max-scan over the lanes; `carry` is the last head before the chunk
// and becomes the last head through it.
__device__ __forceinline__ uint32_t chain_key(int w, uint32_t hd, uint32_t e, int& carry,
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
  uint32_t key = 0;
  while (e) {
    const int bit = __ffs(e) - 1;
    e &= e - 1;
    const uint32_t hb = hd & (FULL >> (31 - bit));
    const int head = hb ? 32 * w + 31 - __clz(hb) : before;
    const int end = 32 * w + bit;
    key = max(key, ((uint32_t)(end - head + 1) << 16) | (uint32_t)(0xFFFF - end));
  }
  return __reduce_max_sync(FULL, key);
}

__device__ __forceinline__ void segment(uint32_t key, int32_t& valid, int32_t& start,
                                        int32_t& end) {
  if (key == 0) {  // no chain: JAX's argmax of all -1 gives (start -1, end 0)
    valid = 0;
    start = -1;
    end = 0;
    return;
  }
  const int n = (int)(key >> 16) - 1;
  end = 0xFFFF - (int)(key & 0xFFFF);
  start = end - n;
  valid = n > THRESHOLD_LEN;
}

template <bool SPLIT>
__global__ void __launch_bounds__(32 * MASK_WARPS)
mask_segments_kernel(const int32_t* __restrict__ pr, const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ gp, int B, int NK,
                     const int32_t* __restrict__ dupes, int dstride, int D, int cbits,
                     int pos_bias, int mismatch_thr, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp: nothing below waits on the block
  const int L = NK + KMER - 1, nw = (L + 31) >> 5;
  // the warp's words: mask 3, mask >= 2, linked bases of targets 3 and 2
  uint32_t* m3 = smem + (size_t)warp * 4 * nw;
  uint32_t* m2 = m3 + nw;
  uint32_t* lk3 = m2 + nw;
  uint32_t* lk2 = lk3 + nw;
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
      const int i = c * 32 + lane;
      int f = 0;
      if (r[j].x >= 0) f = match(gplong(r[j].x, r[j].y, i), g1, g2);
      else if (r[j].x == DUPE && D > 1) f = dr[j].flag(i, g1, g2, D, cbits, pos_bias);
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
  uint32_t best3 = 0, best2 = 0;
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
    best3 = max(best3, chain_key(w, hd3, e3, carry3, lane));
    best2 = max(best2, chain_key(w, hd2, e2, carry2, lane));
  }
  if (lane == 0) {
    int32_t v3, s3, x3, v2, s2, x2;
    segment(best3, v3, s3, x3);
    segment(best2, v2, s2, x2);
    const int32_t ok = miss <= mismatch_thr;
    int32_t* o = out + (size_t)b * 10;
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

}  // namespace gf

// pr: (B, NK, 2) int32 full-stride probe results of the survivors' code
// rows (width NK + 15 <= 65535); gp: (B, 4) int32 [h1, l1, h2, l2] from
// the vote. out: (B, 10) int32 [valid0, valid1, start0, start1, end0,
// end1, h1, h2, l1, l2] (segment 0 = top target 3, 1 = second target 2).
// kv dupe rows (split == 0) are 8 payloads, 16-byte aligned.
extern "C" int gf_mask_segments(const void* pr, const void* lengths, const void* gp,
                                int B, int NK, const void* dupes, int dstride, int D,
                                int split, int cbits, int pos_bias, int mismatch_thr,
                                void* out, void* stream) {
  if (B < 0 || NK < 1 || NK + gf::KMER - 1 > gf::MASK_MAX_L) return (int)cudaErrorInvalidValue;
  if (!split && D > 1 && (D > 8 || dstride % 4 || dstride < 8 || (uintptr_t)dupes % 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int nw = (NK + gf::KMER - 1 + 31) / 32;
  const size_t warp_bytes = 16 * (size_t)nw;  // four words a mask word
  const int warps =
      (int)std::max<size_t>(1, std::min<size_t>(gf::MASK_WARPS, 48 * 1024 / warp_bytes));
  const dim3 grid((B + warps - 1) / warps), block(32 * warps);
  const size_t smem = warps * warp_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  auto p = (const int32_t*)pr;
  auto n = (const int32_t*)lengths;
  auto g = (const int32_t*)gp;
  auto d = (const int32_t*)dupes;
  auto o = (int32_t*)out;
  if (split)
    gf::mask_segments_kernel<true><<<grid, block, smem, st>>>(p, n, g, B, NK, d, dstride, D,
                                                              cbits, pos_bias, mismatch_thr, o);
  else
    gf::mask_segments_kernel<false><<<grid, block, smem, st>>>(p, n, g, B, NK, d, dstride, D,
                                                               cbits, pos_bias, mismatch_thr, o);
  return (int)cudaGetLastError();
}
