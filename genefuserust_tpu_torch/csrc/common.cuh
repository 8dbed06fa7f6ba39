// Shared device helpers of the scan kernels: constants, payload decode,
// dupe expansion and the packed gplong key.
//
// Conventions follow genefuserust_tpu/ops/hashtable.py: a lookup yields
// (contig, pos) with contig >= 0 regular, DUPE (pos = dupe row), HIGH
// (skipped) or EMPTY (miss or invalid query). Keys and payloads are
// uint32 bit patterns stored as int32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int KMER = 16;
constexpr int32_t EMPTY = -3;
constexpr int32_t DUPE = -1;
constexpr int32_t HIGH = -2;
constexpr int ALLOWED_GAP = 10;
constexpr int THRESHOLD_LEN = 20;
// JAX's invalid candidate (hi = lo = INT32_MAX) as a packed key
constexpr long long INVALID_KEY = 0x7FFFFFFF7FFFFFFFLL;
// slots of the vote's row counter (vote.cu): its blocks add (rows voted on
// the warp path) + (rows sorted) << 32 into slot blockIdx.x % 32, and the
// compaction (fused_glue.cu) sums them into the count row of its output
constexpr int VOTE_STAT_SLOTS = 32;

__device__ __forceinline__ void decode(uint32_t pay, int cbits, int pos_bias,
                                       int32_t& contig, int32_t& pos) {
  const int pbits = 32 - cbits;
  const uint32_t tag = pay >> pbits;
  const uint32_t val = pay & ((1u << pbits) - 1u);
  if (tag == 0) { contig = EMPTY; pos = 0; }
  else if (tag == 1) { contig = HIGH; pos = 0; }
  else if (tag == 2) { contig = DUPE; pos = (int32_t)val; }
  else { contig = (int32_t)(tag - 3); pos = (int32_t)(val + (uint32_t)pos_bias); }
}

// Candidate d of one lookup result (expand_candidates / _kv): a regular
// entry fills slot 0, a dupe entry reads slot d of its dupe row. Returns
// whether the candidate is valid.
__device__ __forceinline__ bool expand(int32_t contig, int32_t pos, int d, int D,
                                       bool split, const int32_t* __restrict__ dupes,
                                       int dstride, int cbits, int pos_bias,
                                       int32_t& cc, int32_t& cp) {
  if (contig >= 0) {
    cc = contig; cp = pos;
    return d == 0;
  }
  if (contig != DUPE || D == 1) return false;
  const int32_t* row = dupes + (long long)pos * dstride;
  if (split) {
    cc = __ldg(row + 2 * d);
    cp = __ldg(row + 2 * d + 1);
    return cc != EMPTY;
  }
  decode((uint32_t)__ldg(row + d), cbits, pos_bias, cc, cp);
  return cc >= 0;
}

// (contig, pos - i) packed as the reference's i64: the low half is formed
// in wrapping 32-bit arithmetic with no borrow into the contig.
__device__ __forceinline__ long long gplong(int32_t contig, int32_t pos, int i) {
  const uint32_t lo = (uint32_t)pos - (uint32_t)i;
  return (long long)(((unsigned long long)(uint32_t)contig << 32) | lo);
}

__device__ __forceinline__ long long gplong_hl(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) | (uint32_t)lo);
}

// The max of v over the threads of the block before this one (-1 for
// none); `total` gets the max over the whole block. sm: 32 ints of shared
// memory. Every thread of the block calls it; it holds two barriers.
__device__ __forceinline__ int block_excl_max(int v, int* sm, int& total) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(ALL, incl, o);
    if (lane >= o) incl = max(incl, t);
  }
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  // the warps' maxima, scanned in one warp's lanes
  int w = lane < (int)(blockDim.x >> 5) ? sm[lane] : -1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(ALL, w, o);
    if (lane >= o) w = max(w, t);
  }
  total = __shfl_sync(ALL, w, 31);
  const int earlier = __shfl_sync(ALL, w, (warp + 31) & 31);
  const int up = __shfl_up_sync(ALL, incl, 1);
  __syncthreads();
  return max(warp ? earlier : -1, lane ? up : -1);
}

}  // namespace gf
