// Kernel 3: pass-2 mask and segments of one vote survivor per block.
//
// Replaces the XLA-jitted pass 2 of the TPU scan, genefuserust_tpu/ops/
// map_read.py map_read_pass2 after the probe: the per-candidate flags
// (3 within +-1 of the top gplong, else 2 within +-1 of the second;
// _eq_pm1), their max over the dupe slots, the 16-wide window max into a
// per-base mask, the mismatch count and extract_segments for targets 3
// and 2. On the TPU this stage was jnp (cummax/cummin scans); the TPU's
// only Pallas kernel is the probe (probe.cu).
//
// What bounds it on the H100: little. It runs on the few survivors of the
// vote (at most the survivor cap, 1024 rows per batch), each reading one
// contiguous (NK, 2) probe row plus a dupe row per dupe hit; the rest is
// per-base integer work on a few hundred bytes. Latency of the dependent
// steps (flags -> mask -> segment walk) dominates, not bandwidth.
//
// What the simple design does about it: one block per survivor; flags and
// mask live in shared memory; flags and the window max are computed one
// element per thread; the two segment walks (targets 3 and 2) run serially
// in one thread each, in two different warps, exactly following the chain
// rules of extract_segments (gap <= ALLOWED_GAP, no higher flag between,
// no head at the last in-bounds base, first longest chain wins).
#include "common.cuh"

namespace gf {

constexpr int MASK_THREADS = 128;

// Serial extract_segments for one target over mask[0, min(len, L)):
// chains of target positions linked when the gap is <= ALLOWED_GAP with no
// higher flag between; a position that cannot link starts a chain unless
// it is the last in-bounds base. The first longest chain wins; with no
// chain the result is (start -1, end 0), as JAX's argmax gives.
__device__ void segment_walk(const uint8_t* mask, int L, int len, int target,
                             int32_t& valid, int32_t& start, int32_t& end) {
  const int lim = min(len, L);
  int prev = -1, last_blocked = -1, hid = -1, cur_end = -1;
  int best_len = -1, best_start = -1, best_end = 0;
  for (int t = 0; t < lim; ++t) {
    const int m = mask[t];
    if (m > target) { last_blocked = t; continue; }
    if (m != target) continue;
    const bool linked = prev >= 0 && t - prev <= ALLOWED_GAP && last_blocked <= prev;
    const bool head = !linked && t < len - 1;
    prev = t;
    if (!linked && !head) continue;
    if (head) {
      if (hid >= 0 && cur_end - hid > best_len) {
        best_len = cur_end - hid; best_start = hid; best_end = cur_end;
      }
      hid = t;
    }
    cur_end = t;
  }
  if (hid >= 0 && cur_end - hid > best_len) {
    best_len = cur_end - hid; best_start = hid; best_end = cur_end;
  }
  valid = best_len > THRESHOLD_LEN;
  start = best_start;
  end = best_end;
}

__global__ void mask_segments_kernel(const int32_t* __restrict__ pr,
                                     const int32_t* __restrict__ lengths,
                                     const int32_t* __restrict__ gp, int NK,
                                     const int32_t* __restrict__ dupes, int dstride, int D,
                                     bool split, int cbits, int pos_bias, int mismatch_thr,
                                     int32_t* __restrict__ out) {
  extern __shared__ uint8_t smem[];
  const int L = NK + KMER - 1;
  uint8_t* flag = smem;      // NK
  uint8_t* mask = smem + NK;  // L
  __shared__ int mismatches;
  __shared__ int32_t seg[2][3];
  const int b = blockIdx.x;
  const int len = __ldg(lengths + b);
  const int32_t h1 = __ldg(gp + 4 * b), l1 = __ldg(gp + 4 * b + 1);
  const int32_t h2 = __ldg(gp + 4 * b + 2), l2 = __ldg(gp + 4 * b + 3);
  const long long g1 = gplong_hl(h1, l1), g2 = gplong_hl(h2, l2);
  const int2* row = reinterpret_cast<const int2*>(pr) + (long long)b * NK;
  if (threadIdx.x == 0) mismatches = 0;
  for (int i = threadIdx.x; i < NK; i += blockDim.x) {
    const int2 r = __ldg(row + i);
    int f = 0;
    if (r.x >= 0 || r.x == DUPE) {
      for (int d = 0; d < D && f < 3; ++d) {
        int32_t cc, cp;
        if (!expand(r.x, r.y, d, D, split, dupes, dstride, cbits, pos_bias, cc, cp))
          continue;
        const long long key = gplong(cc, cp, i);
        // |key - g| <= 1 in exact i64 (keys and tops are >= 0: no overflow)
        if ((unsigned long long)(key - g1 + 1) <= 2ULL) f = 3;
        else if ((unsigned long long)(key - g2 + 1) <= 2ULL) f = 2;
      }
    }
    flag[i] = (uint8_t)f;
  }
  __syncthreads();
  int miss = 0;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    int m = 0;
    for (int i = max(0, t - (KMER - 1)); i <= min(t, NK - 1); ++i) m = max(m, (int)flag[i]);
    mask[t] = (uint8_t)m;
    miss += (t < len && m < 2);
  }
  atomicAdd(&mismatches, miss);
  __syncthreads();
  if (threadIdx.x == 0) segment_walk(mask, L, len, 3, seg[0][0], seg[0][1], seg[0][2]);
  if (threadIdx.x == 32) segment_walk(mask, L, len, 2, seg[1][0], seg[1][1], seg[1][2]);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t ok = mismatches <= mismatch_thr;
    int32_t* o = out + (long long)b * 10;
    o[0] = seg[0][0] & ok;
    o[1] = seg[1][0] & ok;
    o[2] = seg[0][1];
    o[3] = seg[1][1];
    o[4] = seg[0][2];
    o[5] = seg[1][2];
    o[6] = h1;
    o[7] = h2;
    o[8] = l1;
    o[9] = l2;
  }
}

}  // namespace gf

// pr: (B, NK, 2) int32 full-stride probe results of the survivors' code
// rows (width NK + 15); gp: (B, 4) int32 [h1, l1, h2, l2] from the vote.
// out: (B, 10) int32 [valid0, valid1, start0, start1, end0, end1,
// h1, h2, l1, l2] (segment 0 = top target 3, 1 = second target 2).
extern "C" int gf_mask_segments(const void* pr, const void* lengths, const void* gp,
                                int B, int NK, const void* dupes, int dstride, int D,
                                int split, int cbits, int pos_bias, int mismatch_thr,
                                void* out, void* stream) {
  const size_t smem = 2 * (size_t)NK + gf::KMER;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  gf::mask_segments_kernel<<<B, gf::MASK_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pr, (const int32_t*)lengths, (const int32_t*)gp, NK,
      (const int32_t*)dupes, dstride, D, split != 0, cbits, pos_bias, mismatch_thr,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
