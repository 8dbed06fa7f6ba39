// The device-side pair merge of the JAX package, beside the main path
// (which merges on the host):
//   merge_bytes_kernel  genefuserust_tpu/ops/merge.py:42 merge_batch: the
//                       overlap merge of raw bytes and PHRED qualities,
//                       with the merged read and its qualities;
//   merge_codes_kernel  genefuserust_tpu/ops/fused.py:51 _merge_codes with
//                       the front of fused_pass1 (:133, unpack, RC of R2,
//                       the three map-code lanes) and of fused_merge_chunked
//                       (:262): the merge on 4-bit codes and 2-bit quality
//                       classes from the upload rows;
//   merge_rows_kernel   the row gathers of pass1_rows_merged (:305),
//                       pass1_rows_packed (:337) and fused_pass2_combined
//                       (:369): merged code rows or R1/R2 rows unpacked from
//                       the upload, padded with 15, mapped to 2-bit codes.
//
// The merge (read.rs:313-440): for o = MIN_OVERLAP .. min(l1, l2), compare
// the left read's last o bases with the right read's first o; accept the
// first o whose mismatches are all low-quality discordant, at most 2 of
// them. Both totals (mismatches that are not low-quality, and those that
// are) only grow along the overlap, so an o fails as soon as a prefix of
// it fails: the lanes test 32 overlaps at once on their first
// MERGE_PREFIX positions, and the warp scans only the ones that pass,
// 32 positions a step, stopping at the first step that holds a
// mismatch that is not low-quality or brings the low-quality count past
// 2; only the accepted o is counted to its end (its diff, <= 2).
//
// What bounds them on the H100: the merges read a pair's rows once and
// write 2L output bytes a pair (bytes: ~0.02 ms at 65,536 pairs of 150
// bases), and their compares are data-dependent, a few a rejected overlap;
// the row gather is plain bytes. So one warp takes one pair: its rows are
// staged in its shared memory (the right read reversed and left-aligned);
// a wrong overlap fails within a few positions, so the lanes filter the
// overlaps in parallel, and the warp scans about one a pair whole, its
// lanes splitting the positions and two ballots counting the mismatches;
// the lanes then write the merged row across its columns. Rows past
// MERGE_MAX_L bases are refused by the entry points.
#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int MIN_OVERLAP = 30;
constexpr int MERGE_MAX_L = 32768;
constexpr int MERGE_WARPS = 8;  // warps a block when a block's rows fit in 48 KB
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int ROWS_WARPS = 8;
constexpr unsigned ALL = 0xffffffffu;
constexpr uint8_t Q30 = '?', Q15 = '0', QCAP = 'Z';
// positions of an overlap a lane tests alone before the warp scans it whole
constexpr int MERGE_PREFIX = 4;
static_assert(MERGE_PREFIX > 0 && MERGE_PREFIX <= MIN_OVERLAP, "MERGE_PREFIX out of range");

__device__ __forceinline__ uint8_t map4(uint8_t c) { return c < 4 ? c : 255; }

// COMP4 of ops/pack.py: A<->T, C<->G for both cases, anything else N (4)
__device__ __forceinline__ uint8_t comp4(uint8_t c) {
  if (c < 4) return c ^ 1;
  if (c >= 5 && c <= 8) return (uint8_t)((c - 5) ^ 1);
  return 4;
}

__device__ __forceinline__ uint8_t nibble(const uint8_t* __restrict__ p, int i) {
  return (__ldg(p + (i >> 1)) >> ((i & 1) * 4)) & 15;
}

__device__ __forceinline__ uint8_t qclass(const uint8_t* __restrict__ p, int i) {
  return (__ldg(p + (i >> 2)) >> ((i & 3) * 2)) & 3;
}

struct LowBytes {
  __device__ __forceinline__ bool operator()(uint8_t a, uint8_t b) const {
    return (a >= Q30 && b <= Q15) || (a <= Q15 && b >= Q30);
  }
};

struct LowClasses {
  __device__ __forceinline__ bool operator()(uint8_t a, uint8_t b) const {
    return (a == 2 && b == 0) || (a == 0 && b == 2);
  }
};

// Whether overlap o (its left-read bases at off = l1 - o) is acceptable:
// the warp compares its positions 32 a step and stops at the first step
// that holds a mismatch that is not low-quality discordant or brings the
// low-quality count past 2. `nlow`: the accepted overlap's count.
template <class Low>
__device__ __forceinline__ bool overlap_ok(const uint8_t* a, const uint8_t* qa,
                                           const uint8_t* b, const uint8_t* qb, int off, int o,
                                           Low low, int& nlow) {
  const int lane = threadIdx.x & 31;
  nlow = 0;
  for (int at = 0; at < o; at += 32) {
    const int i = at + lane;
    bool hard = false, soft = false;
    if (i < o && a[off + i] != b[i]) {
      soft = low(qa[off + i], qb[i]);
      hard = !soft;
    }
    nlow += __popc(__ballot_sync(ALL, soft));
    if (__ballot_sync(ALL, hard) || nlow > 2) return false;
  }
  return true;
}

// The first acceptable overlap of a pair staged in the warp's shared
// memory: a/qa the left read (its overlap right-aligned at l1), b/qb the
// right read left-aligned. -> the overlap, 0 for none; `diff` its count.
// The lanes first take 32 overlaps at a time, each lane one, and test its
// first MERGE_PREFIX positions alone: an overlap that fails there fails
// (the totals only grow), so only the ones that pass, in ascending order,
// are scanned whole by the warp.
template <class Low>
__device__ int warp_overlap(const uint8_t* a, const uint8_t* qa, const uint8_t* b,
                            const uint8_t* qb, int l1, int l2, Low low, int& diff) {
  const int n = min(l1, l2);
  const int lane = threadIdx.x & 31;
  for (int o0 = MIN_OVERLAP; o0 <= n; o0 += 32) {
    const int o = o0 + lane;
    bool pass = o <= n;
    if (pass) {
      const int off = l1 - o;
      int nlow = 0;
      bool hard = false;
#pragma unroll
      for (int i = 0; i < MERGE_PREFIX; ++i) {
        if (a[off + i] != b[i]) {
          if (low(qa[off + i], qb[i]))
            ++nlow;
          else
            hard = true;
        }
      }
      pass = !hard && nlow <= 2;
    }
    for (unsigned cand = __ballot_sync(ALL, pass); cand; cand &= cand - 1) {
      const int oc = o0 + __ffs(cand) - 1;
      if (overlap_ok(a, qa, b, qb, l1 - oc, oc, low, diff)) return oc;
    }
  }
  diff = 0;
  return 0;
}

__device__ __forceinline__ int clamp_len(int v, int L) { return v < 0 ? 0 : (v > L ? L : v); }

// A warp a pair. Shared memory: 4 rows of Ls bytes a warp (b1, q1, b2, q2).
__global__ void merge_bytes_kernel(const uint8_t* __restrict__ b1, const uint8_t* __restrict__ q1,
                                   const int32_t* __restrict__ l1s,
                                   const uint8_t* __restrict__ b2, const uint8_t* __restrict__ q2,
                                   const int32_t* __restrict__ l2s, int B, int L, int Ls,
                                   uint8_t* __restrict__ merged, int32_t* __restrict__ ints,
                                   uint8_t* __restrict__ out) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint8_t* sa = smem + (size_t)warp * 4 * Ls;
  uint8_t *sqa = sa + Ls, *sb = sa + 2 * Ls, *sqb = sa + 3 * Ls;
  const int W = 2 * L;
  for (int row = blockIdx.x * warps + warp; row < B; row += gridDim.x * warps) {
    const size_t base = (size_t)row * L;
    for (int i = lane; i < L; i += 32) {
      sa[i] = __ldg(b1 + base + i);
      sqa[i] = __ldg(q1 + base + i);
      sb[i] = __ldg(b2 + base + i);
      sqb[i] = __ldg(q2 + base + i);
    }
    __syncwarp();
    const int l1 = clamp_len(__ldg(l1s + row), L), l2 = clamp_len(__ldg(l2s + row), L);
    int diff;
    const int o = warp_overlap(sa, sqa, sb, sqb, l1, l2, LowBytes(), diff);
    const int offset = l1 - o, out_len = o ? offset + l2 : 0;
    uint8_t* os = out + (size_t)row * W;
    uint8_t* oq = out + (size_t)B * W + (size_t)row * W;
    for (int j = lane; j < W; j += 32) {
      uint8_t s = 0, q = 0;
      if (o) {
        if (j < offset) {
          s = sa[j];
          q = sqa[j];
        } else if (j < l1) {
          const uint8_t x = sa[j], qx = sqa[j], y = sb[j - offset], qy = sqb[j - offset];
          if (x == y) {
            s = y;
            q = (uint8_t)min((int)qx + (int)qy - 33, (int)QCAP);
          } else if (qx >= Q30 && qy <= Q15) {
            s = x;
            q = qx;
          } else {
            s = y;
            q = qy;
          }
        } else if (j < out_len) {
          s = sb[j - offset];
          q = sqb[j - offset];
        }
      }
      os[j] = s;
      oq[j] = q;
    }
    if (lane == 0) {
      merged[row] = o ? 1 : 0;
      ints[row] = o;
      ints[B + row] = diff;
      ints[2 * B + row] = out_len;
    }
    __syncwarp();  // the rows are read before the next pair's staging
  }
}

// A warp a pair of the upload rows [s1p | q1p | s2p | q2p] (W bytes a row).
// Shared memory: 4 rows of Ls bytes a warp: R1's codes and classes, R2's
// RC'd codes and reversed classes, left-aligned. lens3 != NULL: also the
// three map-code lanes and their lengths.
__global__ void merge_codes_kernel(const uint8_t* __restrict__ buf,
                                   const int32_t* __restrict__ lens2, int B, int L, int Ls,
                                   int32_t* __restrict__ msum, uint8_t* __restrict__ m_codes,
                                   uint8_t* __restrict__ m_map, uint8_t* __restrict__ r1_map,
                                   uint8_t* __restrict__ r2_map, int32_t* __restrict__ lens3) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint8_t* s1 = smem + (size_t)warp * 4 * Ls;
  uint8_t *c1 = s1 + Ls, *t2 = s1 + 2 * Ls, *c2 = s1 + 3 * Ls;
  const int w2 = (L + 1) / 2, w4 = (L + 3) / 4, W = 2 * w2 + 2 * w4, Wm = 2 * L;
  for (int row = blockIdx.x * warps + warp; row < B; row += gridDim.x * warps) {
    const uint8_t* r = buf + (size_t)row * W;
    const int l1 = clamp_len(__ldg(lens2 + 2 * row), L);
    const int l2 = clamp_len(__ldg(lens2 + 2 * row + 1), L);
    for (int i = lane; i < L; i += 32) {
      const uint8_t a = nibble(r, i), b = nibble(r + w2 + w4, i);
      s1[i] = a;
      c1[i] = qclass(r + w2, i);
      if (i < l2) {
        t2[i] = comp4(nibble(r + w2 + w4, l2 - 1 - i));
        c2[i] = qclass(r + 2 * w2 + w4, l2 - 1 - i);
      } else {
        t2[i] = 15;
        c2[i] = 0;
      }
      if (lens3 != nullptr) {
        r1_map[(size_t)row * L + i] = map4(a);
        r2_map[(size_t)row * L + i] = map4(b);
      }
    }
    __syncwarp();
    int diff;
    const int o = warp_overlap(s1, c1, t2, c2, l1, l2, LowClasses(), diff);
    const int offset = l1 - o, m_len = o ? offset + l2 : 0;
    for (int j = lane; j < Wm; j += 32) {
      uint8_t s = 15;
      if (o) {
        if (j < offset) {
          s = s1[j];
        } else if (j < l1) {
          const uint8_t x = s1[j], y = t2[j - offset];
          s = (x != y && c1[j] == 2 && c2[j - offset] == 0) ? x : y;
        } else if (j < m_len) {
          s = t2[j - offset];
        }
      }
      m_codes[(size_t)row * Wm + j] = s;
      if (lens3 != nullptr) m_map[(size_t)row * Wm + j] = map4(s);
    }
    if (lane == 0) {
      msum[3 * row] = o ? 1 : 0;
      msum[3 * row + 1] = diff;
      msum[3 * row + 2] = m_len;
      if (lens3 != nullptr) {
        lens3[row] = m_len;
        lens3[B + row] = o ? 0 : __ldg(lens2 + 2 * row);
        lens3[2 * B + row] = o ? 0 : __ldg(lens2 + 2 * row + 1);
      }
    }
    __syncwarp();
  }
}

// A warp an output row: entry p takes pair row idx[p * istride] (rows
// outside [0, nrows) give 255), from m_codes (Lm bytes a row) where lane
// is NULL or lane[p * lstride] == 0 and m_codes is given, else R1 (lane
// 1) or R2 from the upload rows buf (W bytes a row, reads of L bases, 15
// past L); W_out columns mapped to 2-bit codes.
__global__ void merge_rows_kernel(const uint8_t* __restrict__ m_codes, int Lm,
                                  const uint8_t* __restrict__ buf, int L, int nrows,
                                  const int32_t* __restrict__ idx, int istride,
                                  const int32_t* __restrict__ lanes, int lstride, int PB,
                                  int W_out, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int w2 = (L + 1) / 2, w4 = (L + 3) / 4, W = 2 * w2 + 2 * w4;
  for (int p = blockIdx.x * warps + warp; p < PB; p += gridDim.x * warps) {
    const int src = __ldg(idx + (size_t)p * istride);
    const int which = lanes != nullptr ? __ldg(lanes + (size_t)p * lstride) : 0;
    uint8_t* o = out + (size_t)p * W_out;
    if (src < 0 || src >= nrows) {
      for (int c = lane; c < W_out; c += 32) o[c] = 255;
    } else if (which == 0 && m_codes != nullptr) {
      const uint8_t* m = m_codes + (size_t)src * Lm;
      for (int c = lane; c < W_out; c += 32) o[c] = map4(__ldg(m + c));
    } else {
      const uint8_t* r = buf + (size_t)src * W + (which == 1 ? 0 : w2 + w4);
      for (int c = lane; c < W_out; c += 32) o[c] = c < L ? map4(nibble(r, c)) : 255;
    }
  }
}

// Warps a block and shared-memory bytes for a merge of rows of L bytes:
// MERGE_WARPS warps while their rows fit in 48 KB, else one warp and its
// rows in opted-in shared memory.
template <class K>
static int merge_launch_shape(K kernel, int L, int& warps, int& Ls, size_t& smem) {
  Ls = (L + 15) / 16 * 16;
  const size_t per_warp = 4 * (size_t)Ls;
  warps = (int)(SMEM_DEFAULT / per_warp);
  warps = warps > MERGE_WARPS ? MERGE_WARPS : (warps < 1 ? 1 : warps);
  smem = per_warp * warps;
  if (smem > (size_t)SMEM_DEFAULT)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

static int merge_grid(int B, int warps) {
  const long long blocks = ((long long)B + warps - 1) / warps;
  return (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace gf

// b1, q1, b2, q2 (B, L) uint8; l1, l2 (B,) int32. merged (B,) bool; ints
// (3, B) int32 [olen, diff, out_len]; out (2, B, 2L) uint8 [seq, qual].
extern "C" int gf_merge_bytes(const void* b1, const void* q1, const void* l1, const void* b2,
                              const void* q2, const void* l2, int B, int L, void* merged,
                              void* ints, void* out, void* stream) {
  if (B < 0 || L < 1 || L > gf::MERGE_MAX_L) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int warps, Ls;
  size_t smem;
  int err = gf::merge_launch_shape(gf::merge_bytes_kernel, L, warps, Ls, smem);
  if (err) return err;
  gf::merge_bytes_kernel<<<gf::merge_grid(B, warps), 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)b1, (const uint8_t*)q1, (const int32_t*)l1, (const uint8_t*)b2,
      (const uint8_t*)q2, (const int32_t*)l2, B, L, Ls, (uint8_t*)merged, (int32_t*)ints,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// buf (B, 2*ceil(L/2) + 2*ceil(L/4)) uint8; lens2 (B, 2) int32. msum (B, 3)
// int32; m_codes (B, 2L) uint8; m_map (B, 2L), r1_map, r2_map (B, L) uint8
// and lens3 (3, B) int32, all NULL or all given.
extern "C" int gf_merge_codes(const void* buf, const void* lens2, int B, int L, void* msum,
                              void* m_codes, void* m_map, void* r1_map, void* r2_map,
                              void* lens3, void* stream) {
  if (B < 0 || L < 1 || L > gf::MERGE_MAX_L ||
      (lens3 != nullptr && (m_map == nullptr || r1_map == nullptr || r2_map == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int warps, Ls;
  size_t smem;
  int err = gf::merge_launch_shape(gf::merge_codes_kernel, L, warps, Ls, smem);
  if (err) return err;
  gf::merge_codes_kernel<<<gf::merge_grid(B, warps), 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int32_t*)lens2, B, L, Ls, (int32_t*)msum, (uint8_t*)m_codes,
      (uint8_t*)m_map, (uint8_t*)r1_map, (uint8_t*)r2_map, (int32_t*)lens3);
  return (int)cudaGetLastError();
}

// m_codes (nrows, Lm) uint8 or NULL; buf (nrows, 2*ceil(L/2) + 2*ceil(L/4))
// uint8 or NULL; idx, lanes: int32 with strides in elements (lanes may be
// NULL); out (PB, W) uint8, W <= Lm where m_codes is given.
extern "C" int gf_merge_rows(const void* m_codes, int Lm, const void* buf, int L, int nrows,
                             const void* idx, int istride, const void* lanes, int lstride,
                             int PB, int W, void* out, void* stream) {
  if (PB < 0 || W < 1 || nrows < 0 || istride < 1 || (lanes != nullptr && lstride < 1) ||
      (m_codes == nullptr && buf == nullptr) || (m_codes != nullptr && W > Lm) ||
      (lanes != nullptr && buf == nullptr) ||
      (buf != nullptr && L < 1))
    return (int)cudaErrorInvalidValue;
  if (PB == 0) return (int)cudaSuccess;
  gf::merge_rows_kernel<<<gf::merge_grid(PB, gf::ROWS_WARPS), 32 * gf::ROWS_WARPS, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)m_codes, Lm, (const uint8_t*)buf, L, nrows, (const int32_t*)idx, istride,
      (const int32_t*)lanes, lstride, PB, W, (uint8_t*)out);
  return (int)cudaGetLastError();
}
