// Kernel 5: batched Myers/Hyyro bit-parallel Levenshtein distance.
//
// Replaces genefuserust_tpu/ops/edit_distance.py (edit_distance_batch), the
// XLA version that the JAX engine's edit-distance batcher sends large
// flushes to. Semantics follow it step for step (edit_distance.py:87-151):
// W 32-bit words per pattern, the (Eq & Pv) + Pv add carried across words
// as c1 | c2, Ph/Mh shifted left with carry-in 1 / 0, the score read at
// bit (m-1) % 32 of word (m-1) / 32 (m = 0 reads bit 0 of word 0), steps
// past the text's end keep their state, and the empty-side rules last
// (m == 0 gives the text length, then an empty text gives m).
//
// What bounds it on the H100: integer issue. Each job is a walk of its
// text, Lt steps of ~20 integer operations on each of W words; a step
// depends on the last one, and inside a step word w waits for the add's
// carry and the horizontal deltas of word w - 1. The scan flushes ~100
// jobs at a time, far too few to fill the card with one thread a job.
//
// What the design does about it: one lane per word, run as a wavefront.
// A group of W lanes takes one job (floor(32 / W) jobs a warp) and lane w
// owns word w: its 11 Eq words live in registers, built from its own 32
// pattern bytes, and Pv / Mv are one register each. At iteration i lane w
// does text step i - w, whose symbol it reads itself two iterations
// ahead; one __shfl_up_sync brings it, from lane w - 1, that step's add carry and
// the deltas hin_p / hin_m, packed in one word. A job takes Lt +
// top_word iterations instead of Lt x W serial word-steps (words above
// the score's word top_word cannot change the score, so their lanes
// idle). No shared memory is used; blocks of one warp spread a small
// flush over as many SMs as it has warps.
#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int ED_ALPHA = 11;
constexpr unsigned FULL = 0xFFFFFFFFu;

// e[s] for a symbol s in 0..10, by its bits: no dynamic index into e, so
// the 11 words stay in registers.
__device__ __forceinline__ uint32_t eq_of(const uint32_t (&e)[ED_ALPHA], uint32_t s) {
  const bool b0 = s & 1u, b1 = s & 2u, b2 = s & 4u, b3 = s & 8u;
  const uint32_t a01 = b0 ? e[1] : e[0], a23 = b0 ? e[3] : e[2];
  const uint32_t a45 = b0 ? e[5] : e[4], a67 = b0 ? e[7] : e[6];
  const uint32_t a89 = b0 ? e[9] : e[8];
  const uint32_t lo = b2 ? (b1 ? a67 : a45) : (b1 ? a23 : a01);
  return b3 ? (b1 ? e[10] : a89) : lo;
}

__global__ void __launch_bounds__(128)
edit_distance_kernel(const uint8_t* __restrict__ pat, const int32_t* __restrict__ pat_lens,
                     const uint8_t* __restrict__ txt, const int32_t* __restrict__ txt_lens,
                     int B, int Lp, int Lt, int W, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int J = 32 / W;  // jobs a warp
  const int g = lane / W, w = lane - g * W;
  const long long b = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * J + g;
  const bool live = g < J && b < B;
  const int m = live ? __ldg(pat_lens + b) : 0;
  const int n = live ? __ldg(txt_lens + b) : 0;
  // this lane's word of Eq: bit i of e[s] = pattern[32 w + i] == s
  uint32_t e[ED_ALPHA];
#pragma unroll
  for (int s = 0; s < ED_ALPHA; ++s) e[s] = 0u;
  const int mp = min(m, Lp) - 32 * w;  // pattern bases in this word (lengths within rows)
  if (live && mp > 0) {
    const uint8_t* p = pat + b * Lp + 32 * w;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      if (i < mp) {
        const uint32_t s = min((uint32_t)__ldg(p + i), (uint32_t)ED_ALPHA - 1u);
        const uint32_t bit = 1u << i;
#pragma unroll
        for (int a = 0; a < ED_ALPHA; ++a) e[a] |= s == (uint32_t)a ? bit : 0u;
      }
    }
  }
  const int top = m > 0 ? m - 1 : 0;
  const int top_word = min(top >> 5, W - 1);
  const uint32_t top_bit = 1u << (top & 31);
  const int nb = min(max(m - 32 * w, 0), 32);
  uint32_t pv = nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u), mv = 0u;
  int score = m;
  const int steps = live && m > 0 ? min(n, Lt) : 0;
  const bool works = live && w <= top_word, is_top = live && w == top_word;
  const int iters = __reduce_max_sync(FULL, steps > 0 ? steps + top_word : 0);
  // Each lane reads its own steps' text bytes two iterations ahead and
  // selects their Eq word one ahead, so neither the load nor the select
  // sits on the loop's carried chain. At the top of iteration i, eqw is
  // the Eq word of step j = i - w and cn the byte of step j + 1.
  const uint8_t* t = txt + b * Lt;
  uint32_t cn = works && (unsigned)(1 - w) < (unsigned)steps ? __ldg(t + 1 - w) : 0u;
  uint32_t eqw = works && w == 0 && steps > 0
                     ? eq_of(e, min((uint32_t)__ldg(t), (uint32_t)ED_ALPHA - 1u)) : 0u;
  // to lane w + 1: carry | hout_p << 1 | hout_m << 2
  uint32_t msg = 0u;
#pragma unroll 2
  for (int i = 0; i < iters; ++i) {
    const int j = i - w;  // this lane's text step
    uint32_t in = __shfl_up_sync(FULL, msg, 1);
    in = w == 0 ? 2u : in;  // a job's first word: carry 0, hin_p 1, hin_m 0
    const uint32_t eq_next = eq_of(e, min(cn, (uint32_t)ED_ALPHA - 1u));
    cn = works && (unsigned)(j + 2) < (unsigned)steps ? __ldg(t + j + 2) : 0u;
    if (works && (unsigned)j < (unsigned)steps) {
      const uint32_t xv = eqw | mv;
      const uint32_t x = eqw & pv;
      const uint32_t s1 = x + pv;
      const uint32_t s2 = s1 + (in & 1u);
      const uint32_t cout = (uint32_t)(s1 < x) | (uint32_t)(s2 < s1);
      const uint32_t xh = (s2 ^ pv) | eqw;
      const uint32_t ph = mv | ~(xh | pv);
      const uint32_t mh = pv & xh;
      if (is_top) score += (ph & top_bit) ? 1 : ((mh & top_bit) ? -1 : 0);
      const uint32_t ph_sh = (ph << 1) | ((in >> 1) & 1u);
      const uint32_t mh_sh = (mh << 1) | (in >> 2);
      pv = mh_sh | ~(xv | ph_sh);
      mv = ph_sh & xv;
      msg = cout | ((ph >> 31) << 1) | ((mh >> 31) << 2);
    }
    eqw = eq_next;
  }
  if (is_top) {
    if (m == 0) score = n;
    if (n == 0) score = m;
    out[b] = score;
  }
}

}  // namespace gf

// pat (B, Lp) / txt (B, Lt) uint8 codes, lengths (B,) int32 -> out (B,)
// int32; 1 <= W <= 32. Blocks of one warp while the jobs' warps are
// fewer than four a SM, else of four.
extern "C" int gf_edit_distance(const void* pat, const void* pat_lens, const void* txt,
                                const void* txt_lens, int B, int Lp, int Lt, int W,
                                void* out, void* stream) {
  if (W < 1 || W > 32 || B < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long warps = ((long long)B + 32 / W - 1) / (32 / W);
  const int threads = warps < 4LL * sms ? 32 : 128;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks == 0) return 0;
  gf::edit_distance_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pat, (const int32_t*)pat_lens, (const uint8_t*)txt,
      (const int32_t*)txt_lens, B, Lp, Lt, W, (int32_t*)out);
  return (int)cudaGetLastError();
}
