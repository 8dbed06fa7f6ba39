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
// What bounds it on the H100: each job is a sequential walk of its text,
// Lt steps of ~20 integer operations on each of W words, with a loop-carried
// dependence from one step to the next. There is no parallelism to find
// inside a job, so the design fills the card with jobs instead: one thread
// per job, tens of thousands of jobs in flight.
//
// What the design does about it: the job's Eq table (11 symbols x W words)
// lives in dynamic shared memory laid out [symbol][word][thread], so that
// the 32 threads of a warp hit 32 banks; Pv and Mv stay in registers
// (templated on the word bound WMAX, loops fully unrolled); the text is
// read one byte a step through the read-only cache. The wrapper sizes the
// block so that its Eq tables fit the SM's shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int ED_ALPHA = 11;

template <int WMAX>
__global__ void __launch_bounds__(256)
edit_distance_kernel(const uint8_t* __restrict__ pat, const int32_t* __restrict__ pat_lens,
                     const uint8_t* __restrict__ txt, const int32_t* __restrict__ txt_lens,
                     int B, int Lp, int Lt, int W, int32_t* __restrict__ out) {
  extern __shared__ uint32_t eq[];  // [ED_ALPHA][W][blockDim.x]
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long b = (long long)blockIdx.x * T + tid;
  if (b >= B) return;
  const int m = __ldg(pat_lens + b);
  const int n = __ldg(txt_lens + b);
  for (int i = 0; i < ED_ALPHA * W; ++i) eq[i * T + tid] = 0u;
  const uint8_t* p = pat + b * Lp;
  const int mp = min(m, Lp);  // lengths within their rows (the wrapper: Lp <= 32 W)
  for (int i = 0; i < mp; ++i) {
    const int s = min((int)__ldg(p + i), ED_ALPHA - 1);
    eq[(s * W + (i >> 5)) * T + tid] |= 1u << (i & 31);
  }
  const int top = m > 0 ? m - 1 : 0;
  const int top_word = min(top >> 5, W - 1);
  const uint32_t top_bit = 1u << (top & 31);

  uint32_t pv[WMAX], mv[WMAX];
#pragma unroll
  for (int w = 0; w < WMAX; ++w) {
    const int nb = min(max(m - 32 * w, 0), 32);
    pv[w] = nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u);
    mv[w] = 0u;
  }
  int score = m;
  const uint8_t* t = txt + b * Lt;
  const int steps = m > 0 ? min(n, Lt) : 0;
  for (int j = 0; j < steps; ++j) {
    const int s = min((int)__ldg(t + j), ED_ALPHA - 1);
    const uint32_t* eqs = eq + s * W * T + tid;
    uint32_t hin_p = 1u, hin_m = 0u, carry = 0u, hp_top = 0u, hn_top = 0u;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        const uint32_t eqw = eqs[w * T];
        const uint32_t pvw = pv[w], mvw = mv[w];
        const uint32_t xv = eqw | mvw;
        const uint32_t x = eqw & pvw;
        const uint32_t s1 = x + pvw;
        const uint32_t s2 = s1 + carry;
        carry = (uint32_t)(s1 < x) | (uint32_t)(s2 < s1);
        const uint32_t xh = (s2 ^ pvw) | eqw;
        const uint32_t ph = mvw | ~(xh | pvw);
        const uint32_t mh = pvw & xh;
        if (w == top_word) { hp_top = ph; hn_top = mh; }
        const uint32_t ph_sh = (ph << 1) | hin_p;
        const uint32_t mh_sh = (mh << 1) | hin_m;
        hin_p = ph >> 31;
        hin_m = mh >> 31;
        pv[w] = mh_sh | ~(xv | ph_sh);
        mv[w] = ph_sh & xv;
      }
    }
    score += (hp_top & top_bit) ? 1 : ((hn_top & top_bit) ? -1 : 0);
  }
  if (m == 0) score = n;
  if (n == 0) score = m;
  out[b] = score;
}

}  // namespace gf

// Shared memory of one block of `threads` jobs at W words.
static size_t ed_smem(int W, int threads) {
  return (size_t)gf::ED_ALPHA * W * threads * sizeof(uint32_t);
}

// The largest block (a multiple of 32, at most 256) whose Eq tables fit in
// the current device's opt-in shared memory per block; 0 if not one warp.
extern "C" int gf_edit_distance_block(int W) {
  int dev = 0, smem_max = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  int threads = 256;
  while (threads >= 32 && ed_smem(W, threads) > (size_t)smem_max) threads -= 32;
  return threads >= 32 ? threads : 0;
}

template <int WMAX>
static int ed_launch(const uint8_t* p, const int32_t* pl, const uint8_t* t,
                     const int32_t* tl, int B, int Lp, int Lt, int W, int threads,
                     int32_t* o, cudaStream_t st) {
  const size_t smem = ed_smem(W, threads);
  auto kern = gf::edit_distance_kernel<WMAX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  kern<<<blocks, threads, smem, st>>>(p, pl, t, tl, B, Lp, Lt, W, o);
  return (int)cudaGetLastError();
}

// pat (B, Lp) / txt (B, Lt) uint8 codes, lengths (B,) int32 -> out (B,)
// int32. `threads` comes from gf_edit_distance_block; W <= 32.
extern "C" int gf_edit_distance(const void* pat, const void* pat_lens, const void* txt,
                                const void* txt_lens, int B, int Lp, int Lt, int W,
                                int threads, void* out, void* stream) {
  auto p = (const uint8_t*)pat;
  auto pl = (const int32_t*)pat_lens;
  auto t = (const uint8_t*)txt;
  auto tl = (const int32_t*)txt_lens;
  auto o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (threads < 32 || threads % 32 || threads > 256 || W < 1) return (int)cudaErrorInvalidValue;
  if (W <= 4) return ed_launch<4>(p, pl, t, tl, B, Lp, Lt, W, threads, o, st);
  if (W <= 8) return ed_launch<8>(p, pl, t, tl, B, Lp, Lt, W, threads, o, st);
  if (W <= 16) return ed_launch<16>(p, pl, t, tl, B, Lp, Lt, W, threads, o, st);
  if (W <= 32) return ed_launch<32>(p, pl, t, tl, B, Lp, Lt, W, threads, o, st);
  return (int)cudaErrorInvalidValue;
}
