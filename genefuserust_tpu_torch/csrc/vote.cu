// Kernel 2: the pass-1 vote of one read per block.
//
// Replaces the XLA-jitted vote of the TPU scan, genefuserust_tpu/ops/
// map_read.py map_read_pass1 after the probe: expand_candidates(_kv),
// the gplong of (contig, pos - i), top2_votes (a two-key lax.sort plus a
// run-length scan) and the count*2 >= major/minor gate. The TPU's only
// Pallas kernel is the probe (probe.cu); on the TPU this stage was jnp.
//
// What bounds it on the H100: per read, NS samples x D dupe slots
// candidates (121 x 8 = 968 at lane width 256) must be counted. The work
// is a sort of up to a few thousand 8-byte keys, i.e. shared-memory
// bandwidth and __syncthreads() barriers of the sort network; the input
// is one contiguous (NS, 2) int32 row, read once.
//
// What the simple design does about it: one block per read keeps the
// whole candidate list in shared memory (P2 = NS*D rounded up to a power
// of two; 8 KB at width 256); a bitonic sort orders it; each run start
// finds its run length with a binary search for the run's end, and two
// block-wide max reductions over (count, -index) take the top two with
// the reference's tie rule (count desc, then smallest key). Nothing but
// the (B, 5) result goes back to device memory.
#include "common.cuh"

namespace gf {

constexpr int VOTE_THREADS = 256;

__device__ __forceinline__ long long block_max(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -1LL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
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

// (count, index) -> a score whose max is the largest count, then the
// smallest index; -1 when index i starts no countable run (or is `skip`)
__device__ __forceinline__ long long run_score(const long long* keys, int i, int P2,
                                               int skip) {
  const long long k = keys[i];
  if (i == skip || (i > 0 && keys[i - 1] == k)) return -1;
  if ((int)(k >> 32) == 0x7FFFFFFF || k == 0) return -1;
  const int cnt = upper_bound(keys, i + 1, P2, k) - i;
  return ((long long)cnt << 32) | (unsigned)(P2 - 1 - i);
}

__global__ void vote_kernel(const int32_t* __restrict__ pr, int NS,
                            const int32_t* __restrict__ dupes, int dstride, int D,
                            bool split, int cbits, int pos_bias, int step,
                            int major_req, int minor_req, int P2,
                            int32_t* __restrict__ out) {
  extern __shared__ long long keys[];
  __shared__ long long red[33];
  const int b = blockIdx.x;
  const int P = NS * D;
  const int2* row = reinterpret_cast<const int2*>(pr) + (long long)b * NS;
  for (int p = threadIdx.x; p < P2; p += blockDim.x) {
    long long key = INVALID_KEY;
    if (p < P) {
      const int s = p / D, d = p - s * D;
      const int2 r = __ldg(row + s);
      int32_t cc, cp;
      if (expand(r.x, r.y, d, D, split, dupes, dstride, cbits, pos_bias, cc, cp))
        key = gplong(cc, cp, s * step);
    }
    keys[p] = key;
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const long long a = keys[i], c = keys[ixj];
          if ((a > c) == ((i & k) == 0)) { keys[i] = c; keys[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
  long long best = -1;
  for (int i = threadIdx.x; i < P2; i += blockDim.x)
    best = max(best, run_score(keys, i, P2, -1));
  best = block_max(best, red);
  const int i1 = best < 0 ? 0 : P2 - 1 - (int)(best & 0xFFFFFFFFLL);
  const int c1 = best < 0 ? 0 : (int)(best >> 32);
  long long best2 = -1;
  for (int i = threadIdx.x; i < P2; i += blockDim.x)
    best2 = max(best2, run_score(keys, i, P2, i1));
  best2 = block_max(best2, red);
  if (threadIdx.x == 0) {
    const int i2 = best2 < 0 ? 0 : P2 - 1 - (int)(best2 & 0xFFFFFFFFLL);
    const int c2 = best2 < 0 ? 0 : (int)(best2 >> 32);
    const long long g1 = keys[i1], g2 = keys[i2];
    int32_t* o = out + (long long)b * 5;
    o[0] = (c1 * step >= major_req) && (c2 * step >= minor_req);
    o[1] = (int32_t)(g1 >> 32);
    o[2] = (int32_t)(uint32_t)g1;
    o[3] = (int32_t)(g2 >> 32);
    o[4] = (int32_t)(uint32_t)g2;
  }
}

}  // namespace gf

// pr: (B, NS, 2) int32 pass-1 probe results (sample s at k-mer s*step).
// dupes: split (nd, D, 2) pairs / kv (nd, 8) payloads, row stride dstride.
// out: (B, 5) int32 [ok, h1, l1, h2, l2]. P2: power of two >= NS*D.
extern "C" int gf_vote(const void* pr, int B, int NS, const void* dupes, int dstride,
                       int D, int split, int cbits, int pos_bias, int step,
                       int major_req, int minor_req, int P2, void* out, void* stream) {
  const size_t smem = (size_t)P2 * sizeof(long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf::vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gf::vote_kernel<<<B, gf::VOTE_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pr, NS, (const int32_t*)dupes, dstride, D, split != 0, cbits,
      pos_bias, step, major_req, minor_req, P2, (int32_t*)out);
  return (int)cudaGetLastError();
}
