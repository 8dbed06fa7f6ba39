// Kernel 4: the gather-floor probe. For each tile of 1,024 row indices,
// the wrapping int32 sum of every element of the gathered table rows.
//
// Replaces two TPU kernels of the JAX package's profiling tools:
// tools/profiling/profile_dma_ring.py (build(...).kernel, one int32 per
// tile; lanes = 1) and tools/profiling/profile_pallas_gather.py
// (main().kernel, the same sum broadcast over a 128-lane output row;
// lanes = 128). On the TPU each grid step streamed its rows through a
// ring of NFLIGHT in-flight DMAs into VMEM.
//
// What bounds it on the H100: random rows from a table far over the 50 MB
// L2, so each row is a DRAM round trip and moves at least one 32-byte
// sector. At 8-byte rows (the kv2 table) three quarters of every sector
// is waste and the kernel is latency- and issue-bound, not bound by the
// 3.35 TB/s of HBM; at 512-byte rows it moves whole sectors and comes
// closer to bandwidth.
//
// What the design does about it: one block per tile loads its own 1,024
// indices; a group of lanes reads one row with vector loads (8 B a thread
// at 8-byte rows, a warp per 512-byte row at 16 B a lane); every thread
// issues U independent row loads before it adds any of them, which is
// what the TPU's DMA ring was for. The sum is kept in uint32, which wraps
// exactly as JAX's int32 sum does, and row offsets are size_t, since
// rows * width reaches 2^29 at the TPU shapes.
#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr int GATHER_TILE = 1024;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_UNROLL = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ uint32_t sum(const int32_t* p) { return (uint32_t)__ldg(p); }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ uint32_t sum(const int32_t* p) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    return (uint32_t)v.x + (uint32_t)v.y;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ uint32_t sum(const int32_t* p) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    return (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
  }
};

// V int32 per vector load (W % V == 0); Lr lanes per row, a power of two
// dividing 32.
template <int V>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_tile_sums_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ tbl,
                        int W, int Lr, int lanes, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[GATHER_THREADS / 32];
  const int g = blockIdx.x;
  const int nv = W / V;
  const int lane = threadIdx.x & (Lr - 1);
  const int grp = threadIdx.x / Lr;
  const int G = GATHER_THREADS / Lr;
  const int32_t* tidx = idx + (size_t)g * GATHER_TILE;
  uint32_t acc = 0;
  for (int r0 = grp; r0 < GATHER_TILE; r0 += G * GATHER_UNROLL) {
    int32_t row[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
      const int r = r0 + u * G;
      row[u] = r < GATHER_TILE ? __ldg(tidx + r) : -1;
    }
    for (int j = lane; j < nv; j += Lr) {
      uint32_t part[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u)
        part[u] = row[u] >= 0 ? Vec<V>::sum(tbl + (size_t)row[u] * W + (size_t)j * V) : 0u;
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) acc += part[u];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < GATHER_THREADS / 32; ++w) s += warp_sums[w];
    warp_sums[0] = s;
  }
  __syncthreads();
  if (threadIdx.x < lanes) out[(size_t)g * lanes + threadIdx.x] = (int32_t)warp_sums[0];
}

}  // namespace gf

// idx (tiles * 1024,) int32 row indices in [0, nb); tbl (nb, W) int32 ->
// out (tiles, lanes) int32, lanes 1 or 128.
extern "C" int gf_gather_tile_sums(const void* idx, const void* tbl, int tiles, int W,
                                   int lanes, void* out, void* stream) {
  if (tiles < 0 || W < 1 || (lanes != 1 && lanes != 128)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  const int V = W % 4 == 0 ? 4 : (W % 2 == 0 ? 2 : 1);
  const int nv = W / V;
  int Lr = 1;
  while (Lr * 2 <= nv && Lr * 2 <= 32) Lr *= 2;
  cudaStream_t st = (cudaStream_t)stream;
  auto i = (const int32_t*)idx;
  auto t = (const int32_t*)tbl;
  auto o = (int32_t*)out;
  const dim3 grid(tiles), block(gf::GATHER_THREADS);
  if (V == 4)
    gf::gather_tile_sums_kernel<4><<<grid, block, 0, st>>>(i, t, W, Lr, lanes, o);
  else if (V == 2)
    gf::gather_tile_sums_kernel<2><<<grid, block, 0, st>>>(i, t, W, Lr, lanes, o);
  else
    gf::gather_tile_sums_kernel<1><<<grid, block, 0, st>>>(i, t, W, Lr, lanes, o);
  return (int)cudaGetLastError();
}
