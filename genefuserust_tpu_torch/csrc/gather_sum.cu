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
// sector. The card reaches HBM's rate only with enough bytes in flight,
// about its rate times the latency under load, some tens of KB an SM; at
// 8-byte rows (the kv2 table) three quarters of every sector is waste, and
// what counts is the number of rows in flight.
//
// What the design does about it:
//   - A tile is spread over a thread-block cluster of C blocks, each
//     summing 1,024 / C of its rows, so 128 tiles still fill 132 SMs. The
//     cluster's first block adds the others' sums through distributed
//     shared memory and writes the tile's row. uint32 addition wraps as
//     JAX's int32 sum does, in any order, so the result is bit-equal.
//   - A group of lanes reads one row with vector loads of up to 16 bytes,
//     and every thread issues U independent row loads before it adds any:
//     the bytes in flight are set by U and C, what the TPU's DMA ring was
//     for. Rows of whole 16 bytes (W % 4 == 0: the TPU kernels' 512-byte
//     rows) take 4 blocks a tile and 8 loads a thread. Other rows (the
//     kv2 table's 8 bytes among them) take 1 block and 4 loads: at 8 bytes
//     more rows in flight only slowed the gather.
//   - A ring of cp.async.bulk row copies counted on mbarriers, the TPU
//     ring's direct counterpart, lost to these loads on the card at every
//     row width from 512 bytes to 4 KB, so the kernel has none.
// The default shapes are the ones `chip_smoke.py --gather-sweep` chose on
// the card; the sweep builds this file with -D overrides of the macros
// below.
#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef GATHER_WIDE_BLOCKS
#define GATHER_WIDE_BLOCKS 4
#endif
#ifndef GATHER_WIDE_LOADS
#define GATHER_WIDE_LOADS 8
#endif
#ifndef GATHER_NARROW_BLOCKS
#define GATHER_NARROW_BLOCKS 1
#endif
#ifndef GATHER_NARROW_LOADS
#define GATHER_NARROW_LOADS 4
#endif

namespace cg = cooperative_groups;

namespace gf {

constexpr int GATHER_TILE = 1024;
constexpr int MAX_THREADS = 256;  // leaves U rows their registers
static_assert(GATHER_TILE % GATHER_WIDE_BLOCKS == 0 && GATHER_WIDE_BLOCKS <= 8 &&
                  GATHER_TILE % GATHER_NARROW_BLOCKS == 0 && GATHER_NARROW_BLOCKS <= 8,
              "a cluster of at most 8 blocks splits a tile evenly");

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The tile's sum over the cluster: every block holds its own in
// `block_sum`; the first block adds them and writes the tile's row.
__device__ __forceinline__ void cluster_combine(uint32_t* block_sum, int tile, int lanes,
                                                int32_t* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    uint32_t tot = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      tot += *cluster.map_shared_rank(block_sum, r);
    for (int l = threadIdx.x; l < lanes; l += blockDim.x)
      out[(size_t)tile * lanes + l] = (int32_t)tot;
  }
  cluster.sync();  // the others' shared memory lives until it was read
}

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

// Block `rank` of a tile's cluster sums rows [rank*n, (rank+1)*n) of the
// tile, n = 1024 / C. V int32 a vector load (W % V == 0); a group of Lr
// lanes (a power of two dividing 32) reads a row; each group takes rows
// grp, grp + G, ... of the block's slice, U of them at a time, all loaded
// before any is added.
template <int V, int U>
__global__ void __launch_bounds__(MAX_THREADS)
gather_tile_sums_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ tbl,
                        int W, int Lr, int lanes, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[MAX_THREADS / 32];
  __shared__ uint32_t block_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C, n = GATHER_TILE / C;
  const int nv = W / V;
  const int lane = threadIdx.x & (Lr - 1), grp = threadIdx.x / Lr, G = blockDim.x / Lr;
  const int32_t* tidx = idx + (size_t)tile * GATHER_TILE + (size_t)rank * n;
  uint32_t acc = 0;
  for (int r0 = grp; r0 < n; r0 += G * U) {
    int32_t row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * G;
      row[u] = r < n ? __ldg(tidx + r) : -1;
    }
    for (int j = lane; j < nv; j += Lr) {
      uint32_t part[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        part[u] = row[u] >= 0 ? Vec<V>::sum(tbl + (size_t)row[u] * W + (size_t)j * V) : 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) acc += part[u];
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    block_sum = s;
  }
  cluster_combine(&block_sum, tile, lanes, out);
}

template <typename... Params, typename... Args>
static cudaError_t launch_clusters(void (*kernel)(Params...), int tiles, int C, int threads,
                                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one block a tile needs no cluster: a grid without one runs each block
  // as a cluster of its own
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// C blocks a tile, U row loads a thread, in whole warps
template <int V, int U>
static cudaError_t launch(const int32_t* idx, const int32_t* tbl, int tiles, int W, int C,
                          int lanes, int32_t* out, cudaStream_t st) {
  const int nv = W / V;
  int Lr = 1;
  while (Lr * 2 <= nv && Lr * 2 <= 32) Lr *= 2;
  const int n = GATHER_TILE / C;
  const int threads = std::min(MAX_THREADS, std::max(32, (Lr * n / U + 31) / 32 * 32));
  return launch_clusters(gather_tile_sums_kernel<V, U>, tiles, C, threads, st, idx, tbl, W, Lr,
                         lanes, out);
}

}  // namespace gf

// idx (tiles * 1024,) int32 row indices in [0, nb); tbl (nb, W) int32,
// 16-byte aligned -> out (tiles, lanes) int32, lanes 1 or 128.
extern "C" int gf_gather_tile_sums(const void* idx, const void* tbl, int tiles, int W,
                                   int lanes, void* out, void* stream) {
  using namespace gf;
  if (tiles < 0 || W < 1 || (lanes != 1 && lanes != 128)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  auto i = (const int32_t*)idx;
  auto t = (const int32_t*)tbl;
  auto o = (int32_t*)out;
  cudaError_t e;
  if (W % 4 == 0)
    e = launch<4, GATHER_WIDE_LOADS>(i, t, tiles, W, GATHER_WIDE_BLOCKS, lanes, o, st);
  else if (W % 2 == 0)
    e = launch<2, GATHER_NARROW_LOADS>(i, t, tiles, W, GATHER_NARROW_BLOCKS, lanes, o, st);
  else
    e = launch<1, GATHER_NARROW_LOADS>(i, t, tiles, W, GATHER_NARROW_BLOCKS, lanes, o, st);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}
