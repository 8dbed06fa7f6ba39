// Kernel 1: k-mer build + 2-choice hash-table probe.
//
// Replaces the TPU kernel genefuserust_tpu/ops/pallas_lookup.py
// (pallas_lookup / _lookup_kernel) and the XLA probes it stood for,
// ops/map_read.py compute_kmers + kv_lookup (kv rows) / hash_lookup (split).
//
// What bounds it on the H100: each valid query makes two random row loads
// (8*S bytes each; 8 bytes for the kv2 product layout) from a table of up
// to 2^26 rows = 512 MB, ten times the 50 MB L2, so nearly every load is a
// DRAM round trip: the kernel is bound by memory latency and by DRAM
// sector traffic (32 B moved per 8 B row), not by arithmetic.
//
// What the simple design does about it: one thread per query and a large
// grid keep tens of thousands of independent loads in flight to hide the
// latency; both bucket loads are issued before either is compared, as one
// 8- or 16-byte vector load each; invalid queries (a 255 code in the
// window, or past the read) make no table load at all. The k-mer is built
// from the thread's 16 code bytes, which neighbouring threads share
// through L1.
#include "common.cuh"

namespace gf {

template <bool SPLIT, int S>
__global__ void probe_kernel(const uint8_t* __restrict__ codes,
                             const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ kmers,
                             const uint8_t* __restrict__ kvalid, long long n, int W,
                             int stride, int NQ, const int32_t* __restrict__ tbl,
                             const int32_t* __restrict__ vals, int shift, int cbits,
                             int pos_bias, int2* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  uint32_t k = 0;
  bool valid;
  if (codes != nullptr) {
    const long long b = q / NQ;
    const int j = (int)(q - b * NQ) * stride;
    valid = j <= __ldg(lengths + b) - KMER;
    if (valid) {
      const uint8_t* row = codes + b * W + j;
#pragma unroll
      for (int t = 0; t < KMER; ++t) {
        const uint32_t c = __ldg(row + t);
        valid &= c != 255u;
        k = (k << 2) | (c == 255u ? 0u : c);
      }
    }
  } else {
    k = (uint32_t)__ldg(kmers + q);
    valid = __ldg(kvalid + q) != 0;
  }
  int32_t oc = EMPTY, op = 0;
  if (valid) {
    const uint32_t b1 = (k * 0x9E3779B1u) >> shift;
    const uint32_t b2 = ((k ^ (k >> 15)) * 0x85EBCA6Bu + 0xC2B2AE35u) >> shift;
    const int32_t ki = (int32_t)k;
    if constexpr (SPLIT) {
      int32_t r1[S], r2[S];
      load_row<S>(tbl + (long long)b1 * S, r1);
      load_row<S>(tbl + (long long)b2 * S, r2);
      int slot = -1;
      uint32_t bucket = b1;
#pragma unroll
      for (int s = S - 1; s >= 0; --s)
        if (r2[s] == ki) { slot = s; bucket = b2; }
#pragma unroll
      for (int s = S - 1; s >= 0; --s)
        if (r1[s] == ki) { slot = s; bucket = b1; }
      if (slot >= 0) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(vals) +
                             (long long)bucket * S + slot);
        oc = v.x; op = v.y;
      }
    } else {
      int32_t r1[2 * S], r2[2 * S];
      load_row<2 * S>(tbl + (long long)b1 * 2 * S, r1);
      load_row<2 * S>(tbl + (long long)b2 * 2 * S, r2);
      uint32_t p1 = 0, p2 = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (r1[s] == ki) p1 += (uint32_t)r1[S + s];
        if (r2[s] == ki) p2 += (uint32_t)r2[S + s];
      }
      decode(p1 | p2, cbits, pos_bias, oc, op);
    }
  }
  out[q] = make_int2(oc, op);
}

}  // namespace gf

// codes != NULL: query q = (row q / NQ, k-mer (q % NQ) * stride) of the
// (B, W) code rows. codes == NULL: query q is kmers[q] with validity
// valid[q]. split: tbl = keys (nb, 8), vals = (nb*8, 2); else tbl = kv rows
// (nb, 2S). out: (n, 2) int32 [contig, pos].
extern "C" int gf_probe(const void* codes, const void* lengths, const void* kmers,
                        const void* valid, long long n, int W, int stride, int NQ,
                        const void* tbl, const void* vals, int split, int S, int shift,
                        int cbits, int pos_bias, void* out, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  auto c = (const uint8_t*)codes;
  auto l = (const int32_t*)lengths;
  auto km = (const int32_t*)kmers;
  auto kv = (const uint8_t*)valid;
  auto t = (const int32_t*)tbl;
  auto v = (const int32_t*)vals;
  auto o = (int2*)out;
  if (split && S == 8)
    gf::probe_kernel<true, 8><<<blocks, threads, 0, st>>>(c, l, km, kv, n, W, stride, NQ,
                                                           t, v, shift, cbits, pos_bias, o);
  else if (!split && S == 1)
    gf::probe_kernel<false, 1><<<blocks, threads, 0, st>>>(c, l, km, kv, n, W, stride, NQ,
                                                            t, v, shift, cbits, pos_bias, o);
  else if (!split && S == 2)
    gf::probe_kernel<false, 2><<<blocks, threads, 0, st>>>(c, l, km, kv, n, W, stride, NQ,
                                                            t, v, shift, cbits, pos_bias, o);
  else if (!split && S == 4)
    gf::probe_kernel<false, 4><<<blocks, threads, 0, st>>>(c, l, km, kv, n, W, stride, NQ,
                                                            t, v, shift, cbits, pos_bias, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
