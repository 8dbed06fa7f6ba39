// Kernel 1: k-mer build + hash-table probe.
//
// Replaces the TPU kernel genefuserust_tpu/ops/pallas_lookup.py
// (pallas_lookup / _lookup_kernel, split rows) and its XLA twin
// ops/map_read.py hash_lookup in probe_split_kernel, the XLA probes of the
// other layouts, ops/map_read.py compute_kmers + kv_lookup (kv rows), in
// probe_kernel, and kvs_lookup / kv16_lookup (_single_probe_lookup, the
// single-probe rows of the kvs and kv16 layouts) in probe_single_kernel.
//
// What bounds it on the H100: random table rows. A table of up to 2^26
// rows = 512 MB is ten times the 50 MB L2, so nearly every row load is a
// DRAM round trip that moves a whole 32-byte sector (8-byte kv2 rows
// included): the kernel is bound by DRAM sectors and by how many misses
// the SMs keep in flight, not by arithmetic.
//
// What the design does about it:
//  - h1 first. Keys are unique across both rows and their slots, and the
//    split rule is first-match h1, so a query whose key lies in its h1 row
//    never needs the h2 row: h2 is loaded only for the others. For kv rows
//    this equals `p1 | p2` (empty slots hold the absent-key sentinel with
//    payload 0, so a query equal to the sentinel still decodes to a miss).
//  - Q queries a thread. Each thread takes Q queries of a tile of T*Q and
//    issues all their h1 loads before it compares any, then all their h2
//    loads. Table rows are read with a cache policy POL (ld.global.nc,
//    ld.global.cg, or ld.global.nc with L1::no_allocate).
//    Blocks are persistent: the grid is sized to the card (resident
//    blocks per SM x SMs) and walks the tiles. Q, POL and T are fixed at
//    build time (PROBE_Q, PROBE_POLICY, PROBE_THREADS below; the split and
//    single-probe kernels' own PROBE_SPLIT_* and PROBE_SINGLE_*); a
//    launch-shape sweep rebuilds this file with -D overrides.
//  - Split rows (probe_split_kernel): a key row is 8 int32, one sector. A
//    lane pair looks its two lanes' queries up together, keys 0-3 to the
//    even lane and 4-7 to the odd one, so one warp load instruction asks
//    for 16 whole sectors, each once; the lanes swap their 4-bit matches
//    (the lowest matching slot wins, so the even lane's half first) and h2
//    pieces are loaded only for queries whose key is not in h1. Each lane
//    then reads the 8-byte vals element of its own queries' slots (both
//    lanes know the slot, so no result crosses lanes); a miss or an
//    invalid query reads none. A tile's vals loads are issued with the
//    next tile's h1 pieces (a two-stage pipeline over the tiles a block
//    walks), so the dependent round trip overlaps the next lookup.
//  - Code bytes are read about once. A tile's queries are consecutive
//    (row, k-mer) pairs, so the bytes they touch are one span of the (B, W)
//    rows: from the first query's k-mer to the last one's end. Only that
//    span is staged, never a crossed row whole, so the shared memory a tile
//    takes is bounded by its T*Q queries (about stride bytes each, plus up
//    to 15 unqueried bytes at the end of each row it crosses), whatever W
//    is. It is staged with 16-byte loads: each 16 code bytes become one
//    word of 2-bit bases
//    (shifted in at 2 bits per base, first base highest) and a 16-bit mask
//    of 255 codes. A k-mer is the 32 bits at its offset across two
//    neighbouring words; it is valid when its window holds no mask bit (the
//    last 255 lies before the window) and it starts at or before len - 16.
//    Codes are 0-3, or 255 for a base that is not ACGT.
//  - Single-probe rows (probe_single_kernel, kvs S=4 and kv16 S=8): every
//    key lies in its h1 row unless that row overflowed at pack time; such a
//    row carries the marker payload OVF_PAYLOAD in its last slot. h2 is
//    loaded only for a query whose h1 row is marked and matched no slot
//    with a nonzero payload sum (the absent-key sentinel matches the
//    marker's payload 1, so it loads no h2 row and decodes to EMPTY).
//    A lane pair looks its two lanes' queries up together, a 16-byte piece
//    of a row a lane, so one warp load instruction asks for 16 whole
//    32-byte sectors, each once, and a thread holds 4 int32 a query: kvs,
//    a row [4 keys | 4 payloads] is one sector, keys to the even lane and
//    payloads to the odd one, which sums the matched payloads and reads
//    the marker; kv16, the 8 keys are one sector, 0-3 to the even lane and
//    4-7 to the odd one, and the payload sector is read only where a key
//    matched (by the lane whose half matched) or where the key half leaves
//    a flag possible (the odd lane, for the marker in slot 7). A miss in an
//    unflagged row is then one sector, not two. The flag is possible only
//    where slots 0-6 hold keys other than the sentinel and slot 7 holds
//    the sentinel, because of the packer's invariant: a flagged row keeps
//    S-1 real keys inline and the sentinel with OVF_PAYLOAD in its last
//    slot (ops/hashtable.py::_place_single_hash keeps slots-1 keys inline
//    in a flagged bucket, and its rescue and walk only swap keys of filled
//    slots; ops/index.py::_pack_single writes the marker). On a table
//    without it the results still equal the plain version's, as such a
//    row's h2 row cannot hold the key, but fewer h2 rows may be counted.
//    Where several slots match (only the sentinel can), every matched
//    slot's payload is read and summed, as the plain version does.
//    The tile staging and the k-mer build are probe_kernel's (probe_tiles).
// Invalid queries make no table load at all.
#include "common.cuh"

namespace gf {

enum { POL_NC = 0, POL_CG = 1, POL_NA = 2 };
// table kinds: gf_probe's `split` argument (kv, split), gf_probe_single's
enum { LAYOUT_KV = 0, LAYOUT_SPLIT = 1, LAYOUT_SINGLE = 2 };
constexpr int32_t OVF_PAYLOAD = 1;  // ops/hashtable.py: a marked row's last payload

template <int POL>
__device__ __forceinline__ int2 ld_row2(const int32_t* p) {
  const int2* q = reinterpret_cast<const int2*>(p);
  if constexpr (POL == POL_NC) {
    return __ldg(q);
  } else if constexpr (POL == POL_CG) {
    return __ldcg(q);
  } else {
    int2 v;
    asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];"
        : "=r"(v.x), "=r"(v.y) : "l"(q));
    return v;
  }
}

template <int POL>
__device__ __forceinline__ int4 ld_row4(const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  if constexpr (POL == POL_NC) {
    return __ldg(q);
  } else if constexpr (POL == POL_CG) {
    return __ldcg(q);
  } else {
    int4 v;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(q));
    return v;
  }
}

// N consecutive int32 of a table row (8*S bytes; 16-byte aligned rows)
template <int N, int POL>
__device__ __forceinline__ void load_row(const int32_t* p, int32_t (&v)[N]) {
  if constexpr (N == 2) {
    const int2 t = ld_row2<POL>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(N % 4 == 0, "rows of 2, 4, 8 or 16 int32");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int4 t = ld_row4<POL>(p + 4 * i);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  }
}

__device__ __forceinline__ uint32_t hash1(uint32_t k, int shift) {
  return (k * 0x9E3779B1u) >> shift;
}

__device__ __forceinline__ uint32_t hash2(uint32_t k, int shift) {
  return ((k ^ (k >> 15)) * 0x85EBCA6Bu + 0xC2B2AE35u) >> shift;
}

// Kv row r matched against key ki -> the payload sum of the matching
// slots (at most one real one) and whether any slot matched.
template <int S, int RW>
__device__ __forceinline__ bool match_row(const int32_t (&r)[RW], int32_t ki, uint32_t& pay) {
  bool found = false;
  uint32_t p = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (r[s] == ki) { p += (uint32_t)r[S + s]; found = true; }
  pay = p;
  return found;
}

// The kv lookup of a thread's Q queries: every h1 load first, then the h2
// loads of the queries whose key is not in h1.
template <int S, int Q, int POL>
__device__ __forceinline__ void lookup_q(const uint32_t (&k)[Q], const bool (&valid)[Q],
                                         const int32_t* __restrict__ tbl, int shift,
                                         int cbits, int pos_bias, int2 (&res)[Q],
                                         unsigned& rows) {
  constexpr int RW = 2 * S;
  int32_t row[Q][RW];
  uint32_t pay[Q], bucket[Q];
  bool need2[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    bucket[i] = hash1(k[i], shift);
    if (valid[i]) load_row<RW, POL>(tbl + (size_t)bucket[i] * RW, row[i]);
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    pay[i] = 0;
    need2[i] = valid[i] && !match_row<S, RW>(row[i], (int32_t)k[i], pay[i]);
    rows += (unsigned)valid[i] + (unsigned)need2[i];
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (need2[i]) {
      bucket[i] = hash2(k[i], shift);
      load_row<RW, POL>(tbl + (size_t)bucket[i] * RW, row[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (need2[i]) match_row<S, RW>(row[i], (int32_t)k[i], pay[i]);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    int32_t oc = EMPTY, op = 0;
    if (valid[i]) decode(pay[i], cbits, pos_bias, oc, op);
    res[i] = make_int2(oc, op);
  }
}

// ---- lane pairs (probe_single_kernel, probe_split_kernel) ----

constexpr unsigned ALL = 0xffffffffu;

// bit s: slot s of the 4 in v holds key k
__device__ __forceinline__ unsigned match4(const int4 v, int32_t k) {
  return (unsigned)(v.x == k) | (unsigned)(v.y == k) << 1 | (unsigned)(v.z == k) << 2 |
         (unsigned)(v.w == k) << 3;
}

// the uint32 sum of the payloads of v that the bits of m select
__device__ __forceinline__ uint32_t sum4(const int4 v, unsigned m) {
  return (m & 1 ? (uint32_t)v.x : 0u) + (m & 2 ? (uint32_t)v.y : 0u) +
         (m & 4 ? (uint32_t)v.z : 0u) + (m & 8 ? (uint32_t)v.w : 0u);
}

// A lane pair's 2Q queries: query 2i + o is query i of the pair's lane o.
// -> kj: each query's k-mer, on both lanes; returns bit j: query j is valid
template <int Q>
__device__ __forceinline__ unsigned pair_queries(const uint32_t (&k)[Q], const bool (&valid)[Q],
                                                 uint32_t (&kj)[2 * Q]) {
  const int h = threadIdx.x & 1;
  unsigned vm = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const uint32_t other = __shfl_xor_sync(ALL, k[i], 1);
    kj[2 * i] = h ? other : k[i];
    kj[2 * i + 1] = h ? k[i] : other;
    vm |= (unsigned)valid[i] << i;
  }
  const unsigned vo = __shfl_xor_sync(ALL, vm, 1);
  unsigned v = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    v |= ((h ? vo : vm) >> i & 1u) << (2 * i) | ((h ? vm : vo) >> i & 1u) << (2 * i + 1);
  return v;
}

// This lane's 16-byte piece of the row of rows RW int32 wide at query j's
// h1 bucket (H2: its h2 bucket), for each query j whose bit is set in
// `mask`; the other queries' pieces are left as they are.
template <bool H2, int RW, int POL, int J>
__device__ __forceinline__ void load_pieces(const uint32_t (&kj)[J], unsigned mask,
                                            const int32_t* __restrict__ tbl, int shift,
                                            int4 (&pc)[J]) {
  const int h = threadIdx.x & 1;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (mask >> j & 1) {
      const uint32_t b = H2 ? hash2(kj[j], shift) : hash1(kj[j], shift);
      pc[j] = ld_row4<POL>(tbl + (size_t)b * RW + 4 * h);
    }
}

// The slots of a row holding key k, from the pieces c the pair's lanes
// hold, where `on` (else 0) -> bit s: slot s holds k, on both lanes.
__device__ __forceinline__ unsigned pair_match(bool on, const int4 c, int32_t k) {
  const unsigned x = on ? match4(c, k) << (4 * (threadIdx.x & 1)) : 0u;
  return x | __shfl_xor_sync(ALL, x, 1);
}

// ---- single-probe rows (probe_single_kernel) ----

// The single-probe lookup of a lane pair's 2Q queries (query 2i + o is
// query i of the pair's lane o), a 16-byte piece of each row a lane: every
// h1 piece first, then (kv16) the payload pieces that are needed, then the
// rows of the queries that need h2. `rows` and `sectors` (the even lane
// counts them): the table rows and 32-byte sectors the pair loaded.
template <int S, int Q, int POL>
__device__ __forceinline__ void lookup_single(const uint32_t (&k)[Q], const bool (&valid)[Q],
                                              const int32_t* __restrict__ tbl, int shift,
                                              int cbits, int pos_bias, int32_t sentinel,
                                              int2 (&res)[Q], unsigned& rows,
                                              unsigned& sectors) {
  static_assert(S == 4 || S == 8, "kvs or kv16 rows");
  constexpr int J = 2 * Q, RW = 2 * S;
  const int h = threadIdx.x & 1;           // the piece of a row this lane reads
  const int odd = (threadIdx.x & 31) | 1;  // the pair's odd lane
  uint32_t kj[J];
  const unsigned v = pair_queries<Q>(k, valid, kj);  // bit j: query j is valid
  int4 pc[J];
  uint32_t pay[J];
  unsigned need = 0;  // bit j: query j loads its h2 row
#pragma unroll
  for (int j = 0; j < J; ++j) pc[j] = make_int4(0, 0, 0, 0);
  load_pieces<false, RW, POL>(kj, v, tbl, shift, pc);
  if constexpr (S == 4) {
    // the keys' lane hands its match to the payloads' lane, which sums the
    // matched payloads and reads the marker
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned m = __shfl_xor_sync(ALL, match4(pc[j], (int32_t)kj[j]), 1);
      pay[j] = sum4(pc[j], m);
      if ((v >> j & 1) && pc[j].w == OVF_PAYLOAD && pay[j] == 0) need |= 1u << j;
    }
    need = __shfl_sync(ALL, need, odd);
    if (!h) {
      rows += __popc(v) + __popc(need);
      sectors += __popc(v) + __popc(need);
    }
    if (__any_sync(ALL, need != 0)) {
      load_pieces<true, RW, POL>(kj, need, tbl, shift, pc);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool n2 = need >> j & 1;
        const unsigned m = __shfl_xor_sync(ALL, n2 ? match4(pc[j], (int32_t)kj[j]) : 0u, 1);
        if (n2) pay[j] |= sum4(pc[j], m);
      }
    }
  } else {
    // both lanes learn the row's match (8 bits) and whether its keys leave
    // a flag possible (slots 0-6 real, slot 7 the sentinel)
    unsigned m[J], flaggable = 0, paid = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int4 c = pc[j];
      const bool real3 = c.x != sentinel && c.y != sentinel && c.z != sentinel;
      const bool part = real3 && (h ? c.w == sentinel : c.w != sentinel);
      unsigned x = match4(c, (int32_t)kj[j]) << (4 * h) | (unsigned)part << (8 + h);
      x |= __shfl_xor_sync(ALL, x, 1);
      if (!(v >> j & 1)) x = 0;
      m[j] = x & 0xFFu;
      flaggable |= (unsigned)((x >> 8) == 3u) << j;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      pc[j] = make_int4(0, 0, 0, 0);
      if ((m[j] >> (4 * h) & 15u) || (h && (flaggable >> j & 1)))
        pc[j] = ld_row4<POL>(tbl + (size_t)hash1(kj[j], shift) * RW + S + 4 * h);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t part = sum4(pc[j], m[j] >> (4 * h) & 15u);
      pay[j] = part + __shfl_xor_sync(ALL, part, 1);
      const bool marked = __shfl_sync(ALL, pc[j].w == OVF_PAYLOAD, odd);
      if ((flaggable >> j & 1) && marked && pay[j] == 0) need |= 1u << j;
    }
    if (!h) {
#pragma unroll
      for (int j = 0; j < J; ++j) paid |= (unsigned)(m[j] != 0) << j;
      rows += __popc(v) + __popc(need);
      sectors += __popc(v) + __popc(paid | flaggable);
    }
    if (__any_sync(ALL, need != 0)) {
      unsigned paid2 = 0;
      load_pieces<true, RW, POL>(kj, need, tbl, shift, pc);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        m[j] = pair_match(need >> j & 1, pc[j], (int32_t)kj[j]);
        paid2 |= (unsigned)(m[j] != 0) << j;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        pc[j] = make_int4(0, 0, 0, 0);
        if (m[j] >> (4 * h) & 15u)
          pc[j] = ld_row4<POL>(tbl + (size_t)hash2(kj[j], shift) * RW + S + 4 * h);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t part = sum4(pc[j], m[j] >> (4 * h) & 15u);
        pay[j] |= part + __shfl_xor_sync(ALL, part, 1);
      }
      if (!h) sectors += __popc(need) + __popc(paid2);
    }
  }
  // the odd lane holds every query's sum (kvs: only it): each lane decodes
  // its own queries
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const uint32_t theirs = __shfl_xor_sync(ALL, pay[2 * i], 1);
    int32_t oc = EMPTY, op = 0;
    if (valid[i]) decode(h ? pay[2 * i + 1] : theirs, cbits, pos_bias, oc, op);
    res[i] = make_int2(oc, op);
  }
}

// ---- split rows (probe_split_kernel) ----

// The split lookup of a lane pair's 2Q queries (query 2i + o is query i of
// the pair's lane o), a 16-byte piece of each key row a lane: every h1
// piece first, then the h2 pieces of the queries whose key is not in h1.
// The lanes swap their 4-bit matches, so both hold each query's 8-bit
// match (bit s: slot s) and its first matching slot is the lowest bit. ->
// `at`: for each of this lane's own queries the int32 offset of its vals
// element in `vals`, or -1 (a miss or an invalid query); `rows` and
// `hits`: the key rows and vals elements of the lane's own queries.
template <int Q, int POL>
__device__ __forceinline__ void lookup_split(const uint32_t (&k)[Q], const bool (&valid)[Q],
                                             const int32_t* __restrict__ keys, int shift,
                                             long long (&at)[Q], unsigned& rows,
                                             unsigned& hits) {
  constexpr int J = 2 * Q, S = 8;
  const int h = threadIdx.x & 1;  // the piece of a row this lane reads
  uint32_t kj[J];
  const unsigned v = pair_queries<Q>(k, valid, kj);  // bit j: query j is valid
  int4 pc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) pc[j] = make_int4(0, 0, 0, 0);
  load_pieces<false, S, POL>(kj, v, keys, shift, pc);
  unsigned m[J], need = 0;  // need bit j: query j loads its h2 row
#pragma unroll
  for (int j = 0; j < J; ++j) {
    m[j] = pair_match(v >> j & 1, pc[j], (int32_t)kj[j]);
    if ((v >> j & 1) && m[j] == 0) need |= 1u << j;
  }
  if (__any_sync(ALL, need != 0)) {
    load_pieces<true, S, POL>(kj, need, keys, shift, pc);
#pragma unroll
    for (int j = 0; j < J; ++j) m[j] |= pair_match(need >> j & 1, pc[j], (int32_t)kj[j]);
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int j = 2 * i + h;
    const bool n2 = need >> j & 1;
    at[i] = -1;
    if (m[j]) {
      const uint32_t bucket = n2 ? hash2(k[i], shift) : hash1(k[i], shift);
      at[i] = ((long long)bucket * S + (__ffs(m[j]) - 1)) * 2;
    }
    rows += (unsigned)valid[i] + (unsigned)n2;
    hits += m[j] != 0;
  }
}

// 16 code bytes -> (2-bit bases, first base in the top bits; mask of 255
// codes, first base in bit 15). Bytes at or past `nbytes` read as 255.
__device__ __forceinline__ uint2 pack_chunk(const uint8_t* __restrict__ codes,
                                            long long nbytes, long long ci) {
  uint32_t b[16];
  const long long at = ci * 16;
  if (at + 16 <= nbytes) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + at));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 16; ++t) b[t] = (w[t >> 2] >> (8 * (t & 3))) & 0xFFu;
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t) b[t] = at + t < nbytes ? __ldg(codes + at + t) : 255u;
  }
  uint32_t pk = 0, mk = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const bool bad = b[t] == 255u;
    pk = (pk << 2) | (bad ? 0u : (b[t] & 3u));
    mk = (mk << 1) | (bad ? 1u : 0u);
  }
  return make_uint2(pk, mk);
}

// The tiles of a probe launch, a LAYOUT table. Query q of a tile: (row q /
// NQ, k-mer (q % NQ) * stride) of the (B, W) code rows, or kmers[q] with
// validity kvalid[q] when codes is NULL. When row_loads is not NULL, the
// table rows the launch loads are added to it (split: key rows); when
// sector_loads is not NULL, on single-probe rows the 32-byte sectors it
// requests and on split rows the vals elements it reads are added to it.
// Split rows: a tile's vals loads are issued with the next tile's h1
// pieces, and the last tile's after the walk. The pointers are the
// kernels' own __restrict__ parameters, inlined.
template <int LAYOUT, int S, int Q, int POL, int T>
__device__ __forceinline__ void probe_tiles(const uint8_t* codes, const int32_t* lengths,
                                            const int32_t* kmers, const uint8_t* kvalid,
                                            unsigned n, int W, int stride, int NQ, int nch_max,
                                            const int32_t* tbl, const int32_t* vals, int shift,
                                            int cbits, int pos_bias, int2* out,
                                            unsigned long long* row_loads, int32_t sentinel,
                                            unsigned long long* sector_loads) {
  extern __shared__ uint2 chunks[];  // [nch_max] staged code words, then row lengths
  int* slen = reinterpret_cast<int*>(chunks + nch_max);
  const unsigned tid = threadIdx.x, per_tile = T * Q;
  unsigned rows = 0, sectors = 0;
  const unsigned ntiles = (n + per_tile - 1) / per_tile;
  const long long nbytes = codes != nullptr ? (long long)(n / NQ) * W : 0;
  // split rows: the previous tile's first query and its vals offsets (-1:
  // none)
  unsigned pq0 = n;
  long long pend[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) pend[i] = -1;
  for (unsigned tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const unsigned q0 = tile * per_tile;
    uint32_t k[Q];
    bool valid[Q];
    if (codes != nullptr) {
      // the span from the first query's k-mer to the last one's second
      // chunk; `base` is its first chunk's byte offset in row ra, so a
      // query's offset into the span stays 32-bit
      const unsigned ql = min(n, q0 + per_tile) - 1;
      const unsigned ra = q0 / NQ, rb = ql / NQ;
      const long long c0 = ((long long)ra * W + (long long)(q0 - ra * NQ) * stride) >> 4;
      const int base = (int)(c0 * 16 - (long long)ra * W);
      const int nch = (((int)(rb - ra) * W + (int)(ql - rb * NQ) * stride - base) >> 4) + 2;
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < nch; i += T) chunks[i] = pack_chunk(codes, nbytes, c0 + i);
      for (unsigned r = tid; r <= rb - ra; r += T) slen[r] = __ldg(lengths + ra + r);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const unsigned q = q0 + i * T + tid;
        k[i] = 0;
        valid[i] = false;
        if (q < n) {
          const unsigned row = q / NQ;
          const int j = (int)(q - row * NQ) * stride;
          const int g = (int)(row - ra) * W + j - base;
          const uint2 a = chunks[g >> 4], b = chunks[(g >> 4) + 1];
          const int o = g & 15;
          k[i] = __funnelshift_l(b.x, a.x, 2 * o);
          const uint32_t bad = (((a.y << 16) | b.y) << o) >> 16;
          valid[i] = bad == 0 && j <= slen[row - ra] - KMER;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const unsigned q = q0 + i * T + tid;
        valid[i] = q < n && __ldg(kvalid + q) != 0;
        k[i] = valid[i] ? (uint32_t)__ldg(kmers + q) : 0u;
      }
    }
    int2 res[Q];
    if constexpr (LAYOUT == LAYOUT_SINGLE) {
      lookup_single<S, Q, POL>(k, valid, tbl, shift, cbits, pos_bias, sentinel, res, rows,
                               sectors);
    } else if constexpr (LAYOUT == LAYOUT_SPLIT) {
      // the previous tile's vals, in flight with this tile's h1 pieces
      long long at[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i)
        res[i] = pend[i] >= 0 ? ld_row2<POL>(vals + pend[i]) : make_int2(EMPTY, 0);
      lookup_split<Q, POL>(k, valid, tbl, shift, at, rows, sectors);
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const unsigned q = pq0 + i * T + tid;
        if (q < n) out[q] = res[i];
        pend[i] = at[i];
      }
      pq0 = q0;
      continue;
    } else {
      lookup_q<S, Q, POL>(k, valid, tbl, shift, cbits, pos_bias, res, rows);
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const unsigned q = q0 + i * T + tid;
      if (q < n) out[q] = res[i];
    }
  }
  if constexpr (LAYOUT == LAYOUT_SPLIT) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const unsigned q = pq0 + i * T + tid;
      if (q < n) out[q] = pend[i] >= 0 ? ld_row2<POL>(vals + pend[i]) : make_int2(EMPTY, 0);
    }
  }
  if (row_loads != nullptr) {  // every thread of the block gets here
    rows = __reduce_add_sync(0xFFFFFFFFu, rows);
    if ((tid & 31) == 0 && rows) atomicAdd(row_loads, (unsigned long long)rows);
  }
  if constexpr (LAYOUT != LAYOUT_KV) {
    if (sector_loads != nullptr) {
      sectors = __reduce_add_sync(0xFFFFFFFFu, sectors);
      if ((tid & 31) == 0 && sectors) atomicAdd(sector_loads, (unsigned long long)sectors);
    }
  }
}

// kv rows (S = 1, 2, 4)
template <int S, int Q, int POL, int T>
__global__ void __launch_bounds__(512)
probe_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
             const int32_t* __restrict__ kmers, const uint8_t* __restrict__ kvalid,
             unsigned n, int W, int stride, int NQ, int nch_max,
             const int32_t* __restrict__ tbl, const int32_t* __restrict__ vals, int shift,
             int cbits, int pos_bias, int2* __restrict__ out,
             unsigned long long* __restrict__ row_loads) {
  probe_tiles<LAYOUT_KV, S, Q, POL, T>(
      codes, lengths, kmers, kvalid, n, W, stride, NQ, nch_max, tbl, vals, shift, cbits,
      pos_bias, out, row_loads, 0, nullptr);
}

// split rows: keys (nb, 8), vals (nb*8, 2) [contig, pos]; vals_loads: the
// vals elements read (a hit's one each)
template <int Q, int POL, int T>
__global__ void __launch_bounds__(T)
probe_split_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ kmers, const uint8_t* __restrict__ kvalid,
                   unsigned n, int W, int stride, int NQ, int nch_max,
                   const int32_t* __restrict__ keys, const int32_t* __restrict__ vals, int shift,
                   int2* __restrict__ out, unsigned long long* __restrict__ row_loads,
                   unsigned long long* __restrict__ vals_loads) {
  probe_tiles<LAYOUT_SPLIT, 8, Q, POL, T>(codes, lengths, kmers, kvalid, n, W, stride, NQ,
                                          nch_max, keys, vals, shift, 0, 0, out, row_loads, 0,
                                          vals_loads);
}

// single-probe rows: kvs (S = 4) or kv16 (S = 8); sentinel: the table's
// absent key (its empty slots' key and a flagged row's last)
template <int S, int Q, int POL, int T>
__global__ void __launch_bounds__(T)
probe_single_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ kmers, const uint8_t* __restrict__ kvalid,
                    unsigned n, int W, int stride, int NQ, int nch_max,
                    const int32_t* __restrict__ tbl, int shift, int cbits, int pos_bias,
                    int32_t sentinel, int2* __restrict__ out,
                    unsigned long long* __restrict__ row_loads,
                    unsigned long long* __restrict__ sector_loads) {
  probe_tiles<LAYOUT_SINGLE, S, Q, POL, T>(codes, lengths, kmers, kvalid, n, W, stride, NQ,
                                          nch_max, tbl, nullptr, shift, cbits, pos_bias, out,
                                          row_loads, sentinel, sector_loads);
}

}  // namespace gf

#ifndef PROBE_Q
#define PROBE_Q 4  // queries a thread
#endif
#ifndef PROBE_POLICY
#define PROBE_POLICY 1  // table-row cache policy: 0 nc, 1 cg, 2 nc + L1::no_allocate
#endif
#ifndef PROBE_THREADS
#define PROBE_THREADS 256  // threads a block
#endif
// the single-probe variant's queries a thread (a lane pair looks up twice
// as many together) and threads a block: one query a thread in blocks of
// 128, as `chip_smoke.py --probe-sweep` chose on the card (more warps,
// and fewer of them held at a tile's barriers by the slowest row load)
#ifndef PROBE_SINGLE_Q
#define PROBE_SINGLE_Q 1
#endif
#ifndef PROBE_SINGLE_THREADS
#define PROBE_SINGLE_THREADS 128
#endif
// the split kernel's queries a thread (a lane pair looks up twice as many
// together), table-row cache policy and threads a block: one query a
// thread, ld.global.cg, blocks of 512, as `chip_smoke.py --probe-sweep`
// chose on the card (one query a thread was 7.5% faster than the old
// kernel on a 24 GiB table and even with it on the panel's, two or four
// slower on both)
#ifndef PROBE_SPLIT_Q
#define PROBE_SPLIT_Q 1
#endif
#ifndef PROBE_SPLIT_POLICY
#define PROBE_SPLIT_POLICY 1
#endif
#ifndef PROBE_SPLIT_THREADS
#define PROBE_SPLIT_THREADS 512
#endif
static_assert(PROBE_Q >= 1 && PROBE_THREADS % 32 == 0 && PROBE_THREADS <= 512 &&
                  PROBE_POLICY >= 0 && PROBE_POLICY <= 2,
              "a probe launch shape the kernel does not take");
static_assert(PROBE_SINGLE_Q >= 1 && PROBE_SINGLE_Q <= 16 && PROBE_SINGLE_THREADS % 32 == 0 &&
                  PROBE_SINGLE_THREADS <= 1024,
              "a single-probe launch shape the kernel does not take");
static_assert(PROBE_SPLIT_Q >= 1 && PROBE_SPLIT_Q <= 16 && PROBE_SPLIT_THREADS % 32 == 0 &&
                  PROBE_SPLIT_THREADS <= 1024 && PROBE_SPLIT_POLICY >= 0 &&
                  PROBE_SPLIT_POLICY <= 2,
              "a split launch shape the kernel does not take");

namespace {

struct ProbeArgs {
  const uint8_t* codes;
  const int32_t* lengths;
  const int32_t* kmers;
  const uint8_t* kvalid;
  unsigned n;
  int W, stride, NQ;
  const int32_t* tbl;
  const int32_t* vals;
  int shift, cbits, pos_bias;
  int2* out;
  unsigned long long* row_loads;
};

// The launch shape of kern at Q queries a thread and T threads a block:
// the tile's staged chunks, its shared memory and a grid of the blocks the
// card holds at once (persistent blocks walk the tiles) -> a CUDA error.
template <int Q, int T, class Kernel>
int probe_shape(Kernel kern, const ProbeArgs& a, int& nch_max, size_t& smem, unsigned& grid) {
  nch_max = 0;
  smem = 0;
  if (a.codes != nullptr) {
    // rows a tile of T*Q queries can touch, and the 16-byte chunks of its
    // span: T*Q - 1 steps of `stride` bases, plus the W - NQ*stride bases
    // after a row's last k-mer start at each row boundary it crosses (+3:
    // the straddled first chunk, the partial last one, and the last k-mer's
    // neighbour)
    const long long rows_max = ((long long)T * Q - 1) / a.NQ + 2;
    const long long tail = a.W - (long long)a.NQ * a.stride;
    const long long span =
        (long long)a.stride * (T * Q - 1) + (rows_max - 1) * (tail > 0 ? tail : 0);
    nch_max = (int)(span / 16 + 3);
    smem = (size_t)nch_max * sizeof(uint2) + (size_t)rows_max * sizeof(int);
  }
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T, smem)) !=
          cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned tiles = (a.n + (unsigned)(T * Q) - 1) / (unsigned)(T * Q);
  grid = tiles < (unsigned)(per_sm * sms) ? tiles : (unsigned)(per_sm * sms);
  return 0;
}

constexpr int Q = PROBE_Q, T = PROBE_THREADS;

// kern: an instance of probe_kernel
template <class Kernel>
int probe_launch(Kernel kern, const ProbeArgs& a, cudaStream_t st) {
  int nch_max;
  size_t smem;
  unsigned grid;
  if (const int e = probe_shape<Q, T>(kern, a, nch_max, smem, grid)) return e;
  kern<<<grid, T, smem, st>>>(a.codes, a.lengths, a.kmers, a.kvalid, a.n, a.W, a.stride, a.NQ,
                              nch_max, a.tbl, a.vals, a.shift, a.cbits, a.pos_bias, a.out,
                              a.row_loads);
  return (int)cudaGetLastError();
}

constexpr int SQ = PROBE_SINGLE_Q, ST = PROBE_SINGLE_THREADS;

// kern: an instance of probe_single_kernel
template <class Kernel>
int probe_single_launch(Kernel kern, const ProbeArgs& a, int32_t sentinel,
                        unsigned long long* sector_loads, cudaStream_t st) {
  int nch_max;
  size_t smem;
  unsigned grid;
  if (const int e = probe_shape<SQ, ST>(kern, a, nch_max, smem, grid)) return e;
  kern<<<grid, ST, smem, st>>>(a.codes, a.lengths, a.kmers, a.kvalid, a.n, a.W, a.stride, a.NQ,
                               nch_max, a.tbl, a.shift, a.cbits, a.pos_bias, sentinel, a.out,
                               a.row_loads, sector_loads);
  return (int)cudaGetLastError();
}

constexpr int PQ = PROBE_SPLIT_Q, PT = PROBE_SPLIT_THREADS;

int probe_split_launch(const ProbeArgs& a, unsigned long long* vals_loads, cudaStream_t st) {
  const auto kern = gf::probe_split_kernel<PQ, PROBE_SPLIT_POLICY, PT>;
  int nch_max;
  size_t smem;
  unsigned grid;
  if (const int e = probe_shape<PQ, PT>(kern, a, nch_max, smem, grid)) return e;
  kern<<<grid, PT, smem, st>>>(a.codes, a.lengths, a.kmers, a.kvalid, a.n, a.W, a.stride, a.NQ,
                               nch_max, a.tbl, a.vals, a.shift, a.out, a.row_loads, vals_loads);
  return (int)cudaGetLastError();
}

}  // namespace

// codes != NULL: query q = (row q / NQ, k-mer (q % NQ) * stride) of the
// (n / NQ, W) code rows, 16-byte aligned. codes == NULL: query q is
// kmers[q] with validity valid[q]. split: the table kind, LAYOUT_KV (0)
// only: tbl = kv rows (nb, 2S), S 1, 2 or 4 (vals unused); split rows take
// gf_probe_split, single-probe rows gf_probe_single. out: (n, 2) int32
// [contig, pos]. row_loads: NULL, or a device counter the launch adds its
// table row loads to (h1 rows, h2 rows).
extern "C" int gf_probe(const void* codes, const void* lengths, const void* kmers,
                        const void* valid, long long n, int W, int stride, int NQ,
                        const void* tbl, const void* vals, int split, int S, int shift,
                        int cbits, int pos_bias, void* out, void* row_loads, void* stream) {
  if (n < 0 || n >= (1LL << 31) || NQ < 1) return (int)cudaErrorInvalidValue;
  const ProbeArgs a{(const uint8_t*)codes, (const int32_t*)lengths, (const int32_t*)kmers,
                    (const uint8_t*)valid, (unsigned)n, W, stride, NQ,
                    (const int32_t*)tbl, (const int32_t*)vals, shift, cbits, pos_bias,
                    (int2*)out, (unsigned long long*)row_loads};
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int P = PROBE_POLICY;
  if (split == gf::LAYOUT_KV && S == 1) return probe_launch(gf::probe_kernel<1, Q, P, T>, a, st);
  if (split == gf::LAYOUT_KV && S == 2) return probe_launch(gf::probe_kernel<2, Q, P, T>, a, st);
  if (split == gf::LAYOUT_KV && S == 4) return probe_launch(gf::probe_kernel<4, Q, P, T>, a, st);
  return (int)cudaErrorInvalidValue;
}

// The split rows: keys (nb, 8) int32 on a 32-byte boundary (a row one
// sector), vals (nb*8, 2) int32 [contig, pos] on an 8-byte one. codes,
// kmers, out as gf_probe's. row_loads, vals_loads: NULL, or device
// counters the launch adds its key rows (h1 rows, h2 rows) and its vals
// elements (a hit's one each) to.
extern "C" int gf_probe_split(const void* codes, const void* lengths, const void* kmers,
                              const void* valid, long long n, int W, int stride, int NQ,
                              const void* keys, const void* vals, int shift, void* out,
                              void* row_loads, void* vals_loads, void* stream) {
  if (n < 0 || n >= (1LL << 31) || NQ < 1) return (int)cudaErrorInvalidValue;
  const ProbeArgs a{(const uint8_t*)codes, (const int32_t*)lengths, (const int32_t*)kmers,
                    (const uint8_t*)valid, (unsigned)n, W, stride, NQ,
                    (const int32_t*)keys, (const int32_t*)vals, shift, 0, 0,
                    (int2*)out, (unsigned long long*)row_loads};
  return probe_split_launch(a, (unsigned long long*)vals_loads, (cudaStream_t)stream);
}

// The split kernel's launch shape in this build: queries a thread, threads
// a block.
extern "C" void gf_probe_split_shape(int* q, int* threads) {
  *q = PQ;
  *threads = PT;
}

// The single-probe rows: tbl (nb, 2S) int32, S 4 (kvs) or 8 (kv16), on a
// 32-byte boundary (a kvs row, and each half of a kv16 row, one sector);
// sentinel: the table's absent key. codes, kmers, out as gf_probe's.
// row_loads, sector_loads: NULL, or device counters the launch adds its
// table rows (h1 rows, h2 rows) and the 32-byte sectors it requests to.
extern "C" int gf_probe_single(const void* codes, const void* lengths, const void* kmers,
                               const void* valid, long long n, int W, int stride, int NQ,
                               const void* tbl, int S, int shift, int cbits, int pos_bias,
                               int sentinel, void* out, void* row_loads, void* sector_loads,
                               void* stream) {
  if (n < 0 || n >= (1LL << 31) || NQ < 1) return (int)cudaErrorInvalidValue;
  const ProbeArgs a{(const uint8_t*)codes, (const int32_t*)lengths, (const int32_t*)kmers,
                    (const uint8_t*)valid, (unsigned)n, W, stride, NQ,
                    (const int32_t*)tbl, nullptr, shift, cbits, pos_bias,
                    (int2*)out, (unsigned long long*)row_loads};
  cudaStream_t st = (cudaStream_t)stream;
  auto* sectors = (unsigned long long*)sector_loads;
  constexpr int P = PROBE_POLICY;
  if (S == 4)
    return probe_single_launch(gf::probe_single_kernel<4, SQ, P, ST>, a, sentinel, sectors, st);
  if (S == 8)
    return probe_single_launch(gf::probe_single_kernel<8, SQ, P, ST>, a, sentinel, sectors, st);
  return (int)cudaErrorInvalidValue;
}
