// gfnative: native host runtime for the tpu-genefuse engine.
//
// Covers the host-side hot paths that numpy handles poorly:
//   - rolling k-mer extraction over panel slices (reference:
//     src/core/indexer.rs:179-241 semantics, including the final-k-mer
//     exclusion off-by-one)
//   - stable grouping of (kmer, contig, pos) entries by kmer
//   - sequential 2-choice + cuckoo-eviction placement of the device hash
//     table (tight load factors the vectorized numpy builder can't reach)
//
// C ABI, loaded via ctypes (no pybind11 in this image). All buffers are
// caller-allocated numpy arrays.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Rolling 16-mers with validity over 2-bit codes (255 = invalid base).
// Emits entries for positions [0, n_kmers_limit) where the window is clean.
// Returns the number of entries written.
int64_t gf_rolling_entries(const uint8_t* codes, int64_t n,
                           int32_t contig, int32_t start_offset,
                           int64_t exclude_last,  // 1: drop final kmer (index build)
                           uint32_t* out_kmers, int32_t* out_ctg,
                           int32_t* out_pos) {
  const int K = 16;
  if (n < K) return 0;
  int64_t limit = n - K + 1 - (exclude_last ? 1 : 0);
  if (limit <= 0) return 0;
  int64_t m = 0;
  uint32_t kmer = 0;
  int run = 0;  // consecutive valid codes ending at current position
  // warm up first K-1 bases
  for (int64_t i = 0; i < n && (i < limit + K - 1); ++i) {
    uint8_t c = codes[i];
    if (c > 3) {
      run = 0;
      kmer = 0;
    } else {
      kmer = (kmer << 2) | c;
      ++run;
    }
    int64_t p = i - K + 1;  // kmer start position
    if (p >= 0 && p < limit && run >= K) {
      out_kmers[m] = kmer;
      out_ctg[m] = contig;
      out_pos[m] = (int32_t)(p + start_offset);
      ++m;
    }
  }
  return m;
}

// Stable argsort of entries by kmer via 3-pass LSD radix (11/11/10 bits);
// radix passes are inherently stable. order_out receives the permutation.
void gf_stable_sort_by_kmer(const uint32_t* kmers, int64_t n,
                            int64_t* order_out) {
  std::vector<int64_t> cur(n), nxt(n);
  for (int64_t i = 0; i < n; ++i) cur[i] = i;
  const int bits[3] = {11, 11, 10};
  int shift = 0;
  for (int pass = 0; pass < 3; ++pass) {
    int b = bits[pass];
    int64_t buckets = 1ll << b;
    uint32_t mask = (uint32_t)(buckets - 1);
    std::vector<int64_t> count((size_t)buckets + 1, 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[((kmers[cur[i]] >> shift) & mask) + 1];
    for (int64_t i = 0; i < buckets; ++i) count[i + 1] += count[i];
    for (int64_t i = 0; i < n; ++i) {
      uint32_t d = (kmers[cur[i]] >> shift) & mask;
      nxt[count[d]++] = cur[i];
    }
    cur.swap(nxt);
    shift += b;
  }
  std::memcpy(order_out, cur.data(), (size_t)n * sizeof(int64_t));
}

// Stable radix sort of (kmer, contig, pos) records by kmer, emitting the
// permuted columns directly (no random-gather permute left to the caller).
//
// Structure (genome-scale hot path; the reference parallelizes its index
// build via rayon, src/core/matcher.rs:154-161 — this is the TPU repo's
// host analog): a parallel stable MSD partition on the high 11 bits
// (per-thread block histograms -> bucket-major/thread-minor offsets ->
// parallel scatter), then per-bucket stable LSD on the low 21 bits, each
// bucket being cache-resident (~n/2048 records), processed by a thread
// pool. One full-size DRAM scatter pass total instead of three.
void gf_sort_entries_by_kmer(const uint32_t* kmers,
                             const int32_t* ctgs,
                             const int32_t* poss, int64_t n,
                             uint32_t* k_out, int32_t* c_out,
                             int32_t* p_out) {
  struct Rec {
    uint32_t k;
    int32_t c;
    int32_t p;
  };
  if (n <= 0) return;
  const int HB = 11;              // MSD partition width
  const int64_t NB = 1ll << HB;   // 2048 top-level buckets
  const int HS = 32 - HB;         // 21 low bits remain per bucket
  int T = (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  if (n < (1 << 16)) T = 1;
  std::unique_ptr<Rec[]> buf(new Rec[(size_t)n]);  // no zero-init
  auto blk = [&](int t, int64_t* lo, int64_t* hi) {
    *lo = n * t / T;
    *hi = n * (t + 1) / T;
  };
  // per-thread histograms of the high bits
  std::vector<std::vector<int64_t>> hist(
      (size_t)T, std::vector<int64_t>((size_t)NB, 0));
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        int64_t lo, hi;
        blk(t, &lo, &hi);
        int64_t* h = hist[t].data();
        for (int64_t i = lo; i < hi; ++i) ++h[kmers[i] >> HS];
      });
    for (auto& th : ths) th.join();
  }
  // exclusive offsets: bucket-major, thread-minor (stability across blocks)
  std::vector<int64_t> bstart((size_t)NB + 1, 0);
  {
    int64_t run = 0;
    for (int64_t b = 0; b < NB; ++b) {
      bstart[b] = run;
      for (int t = 0; t < T; ++t) {
        int64_t c = hist[t][b];
        hist[t][b] = run;
        run += c;
      }
    }
    bstart[NB] = run;
  }
  // parallel stable scatter into top-level buckets
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        int64_t lo, hi;
        blk(t, &lo, &hi);
        int64_t* off = hist[t].data();
        for (int64_t i = lo; i < hi; ++i) {
          uint32_t b = kmers[i] >> HS;
          buf[off[b]++] = {kmers[i], ctgs[i], poss[i]};
        }
      });
    for (auto& th : ths) th.join();
  }
  // per-bucket LSD (11 + 10 low bits), cache-resident; then column copy-out
  std::atomic<int64_t> next{0};
  auto worker = [&] {
    std::vector<Rec> scratch;
    std::vector<int64_t> cnt((size_t)(1 << 11) + 1);
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= NB) break;
      const int64_t lo = bstart[b], hi = bstart[b + 1], m = hi - lo;
      if (m > 1) {
        if ((int64_t)scratch.size() < m) scratch.resize((size_t)m);
        const int bits2[2] = {11, 10};
        int shift = 0;
        Rec* src = buf.get() + lo;
        Rec* dst = scratch.data();
        for (int pass = 0; pass < 2; ++pass) {
          const int64_t nb2 = 1ll << bits2[pass];
          const uint32_t mask = (uint32_t)(nb2 - 1);
          std::fill(cnt.begin(), cnt.begin() + nb2 + 1, 0);
          for (int64_t i = 0; i < m; ++i)
            ++cnt[((src[i].k >> shift) & mask) + 1];
          for (int64_t i = 0; i < nb2; ++i) cnt[i + 1] += cnt[i];
          for (int64_t i = 0; i < m; ++i) {
            uint32_t d = (src[i].k >> shift) & mask;
            dst[cnt[d]++] = src[i];
          }
          std::swap(src, dst);
          shift += bits2[pass];
        }
        // two passes: result landed back at buf+lo
      }
      for (int64_t i = lo; i < hi; ++i) {
        k_out[i] = buf[i].k;
        c_out[i] = buf[i].c;
        p_out[i] = buf[i].p;
      }
    }
  };
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t) ths.emplace_back(worker);
    for (auto& th : ths) th.join();
  }
}

// Group boundaries of a kmer-sorted array: writes the start index of each
// distinct-key run into out_starts (ascending) and returns the run count.
// Parallel two-pass (per-block boundary counts -> prefix -> fill).
int64_t gf_group_starts(const uint32_t* kmers, int64_t n,
                        int64_t* out_starts) {
  if (n <= 0) return 0;
  int T = (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  if (n < (1 << 18)) T = 1;
  std::vector<int64_t> cnt((size_t)T, 0);
  auto is_start = [&](int64_t i) {
    return i == 0 || kmers[i] != kmers[i - 1];
  };
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        int64_t lo = n * t / T, hi = n * (t + 1) / T, c = 0;
        for (int64_t i = lo; i < hi; ++i) c += is_start(i);
        cnt[t] = c;
      });
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> off((size_t)T + 1, 0);
  for (int t = 0; t < T; ++t) off[t + 1] = off[t] + cnt[t];
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        int64_t lo = n * t / T, hi = n * (t + 1) / T, w = off[t];
        for (int64_t i = lo; i < hi; ++i)
          if (is_start(i)) out_starts[w++] = i;
      });
    for (auto& th : ths) th.join();
  }
  return off[T];
}

static inline uint32_t h1(uint32_t k, int shift) {
  return (uint32_t)(k * 0x9E3779B1u) >> shift;
}
static inline uint32_t h2(uint32_t k, int shift) {
  return (uint32_t)((k ^ (k >> 15)) * 0x85EBCA6Bu + 0xC2B2AE35u) >> shift;
}

// Static cuckoo placement for slots==1 via XOR-peeling over the cuckoo
// graph: buckets are nodes, each key an edge between its two candidate
// buckets. Peel degree-1 buckets (their sole incident key is forced
// there), then orient the remaining pure cycles; a component with more
// keys than buckets is infeasible and reports failures so the caller
// doubles nb. O(n + nb) with no eviction chains — replaces the
// random-walk path, whose chains blow up near the slots=1 feasibility
// bound (load 0.5): 111s -> seconds at 30M keys (PERF.md round 3).
// Deterministic (no RNG). Any valid placement is equivalent at lookup
// time (probes check both buckets).
static int64_t pack_table_peel(const uint32_t* keys, const int32_t* contigs,
                               const int32_t* poss, int64_t n,
                               int32_t* table, int64_t nb, int32_t shift) {
  // per-bucket state packed into ONE u64 so every graph touch is a single
  // cache line: [deg:16 | pad:7 | used:1 | pad:8 | xs:32]
  constexpr uint64_t DEG1 = 1ULL << 48;
  constexpr uint64_t USED = 1ULL << 40;
  std::vector<uint64_t> node((size_t)nb, 0);
  // degree/xs build: parallel with relaxed atomics (buckets are shared)
  {
    int T = (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (T > 16) T = 16;
    if (n < (1 << 20)) T = 1;
    std::vector<std::thread> ths;
    for (int t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        int64_t lo = n * t / T, hi = n * (t + 1) / T;
        for (int64_t e = lo; e < hi; ++e) {
          uint32_t b1 = h1(keys[e], shift), b2 = h2(keys[e], shift);
          __atomic_fetch_add(&node[b1], DEG1, __ATOMIC_RELAXED);
          __atomic_fetch_xor(&node[b1], (uint64_t)(uint32_t)e,
                             __ATOMIC_RELAXED);
          if (b2 != b1) {
            __atomic_fetch_add(&node[b2], DEG1, __ATOMIC_RELAXED);
            __atomic_fetch_xor(&node[b2], (uint64_t)(uint32_t)e,
                               __ATOMIC_RELAXED);
          }
        }
      });
    for (auto& th : ths) th.join();
  }
  std::vector<uint8_t> assigned((size_t)n, 0);
  auto place1 = [&](int64_t e, uint32_t b) {
    int64_t base = (int64_t)b * 3;
    table[base] = (int32_t)keys[e];
    table[base + 1] = contigs[e];
    table[base + 2] = poss[e];
    node[b] |= USED;
    assigned[e] = 1;
  };
  auto remove_edge = [&](int64_t e) {
    uint32_t b1 = h1(keys[e], shift), b2 = h2(keys[e], shift);
    node[b1] -= DEG1; node[b1] ^= (uint32_t)e;
    if (b2 != b1) { node[b2] -= DEG1; node[b2] ^= (uint32_t)e; }
  };
  auto deg_of = [&](uint32_t b) { return (uint32_t)(node[b] >> 48); };
  auto used_of = [&](uint32_t b) { return (node[b] & USED) != 0; };
  auto xs_of = [&](uint32_t b) { return (uint32_t)node[b]; };
  // phase 1: peel degree-1 buckets frontier-by-frontier (the frontier
  // array enables software prefetch across the random node/key touches)
  std::vector<uint32_t> q, nxt;
  q.reserve(1 << 16);
  nxt.reserve(1 << 16);
  for (int64_t b = 0; b < nb; ++b)
    if ((node[b] >> 48) == 1) q.push_back((uint32_t)b);
  constexpr size_t PF = 8;
  while (!q.empty()) {
    const size_t m = q.size();
    for (size_t i = 0; i < m; ++i) {
      if (i + PF < m) __builtin_prefetch(&node[q[i + PF]]);
      uint32_t b = q[i];
      uint64_t st = node[b];
      if ((st >> 48) != 1 || (st & USED)) continue;
      int64_t e = (uint32_t)st;
      place1(e, b);
      uint32_t b1 = h1(keys[e], shift), b2 = h2(keys[e], shift);
      uint32_t o = (b == b1) ? b2 : b1;
      remove_edge(e);
      if (o != b && deg_of(o) == 1 && !used_of(o)) nxt.push_back(o);
    }
    q.swap(nxt);
    nxt.clear();
  }
  // phase 2: remaining components are cycles (feasible) or denser
  // (infeasible); walk each cycle, forcing direction from the first edge
  int64_t failed = 0;
  for (int64_t e0 = 0; e0 < n; ++e0) {
    if (assigned[e0]) continue;
    uint32_t c1 = h1(keys[e0], shift), c2 = h2(keys[e0], shift);
    uint32_t b;
    if (!used_of(c1)) b = c1;
    else if (!used_of(c2)) b = c2;
    else { ++failed; continue; }
    int64_t cur = e0;
    while (true) {
      place1(cur, b);
      uint32_t b1 = h1(keys[cur], shift), b2 = h2(keys[cur], shift);
      uint32_t o = (b == b1) ? b2 : b1;
      remove_edge(cur);
      if (o == b || used_of(o) || deg_of(o) != 1) break;  // closed or stuck
      cur = xs_of(o);
      b = o;
      if (assigned[cur]) break;
    }
  }
  if (!failed)
    for (int64_t e = 0; e < n; ++e)
      if (!assigned[e]) { failed = 1; break; }
  return failed;
}

// Sequential 2-choice placement with cuckoo-eviction fallback.
// table layout: (nb, slots, 3) int32 rows [key, contig, pos]; empty contig
// sentinel must be pre-filled by the caller (-3). Returns 0 on success,
// number of unplaceable keys on failure. slots==1 dispatches to the
// XOR-peel matcher above.
int64_t gf_pack_table(const uint32_t* keys, const int32_t* contigs,
                      const int32_t* poss, int64_t n, int32_t* table,
                      int64_t nb, int32_t shift, int32_t slots) {
  if (slots == 1 && n < ((int64_t)1 << 31))
    return pack_table_peel(keys, contigs, poss, n, table, nb, shift);
  std::vector<uint8_t> fill((size_t)nb, 0);
  auto place = [&](uint32_t key, int32_t ctg, int32_t pos, uint32_t b) {
    int64_t base = ((int64_t)b * slots + fill[b]) * 3;
    table[base] = (int32_t)key;
    table[base + 1] = ctg;
    table[base + 2] = pos;
    ++fill[b];
  };
  int64_t failed = 0;
  std::mt19937 rng(12345);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t k = keys[i];
    uint32_t b1 = h1(k, shift), b2 = h2(k, shift);
    uint32_t b = (fill[b1] <= fill[b2]) ? b1 : b2;
    if (fill[b] < slots) {
      place(k, contigs[i], poss[i], b);
      continue;
    }
    uint32_t bo = (b == b1) ? b2 : b1;
    if (fill[bo] < slots) {
      place(k, contigs[i], poss[i], bo);
      continue;
    }
    // cuckoo random walk
    uint32_t ck = k;
    int32_t cc = contigs[i], cp = poss[i];
    uint32_t cb = b1;
    bool ok = false;
    for (int kick = 0; kick < 1000; ++kick) {
      if (fill[cb] < slots) {
        place(ck, cc, cp, cb);
        ok = true;
        break;
      }
      int s = (int)(rng() % slots);
      int64_t base = ((int64_t)cb * slots + s) * 3;
      uint32_t vk = (uint32_t)table[base];
      int32_t vc = table[base + 1], vp = table[base + 2];
      table[base] = (int32_t)ck;
      table[base + 1] = cc;
      table[base + 2] = cp;
      ck = vk; cc = vc; cp = vp;
      cb = (h1(ck, shift) == cb) ? h2(ck, shift) : h1(ck, shift);
    }
    if (!ok) ++failed;
  }
  return failed;
}

// Quirk-faithful Matcher genome scan (reference src/core/matcher.rs:227-289
// via the mistranslated make_kmer, :810-885 — see core/matcher.py's module
// docstring). A position i in [0, n-16) is indexed iff:
//   - codes[i] is a valid base (run ending at i is > 0),
//   - the preceding min(run,16)-1 bases are all 'A' (code 0) — this is
//     exactly the "masked k-mer value <= 3" condition, and
//   - bit codes[i] of bloom_mask is set.
// The stored key is codes[i] (in 0..3). Single streaming pass with two
// capped run counters; chunk-parallel over threads (16-base lookback
// rebuilds the capped state exactly).
int64_t gf_matcher_scan(const uint8_t* codes, int64_t n, uint8_t bloom_mask,
                        int32_t* out_pos, uint8_t* out_key) {
  const int K = 16;
  const int64_t m = n - K;
  if (m <= 0) return 0;
  int T = (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  if (m < (1 << 18)) T = 1;
  // per-chunk outputs then stitch (keeps ascending position order)
  std::vector<std::vector<int32_t>> cpos((size_t)T);
  std::vector<std::vector<uint8_t>> ckey((size_t)T);
  std::vector<std::thread> ths;
  for (int t = 0; t < T; ++t)
    ths.emplace_back([&, t] {
      int64_t lo = m * t / T, hi = m * (t + 1) / T;
      auto& vp = cpos[t];
      auto& vk = ckey[t];
      // warm capped counters from up to K bases of lookback
      int run = 0;   // consecutive valid ending at i-1, capped at K
      int arun = 0;  // consecutive code==0 ending at i-1, capped at K
      for (int64_t j = lo - (int64_t)K; j < lo; ++j) {
        if (j < 0) continue;
        uint8_t c = codes[j];
        if (c > 3) {
          run = 0;
          arun = 0;
        } else {
          if (run < K) ++run;
          if (c == 0) {
            if (arun < K) ++arun;
          } else {
            arun = 0;
          }
        }
      }
      for (int64_t i = lo; i < hi; ++i) {
        uint8_t c = codes[i];
        if (c > 3) {
          run = 0;
          arun = 0;
          continue;
        }
        int r = (run < K) ? run + 1 : K;  // run INCLUDING position i
        int w = r;                        // min(run, 16), r already capped
        // previous w-1 bases all 'A'
        if ((w <= 1 || arun >= w - 1) && (bloom_mask >> c) & 1) {
          vp.push_back((int32_t)i);
          vk.push_back(c);
        }
        run = r;
        if (c == 0) {
          if (arun < K) ++arun;
        } else {
          arun = 0;
        }
      }
    });
  for (auto& th : ths) th.join();
  int64_t total = 0;
  for (int t = 0; t < T; ++t) {
    if (cpos[t].empty()) continue;
    std::memcpy(out_pos + total, cpos[t].data(),
                cpos[t].size() * sizeof(int32_t));
    std::memcpy(out_key + total, ckey[t].data(), ckey[t].size());
    total += (int64_t)cpos[t].size();
  }
  return total;
}

// Byte -> 2-bit code tokenization (A=0,T=1,C=2,G=3, else 255), uppercase
// and lowercase accepted? No: reference encoders accept uppercase only
// (panel slices are uppercased before indexing).
void gf_encode_bases(const uint8_t* bytes, int64_t n, uint8_t* out) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 255, 256);
    lut[(int)'A'] = 0; lut[(int)'T'] = 1; lut[(int)'C'] = 2; lut[(int)'G'] = 3;
    init = true;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = lut[bytes[i]];
}


// Pack a paired-end read batch into the device upload layout
// [s1p(w2) | q1p(w4) | s2p(w2) | q2p(w4)] per row, where w2=(L+1)/2 4-bit
// sequence codes (0..3=ACGT, 4=N, 5..8=acgt, 9=n, 15=other/padding) and
// w4=(L+3)/4 2-bit quality classes (0 low<=Q15, 1 mid, 2 high>=Q30) —
// exactly genefuserust_tpu/ops/pack.py. Rows B..outB and columns
// Lin..L replicate the numpy zero-padding semantics (pad bytes are value
// 0 -> seq code 15, qual class 0). exotic[r]=1 when any byte within the
// read span falls outside ACGTNacgtn (host-oracle routing).
void gf_pack_pe_batch(const uint8_t* b1, const uint8_t* q1,
                      const uint8_t* b2, const uint8_t* q2,
                      const int32_t* l1, const int32_t* l2,
                      int64_t B, int64_t Lin, int64_t L, int64_t outB,
                      uint8_t* out, uint8_t* exotic) {
  static uint8_t seq4[256];
  static uint8_t okb[256];
  static bool init = false;
  if (!init) {
    memset(seq4, 15, 256);
    seq4[(int)'A'] = 0; seq4[(int)'T'] = 1; seq4[(int)'C'] = 2;
    seq4[(int)'G'] = 3; seq4[(int)'N'] = 4;
    seq4[(int)'a'] = 5; seq4[(int)'t'] = 6; seq4[(int)'c'] = 7;
    seq4[(int)'g'] = 8; seq4[(int)'n'] = 9;
    memset(okb, 0, 256);
    const char* okc = "ACGTNacgtn";
    for (const char* p = okc; *p; ++p) okb[(int)*p] = 1;
    init = true;
  }
  const int64_t w2 = (L + 1) / 2, w4 = (L + 3) / 4;
  const int64_t W = 2 * w2 + 2 * w4;
  auto pack_side = [&](const uint8_t* s, const uint8_t* q, int64_t len,
                       uint8_t* os, uint8_t* oq, uint8_t* ex) {
    for (int64_t i = 0; i < w2; ++i) {
      int64_t j0 = 2 * i, j1 = 2 * i + 1;
      uint8_t c0 = (j0 < Lin) ? seq4[s[j0]] : 15;
      uint8_t c1 = (j1 < Lin) ? seq4[s[j1]] : 15;
      os[i] = (uint8_t)(c0 | (c1 << 4));
    }
    for (int64_t i = 0; i < w4; ++i) {
      uint8_t b = 0;
      for (int k = 0; k < 4; ++k) {
        int64_t j = 4 * i + k;
        uint8_t qb = (j < Lin) ? q[j] : 0;
        uint8_t qc = (qb >= (uint8_t)'?') ? 2 : ((qb <= (uint8_t)'0') ? 0 : 1);
        b |= (uint8_t)(qc << (2 * k));
      }
      oq[i] = b;
    }
    for (int64_t i = 0; i < len && i < Lin; ++i)
      if (!okb[s[i]]) { *ex = 1; break; }
  };
  for (int64_t r = 0; r < B; ++r) {
    uint8_t* o = out + r * W;
    uint8_t ex = 0;
    pack_side(b1 + r * Lin, q1 + r * Lin, l1[r], o, o + w2, &ex);
    pack_side(b2 + r * Lin, q2 + r * Lin, l2[r], o + w2 + w4,
              o + 2 * w2 + w4, &ex);
    exotic[r] = ex;
  }
  // padded rows: zero input bytes -> seq nibbles 15, qual classes 0
  for (int64_t r = B; r < outB; ++r) {
    uint8_t* o = out + r * W;
    memset(o, 0xFF, (size_t)w2);
    memset(o + w2, 0x00, (size_t)w4);
    memset(o + w2 + w4, 0xFF, (size_t)w2);
    memset(o + 2 * w2 + w4, 0x00, (size_t)w4);
  }
}

// Host-side overlap merge + compaction + 2-BIT pack of a paired-end
// batch. Bit-exact port of the scalar oracle fast_merge
// (genefuserust_tpu/core/read.py:52-119; reference src/core/read.rs:313-440):
// overlap lengths tried from MIN_OVERLAP(30) upward, accepted iff every
// mismatch is a low-qual diff (one side >='?' (Q30), other <='0' (Q15))
// and there are at most 2; in the merged overlap a mismatch takes R1's
// base only when q1>=Q30 && q2<=Q15, else R2rc's base.
//
// Codes are 2-bit (A=0,T=1,C=2,G=3, four bases per byte, LSB-first) —
// the smallest upload the device kernels can consume. Non-ACGT bases
// (N, lowercase, ...) are emitted as code 0 plus an EXCEPTION entry
// [compacted_row, col]; the device scatters an invalid marker (255) at
// those positions after unpacking, reproducing the 4-bit semantics
// exactly (the k-mer path only distinguishes ACGT from invalid). If the
// exception capacity would overflow (pathological N-heavy batches), the
// offending PAIR is rolled back and routed to the host oracle via its
// exotic flag — semantics preserved, throughput degraded only for that
// pair.
//
// Outputs (caller-allocated; counts returned via `counts` =
// [n_m, n_u, n_mexc, n_uexc]):
//   m_flag  u8[B]       1 where the pair merged (exotic rows excluded)
//   m_len   i32[B]      merged length for merged rows
//   exotic  u8[B]       1 = host-oracle routing (non-ACGTNacgtn bytes, or
//                       exception-capacity rollback)
//   mbuf    u8[B*mw4]   2-bit codes of merged rows, COMPACTED, stride mw4
//   rwork   i32[2B*3]   [pair_row, lane(1|2), len] per live unmerged lane
//   ubuf    u8[2B*w4]   2-bit codes matching rwork rows (RAW reads)
//   m_exc   i32[2*m_exc_cap]  [row, col] pairs into the mbuf row space
//   u_exc   i32[2*u_exc_cap]  [row, col] pairs into the ubuf row space
void gf_merge_pack_pe2(const uint8_t* b1, const uint8_t* q1,
                       const uint8_t* b2, const uint8_t* q2,
                       const int32_t* l1, const int32_t* l2,
                       int64_t B, int64_t Lin, int64_t mw4, int64_t w4,
                       uint8_t* m_flag, int32_t* m_len, uint8_t* exotic,
                       uint8_t* mbuf, int32_t* rwork, uint8_t* ubuf,
                       int32_t* m_exc, int64_t m_exc_cap,
                       int32_t* u_exc, int64_t u_exc_cap,
                       int64_t* counts) {
  static uint8_t lut2[256];
  static uint8_t okb[256];
  static uint8_t comp[256];
  static bool init = false;
  if (!init) {
    memset(lut2, 255, 256);
    lut2[(int)'A'] = 0; lut2[(int)'T'] = 1; lut2[(int)'C'] = 2;
    lut2[(int)'G'] = 3;
    memset(okb, 0, 256);
    const char* okc = "ACGTNacgtn";
    for (const char* p = okc; *p; ++p) okb[(int)*p] = 1;
    // complement: case-insensitive input, UPPERCASE output, non-ACGT->'N'
    // (core/sequence.py _COMPLEMENT_TABLE; reference sequence.rs:22-50)
    memset(comp, (int)'N', 256);
    comp[(int)'A'] = 'T'; comp[(int)'a'] = 'T';
    comp[(int)'T'] = 'A'; comp[(int)'t'] = 'A';
    comp[(int)'C'] = 'G'; comp[(int)'c'] = 'G';
    comp[(int)'G'] = 'C'; comp[(int)'g'] = 'C';
    init = true;
  }
  const int MIN_OVERLAP = 30;
  const uint8_t Q30 = (uint8_t)'?', Q15 = (uint8_t)'0';
  std::vector<uint8_t> rc2((size_t)Lin), q2r((size_t)Lin);
  std::vector<uint8_t> mseq((size_t)(2 * Lin));
  int64_t n_m = 0, n_u = 0, n_me = 0, n_ue = 0;
  // pack `n` bytes of s as 2-bit codes into out[w] bytes; exceptions for
  // non-ACGT at j < n go to (exc_row, j). Returns false on cap overflow.
  auto pack2 = [&](const uint8_t* s, int64_t n, uint8_t* out, int64_t w,
                   int32_t exc_row, int32_t* exc, int64_t cap,
                   int64_t* n_exc) -> bool {
    for (int64_t i = 0; i < w; ++i) {
      uint8_t byte = 0;
      for (int k = 0; k < 4; ++k) {
        int64_t j = 4 * i + k;
        uint8_t c = 0;
        if (j < n) {
          c = lut2[s[j]];
          if (c == 255) {
            if (*n_exc >= cap) return false;
            exc[2 * *n_exc] = exc_row;
            exc[2 * *n_exc + 1] = (int32_t)j;
            ++*n_exc;
            c = 0;
          }
        }
        byte |= (uint8_t)(c << (2 * k));
      }
      out[i] = byte;
    }
    return true;
  };
  for (int64_t r = 0; r < B; ++r) {
    m_flag[r] = 0;
    m_len[r] = 0;
    exotic[r] = 0;
    const int64_t n1 = l1[r], n2 = l2[r];
    if (n1 == 0 && n2 == 0) continue;  // dead/padding row
    const uint8_t* s1 = b1 + r * Lin;
    const uint8_t* s2 = b2 + r * Lin;
    const uint8_t* qa = q1 + r * Lin;
    const uint8_t* qb = q2 + r * Lin;
    bool ex = false;
    for (int64_t i = 0; i < n1 && i < Lin; ++i)
      if (!okb[s1[i]]) { ex = true; break; }
    if (!ex)
      for (int64_t i = 0; i < n2 && i < Lin; ++i)
        if (!okb[s2[i]]) { ex = true; break; }
    if (ex) { exotic[r] = 1; continue; }
    // reverse-complement R2 (+ reversed quality)
    for (int64_t i = 0; i < n2; ++i) {
      rc2[i] = comp[s2[n2 - 1 - i]];
      q2r[i] = qb[n2 - 1 - i];
    }
    // overlap search: first accepted olen wins
    int64_t olen = 0;
    bool merged = false;
    const int64_t omax = (n1 < n2 ? n1 : n2);
    for (int64_t ol = MIN_OVERLAP; ol <= omax; ++ol) {
      const int64_t off = n1 - ol;
      int diff = 0, lqd = 0;
      bool ok = true;
      for (int64_t i = 0; i < ol; ++i) {
        if (s1[off + i] != rc2[i]) {
          ++diff;
          if ((qa[off + i] >= Q30 && q2r[i] <= Q15) ||
              (qa[off + i] <= Q15 && q2r[i] >= Q30))
            ++lqd;
          if (diff > lqd || lqd >= 3) { ok = false; break; }
        }
      }
      if (ok) { merged = true; olen = ol; break; }
    }
    if (merged) {
      const int64_t off = n1 - olen;
      const int64_t ml = off + n2;
      memcpy(mseq.data(), s1, (size_t)off);
      memcpy(mseq.data() + off, rc2.data(), (size_t)n2);
      for (int64_t i = 0; i < olen; ++i) {
        if (s1[off + i] != rc2[i] && qa[off + i] >= Q30 && q2r[i] <= Q15)
          mseq[off + i] = s1[off + i];
      }
      const int64_t save_me = n_me;
      if (!pack2(mseq.data(), ml, mbuf + n_m * mw4, mw4, (int32_t)n_m,
                 m_exc, m_exc_cap, &n_me)) {
        n_me = save_me;  // rollback: route the pair to the host oracle
        exotic[r] = 1;
        continue;
      }
      m_flag[r] = 1;
      m_len[r] = (int32_t)ml;
      ++n_m;
    } else {
      const int64_t save_u = n_u, save_ue = n_ue;
      bool okp = true;
      if (n1 > 0) {
        rwork[3 * n_u] = (int32_t)r;
        rwork[3 * n_u + 1] = 1;
        rwork[3 * n_u + 2] = (int32_t)n1;
        okp = pack2(s1, n1, ubuf + n_u * w4, w4, (int32_t)n_u,
                    u_exc, u_exc_cap, &n_ue);
        if (okp) ++n_u;
      }
      if (okp && n2 > 0) {
        rwork[3 * n_u] = (int32_t)r;
        rwork[3 * n_u + 1] = 2;
        rwork[3 * n_u + 2] = (int32_t)n2;
        okp = pack2(s2, n2, ubuf + n_u * w4, w4, (int32_t)n_u,
                    u_exc, u_exc_cap, &n_ue);
        if (okp) ++n_u;
      }
      if (!okp) {  // rollback the whole pair -> host oracle
        n_u = save_u;
        n_ue = save_ue;
        exotic[r] = 1;
        continue;
      }
    }
  }
  counts[0] = n_m;
  counts[1] = n_u;
  counts[2] = n_me;
  counts[3] = n_ue;
}

// FASTQ block parser, pass 1: line census of a raw buffer.
// Semantics mirror io/fastq_block.parse_fastq_buffer (which mirrors the
// reference 4-line record reader, src/core/fastq_reader.rs:19-219, with
// the LimitedBufReader 1000-byte line cap): a trailing line without a
// newline counts as a line; a line of >= `limit` content bytes is a
// violation EXCEPT a final unterminated line of exactly `limit` bytes
// (nothing remains after the take budget, so the reference does not
// panic there).
// out[0] = n complete 4-line records
// out[1] = max seq-line length over those records (lines 1 mod 4)
// out[2] = first violating line index, or -1
void gf_fastq_dims(const uint8_t* buf, int64_t len, int64_t limit,
                   int64_t* out) {
  int64_t n_lines = 0, bad = -1;
  int64_t max_seq_all = 0, max_seq_prev = 0;  // over seq lines; excl. last
  int64_t last_seq_idx = -1, last_seq_len = 0;
  int64_t pos = 0;
  while (pos < len) {
    const void* nlp = memchr(buf + pos, '\n', (size_t)(len - pos));
    int64_t end = nlp ? (int64_t)((const uint8_t*)nlp - buf) : len;
    int64_t L = end - pos;
    bool unterminated = (nlp == nullptr);
    if (L >= limit && bad < 0 && !(unterminated && L == limit)) bad = n_lines;
    if ((n_lines & 3) == 1) {
      if (last_seq_len > max_seq_prev) max_seq_prev = last_seq_len;
      if (max_seq_prev > max_seq_all) max_seq_all = max_seq_prev;
      last_seq_idx = n_lines;
      last_seq_len = L;
      if (L > max_seq_all) max_seq_all = L;
    }
    ++n_lines;
    pos = end + 1;
  }
  int64_t n = n_lines / 4;
  // the last seq line may belong to a dropped partial record
  out[0] = n;
  out[1] = (last_seq_idx >= 4 * n) ? max_seq_prev : max_seq_all;
  out[2] = bad;
}

// FASTQ block parser, pass 2: fill spans + zero-padded seq/qual matrices
// for the first n records. seq rows are exact (L >= every record seq
// length by pass 1); qual rows longer than L are truncated to L (the
// numpy parser's [:, :L]). lens[] carries true seq lengths.
void gf_fastq_fill(const uint8_t* buf, int64_t len, int64_t n, int64_t L,
                   int64_t* name_spans, int64_t* strand_spans,
                   uint8_t* seq, uint8_t* qual, int32_t* lens) {
  int64_t pos = 0;
  for (int64_t line = 0; line < 4 * n && pos <= len; ++line) {
    const void* nlp =
        pos < len ? memchr(buf + pos, '\n', (size_t)(len - pos)) : nullptr;
    int64_t end = nlp ? (int64_t)((const uint8_t*)nlp - buf) : len;
    int64_t Ll = end - pos;
    int64_t r = line >> 2;
    switch (line & 3) {
      case 0:
        name_spans[2 * r] = pos;
        name_spans[2 * r + 1] = end;
        break;
      case 1: {
        int64_t c = Ll < L ? Ll : L;
        memcpy(seq + r * L, buf + pos, (size_t)c);
        memset(seq + r * L + c, 0, (size_t)(L - c));
        lens[r] = (int32_t)Ll;
        break;
      }
      case 2:
        strand_spans[2 * r] = pos;
        strand_spans[2 * r + 1] = end;
        break;
      case 3: {
        int64_t c = Ll < L ? Ll : L;
        memcpy(qual + r * L, buf + pos, (size_t)c);
        memset(qual + r * L + c, 0, (size_t)(L - c));
        break;
      }
    }
    pos = end + 1;
  }
}

}  // extern "C"
