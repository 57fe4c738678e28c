// Per-lane FM-index arithmetic shared by the CUDA kernels (rank.cu,
// search.cu, ftab12.cu, resolve.cu, presolve.cu, sharded.cu) and by the
// host build of the same header that the CPU tests compile
// (cpu_twin.cpp). Every function is
// __host__ __device__, so the arithmetic the card runs is the arithmetic
// the tests check.
//
// The search and the SA walk are one lane loop each (search_lane, over
// the state that search_step advances one table read at a time, and
// resolve_row), templated over a table reader and a group policy. The
// reader gives the table reads: FlatTables, the tables of one device
// (K1, K3), or ShardSet, the fm shards of one dp row of a mesh (K6).
// The group is the threads that run one lane: Tile<G>, G threads of a
// warp that split each block-row scan into 16-byte chunks (K1, K3), or
// Serial<G>, one thread computing the same G parts in a loop (K6 at
// G = 1, and the host twin at every G). Tables are read through the
// read-only path (ldg).
//
// Block layout (ops/fm_torch.pack_bwt_blocks): uint32 rows of 512 bases,
//   narrow (R = int32_t): occ[4]              | words[32]   (36 words)
//   wide   (R = int64_t): occ_lo[4] occ_hi[4] | words[32]   (40 words)
// 16 bases per word, little-endian 2-bit codes. Occ checkpoints are
// global prefix counts. '$' is stored as code 0 at row zoff and the rank
// subtracts it once. Rows are 144 and 160 bytes and the words start at
// byte 16 and 32, so with the table 16-byte aligned (the wrappers check)
// every 16-byte chunk of a row is too.
//
// Packed ftab rows (ops/fm_torch.pack_ftab_rows), same row width:
//   narrow: 16 (top, bot) pairs per row; wide: 8 (top_lo, top_hi, bot_lo,
//   bot_hi) quads per row.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>

#include <mutex>
#define FM_HD __host__ __device__ __forceinline__
#define FM_HDM __host__ __device__ __forceinline__
#define FM_UNROLL _Pragma("unroll")
#else
#define FM_HD static inline
#define FM_HDM inline
#define FM_UNROLL
#endif

namespace fm {

template <typename R>
struct Geo;
template <>
struct Geo<int32_t> {
  static constexpr int kWordOff = 4;
  static constexpr int kWidth = 36;
  static constexpr int kPerShift = 4;  // 16 ftab entries per row
};
template <>
struct Geo<int64_t> {
  static constexpr int kWordOff = 8;
  static constexpr int kWidth = 40;
  static constexpr int kPerShift = 3;  // 8 ftab entries per row
};

constexpr int kFtabChars = 10;

// Loads of the index tables, which no kernel writes: the read-only
// (non-coherent) path on the card.
FM_HD uint32_t ldg(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}
FM_HD int32_t ldg(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}
FM_HD int64_t ldg(const int64_t* p) {
#if defined(__CUDA_ARCH__)
  return (int64_t)__ldg((const long long*)p);
#else
  return *p;
#endif
}

// 16 and 8 bytes of an index table in one load (16- and 8-byte aligned)
struct U4 {
  uint32_t v[4];
};
struct U2 {
  uint32_t v[2];
};
FM_HD U4 ldg4(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  return U4{{q.x, q.y, q.z, q.w}};
#else
  return U4{{p[0], p[1], p[2], p[3]}};
#endif
}
FM_HD U2 ldg2(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  return U2{{q.x, q.y}};
#else
  return U2{{p[0], p[1]}};
#endif
}
// word i (0..3) of a chunk, by selects: an index into the registers that
// the compiler cannot resolve would put the chunk in local memory
FM_HD uint32_t pick(const U4& q, int i) {
  return i == 0 ? q.v[0] : i == 1 ? q.v[1] : i == 2 ? q.v[2] : q.v[3];
}

FM_HD int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

FM_HD int popc64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// Bases equal to c among the first nvalid (0..16) bases of a word. The
// word XOR the char's repeated pattern turns matching bases into 00; the
// AND of the complement's two bit planes leaves one marker bit per base.
// The mask never shifts by 32 (undefined in C++ and CUDA).
FM_HD int count_in_word(uint32_t word, uint32_t pattern, int nvalid) {
  uint32_t x = ~(word ^ pattern);
  uint32_t y = x & (x >> 1) & 0x55555555u;
  uint32_t mask =
      nvalid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * (nvalid & 15))) - 1u);
  return popc32(y & mask);
}

template <typename R>
FM_HD R occ_at(const uint32_t* row, int c) {
  if constexpr (sizeof(R) == 8) {
    return (R)(((uint64_t)ldg(row + 4 + c) << 32) | (uint64_t)ldg(row + c));
  } else {
    return (R)ldg(row + c);
  }
}

// rank_c(r): occurrences of c in bwt[0:r], '$' excluded, from the block
// row that holds r (row = r's block, wherever the table holding it lies).
template <typename R>
FM_HD R rank_in_row(const uint32_t* row, R zoff, R r, int c) {
  const uint32_t* words = row + Geo<R>::kWordOff;
  const int within = (int)(r & 511);
  const uint32_t pattern = (uint32_t)c * 0x55555555u;
  const int full = within >> 4;
  int cnt = 0;
  for (int w = 0; w < full; ++w)
    cnt += count_in_word(ldg(words + w), pattern, 16);
  if (within & 15)
    cnt += count_in_word(ldg(words + full), pattern, within & 15);
  return occ_at<R>(row, c) + (R)cnt - (R)((c == 0 && zoff < r) ? 1 : 0);
}

template <typename R>
FM_HD R rank(const uint32_t* blocks, R zoff, R r, int c) {
  return rank_in_row<R>(blocks + (int64_t)(r >> 9) * Geo<R>::kWidth, zoff, r,
                        c);
}

template <typename R>
FM_HD R lf(const uint32_t* blocks, const R* fchr, R zoff, R r, int c) {
  return fchr[c] + rank<R>(blocks, zoff, r, c);
}

template <typename R>
FM_HD void ftab_entry(const uint32_t* rows, int64_t fi, R* top, R* bot) {
  const uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    const U4 q = ldg4(row + (int)(fi & 7) * 4);
    *top = (R)(((uint64_t)q.v[1] << 32) | (uint64_t)q.v[0]);
    *bot = (R)(((uint64_t)q.v[3] << 32) | (uint64_t)q.v[2]);
  } else {
    const U2 q = ldg2(row + (int)(fi & 15) * 2);
    *top = (R)q.v[0];
    *bot = (R)q.v[1];
  }
}

template <typename R>
FM_HD void ftab_store(uint32_t* rows, int64_t fi, R top, R bot) {
  uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    const int q = (int)(fi & 7) * 4;
    row[q] = (uint32_t)((uint64_t)top & 0xFFFFFFFFu);
    row[q + 1] = (uint32_t)((uint64_t)top >> 32);
    row[q + 2] = (uint32_t)((uint64_t)bot & 0xFFFFFFFFu);
    row[q + 3] = (uint32_t)((uint64_t)bot >> 32);
  } else {
    const int p = (int)(fi & 15) * 2;
    row[p] = (uint32_t)top;
    row[p + 1] = (uint32_t)bot;
  }
}

// One depth-12 ftab entry, idx = e10 | c10 << 20 | c11 << 22 (the
// window layout of the search: the char at cur+j sits at bits 2j). t1/b1
// hold LF(t0, c10) / LF(b0, c10) at e10 | c10 << 20. Guards as
// native/fmwalk.cpp fm_ftab_extend: an empty depth-10 parent gives an
// empty (0, 0) level-1 range, and level 2 extends only a non-empty
// level-1 range; every other entry stores (0, 0).
template <typename R>
FM_HD void ftab12_entry(const uint32_t* blocks, const R* fchr, R zoff,
                        const R* t0, const R* b0, const R* t1, const R* b1,
                        uint32_t* out, int64_t idx) {
  const int64_t e10 = idx & ((1 << 20) - 1);
  const int64_t i1 = idx & ((1 << 22) - 1);
  const int c11 = (int)((idx >> 22) & 3);
  R lt = 0, lb = 0;
  if (b0[e10] > t0[e10]) {
    lt = t1[i1];
    lb = b1[i1];
  }
  R top = 0, bot = 0;
  if (lb > lt) {
    top = lf<R>(blocks, fchr, zoff, lt, c11);
    bot = lf<R>(blocks, fchr, zoff, lb, c11);
  }
  ftab_store<R>(out, idx, top, bot);
}

// ---- the table readers ----
//
// A reader gives the lane loops their table reads: zoff; fc(c), fchr[c];
// row(r), the block row holding row r (null where no table holds it);
// ftab10(fi), the depth-10 ftab entry; deep() and ftab12_at(fi), the
// depth-12 prime; sample(si), SA sample si; kMasked, whether row() can
// be null; kUnroll, the walk's step-bound granularity.

// The whole index on one device: packed block and ftab rows, the
// (ceil(n/8), 8)-padded sample table, whose index is clipped to it.
template <typename R>
struct FlatTables {
  static constexpr bool kMasked = false;
  static constexpr int kUnroll = 8;  // the JAX walk's 8-step unroll
  const uint32_t* blocks;
  const R* fchr;
  R zoff;
  const uint32_t* ftab;    // packed depth-10 rows
  const uint32_t* ftab12;  // packed depth-12 rows, or null (no prime)
  const int32_t* offs;     // the samples, or null (search)
  int64_t noffs;           // their count, padding included

  FM_HDM R fc(int c) const { return ldg(fchr + c); }
  FM_HDM const uint32_t* row(R r) const {
    return blocks + (int64_t)(r >> 9) * Geo<R>::kWidth;
  }
  FM_HDM void ftab10(int64_t fi, R* top, R* bot) const {
    ftab_entry<R>(ftab, fi, top, bot);
  }
  FM_HDM bool deep() const { return ftab12 != nullptr; }
  FM_HDM void ftab12_at(int64_t fi, R* top, R* bot) const {
    ftab_entry<R>(ftab12, fi, top, bot);
  }
  FM_HDM int32_t sample(R si) const {
    if (si < 0) si = 0;
    if (si > (R)(noffs - 1)) si = (R)(noffs - 1);
    return ldg(offs + si);
  }
};

// The fm shards of one dp row (parallel/sharded.py ShardedFMArrays):
// shard f holds the block rows [blk_base[f], + nblk_per), the ftab
// entries [ftab_base[f], + nftab_per) as (top, bot) pairs and the SA
// samples [offs_base[f], + noffs_per), split by range, so a key's owner
// is key / per. A key no shard owns reads 0, as the JAX package's
// owner-masked gathers summed over the fm axis give. A shard on another
// card is read through its peer mapping. No depth-12 prime: the JAX
// sharded kernels have none.
constexpr int kMaxShards = 8;

template <typename R>
struct ShardSet {
  static constexpr bool kMasked = true;
  static constexpr int kUnroll = 4;  // the JAX sharded walk's unroll
  const uint32_t* blocks[kMaxShards];
  const R* ftab_tb[kMaxShards];
  const int32_t* offs[kMaxShards];
  int64_t blk_base[kMaxShards];
  int64_t ftab_base[kMaxShards];
  int64_t offs_base[kMaxShards];
  int64_t nblk_per, nftab_per, noffs_per;
  int32_t n_fm;
  const R* fchr;  // replicated, on the row's lead device
  R zoff;

  // the shard owning key (one of per keys each), or -1
  FM_HDM int owner(R key, int64_t per) const {
    if (key < 0) return -1;
    const R f = key / (R)per;
    return f < (R)n_fm ? (int)f : -1;
  }
  FM_HDM R fc(int c) const { return ldg(fchr + c); }
  FM_HDM const uint32_t* row(R r) const {
    const R key = r >> 9;
    const int f = owner(key, nblk_per);
    if (f < 0) return nullptr;
    return blocks[f] + (int64_t)(key - (R)blk_base[f]) * Geo<R>::kWidth;
  }
  FM_HDM void ftab10(int64_t fi, R* top, R* bot) const {
    const int f = owner((R)fi, nftab_per);
    *top = *bot = 0;
    if (f < 0) return;
    const R* p = ftab_tb[f] + 2 * (fi - ftab_base[f]);
    *top = ldg(p);
    *bot = ldg(p + 1);
  }
  FM_HDM bool deep() const { return false; }
  FM_HDM void ftab12_at(int64_t, R* top, R* bot) const { *top = *bot = 0; }
  FM_HDM int32_t sample(R si) const {
    const int f = owner(si, noffs_per);
    return f < 0 ? 0 : ldg(offs[f] + (si - (R)offs_base[f]));
  }
};

// A dp row's ShardSet from its descriptor words (parallel/sharded.py
// shard_descriptor): n_fm, nblk_per, nftab_per, noffs_per, zoff, fchr,
// then per shard blocks, ftab_tb, offs, blk_base, ftab_base, offs_base.
// False when n_fm is outside 1..kMaxShards or a shard's block table is
// not 16-byte aligned (the row scan reads it in 16-byte chunks).
template <typename R>
inline bool shard_set(const int64_t* d, ShardSet<R>* s) {
  if (d[0] < 1 || d[0] > kMaxShards) return false;
  *s = ShardSet<R>{};
  s->n_fm = (int32_t)d[0];
  s->nblk_per = d[1];
  s->nftab_per = d[2];
  s->noffs_per = d[3];
  s->zoff = (R)d[4];
  s->fchr = (const R*)(uintptr_t)d[5];
  for (int f = 0; f < s->n_fm; ++f) {
    const int64_t* e = d + 6 + 6 * f;
    if (e[0] % 16 != 0) return false;
    s->blocks[f] = (const uint32_t*)(uintptr_t)e[0];
    s->ftab_tb[f] = (const R*)(uintptr_t)e[1];
    s->offs[f] = (const int32_t*)(uintptr_t)e[2];
    s->blk_base[f] = e[3];
    s->ftab_base[f] = e[4];
    s->offs_base[f] = e[5];
  }
  return true;
}

// ---- the groups that run one lane ----
//
// Every thread of a group runs the whole lane loop on the same values;
// only the scan of a block row is split. Part p of G reads the 16-byte
// chunks p, p + G, ... of the row's 8 and counts their bases, and the
// group sums the parts, so every thread gets the same sum:
//   Tile<G>    G threads of a warp (cooperative_groups tiled_partition),
//              on the card: each computes the part of its rank, and
//              cg::reduce sums them over the tile's own mask (tiles of
//              one warp are at different steps of different lanes)
//   Serial<G>  one thread that computes the G parts in a loop and sums
//              them: the host twin runs the very part functions the
//              card runs, at every G; K6 runs G = 1
// leader() writes a lane's results; rank() and size() spread its slot
// initialisation; sync() orders the two.

template <int G>
struct Serial {
  static constexpr int kG = G;
  template <typename Part>
  FM_HDM uint32_t sum(const Part& part) const {
    uint32_t s = 0;
    for (int p = 0; p < G; ++p) s += part(p);
    return s;
  }
  FM_HDM bool leader() const { return true; }
  FM_HDM int rank() const { return 0; }
  FM_HDM int size() const { return 1; }
  FM_HDM void sync() const {}
};

#if defined(__CUDACC__)
namespace cg = cooperative_groups;

// The members run on the card only; the host pass of nvcc sees bodies
// that it never calls.
template <int G>
struct Tile {
  static constexpr int kG = G;
  cg::thread_block_tile<G> tile;
  template <typename Part>
  FM_HDM uint32_t sum(const Part& part) const {
#if defined(__CUDA_ARCH__)
    return cg::reduce(tile, part((int)tile.thread_rank()),
                      cg::plus<uint32_t>());
#else
    return part(0);
#endif
  }
  FM_HDM bool leader() const { return rank() == 0; }
  FM_HDM int rank() const {
#if defined(__CUDA_ARCH__)
    return (int)tile.thread_rank();
#else
    return 0;
#endif
  }
  FM_HDM int size() const { return G; }
  FM_HDM void sync() const {
#if defined(__CUDA_ARCH__)
    tile.sync();
#endif
  }
  // the next work item: the leader's atomicAdd on the counter, broadcast
  // to the tile
  FM_HDM int64_t take(int32_t* next) const {
#if defined(__CUDA_ARCH__)
    int32_t v = 0;
    if (tile.thread_rank() == 0) v = atomicAdd(next, 1);
    return (int64_t)tile.shfl(v, 0);
#else
    return 0;
#endif
  }
};

// The grid of a persistent kernel that takes its items from a counter,
// `tile` threads an item: the blocks of `threads` that the card keeps
// resident (the occupancy query, made once per device and kept), capped
// at the blocks that n items fill. *resident receives the uncapped grid.
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t persistent_grid(int threads, int tile, int64_t n, int* grid,
                            int* resident = nullptr) {
  static std::mutex mu;
  static int kept[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int res = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (kept[dev] == 0) {
      int per_sm = 0, sms = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                        threads, 0);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      kept[dev] = per_sm * sms;
    }
    res = kept[dev];
  }
  const int64_t need = (n * tile + threads - 1) / threads;
  *grid = (int)(need < res ? need : res);
  if (resident != nullptr) *resident = res;
  return cudaSuccess;
}
#endif

// ---- the scan of a block row by a group (K1, K3, K6) ----

constexpr int kChunks = 8;  // 16-byte chunks of a row's 128-byte words

// Words 2h and 2h + 1 of a chunk as one 64-bit word (32 bases)
FM_HD uint64_t half(const U4& q, int h) {
  return h == 0 ? ((uint64_t)q.v[1] << 32 | q.v[0])
                : ((uint64_t)q.v[3] << 32 | q.v[2]);
}

// The low bit of each of the first n bases of 32 (n clamped to 0..32):
// the mask never shifts by 64.
FM_HD uint64_t low_bits_before(int n) {
  if (n <= 0) return 0;
  return n >= 32 ? 0x5555555555555555ull
                 : ((1ull << (2 * n)) - 1ull) & 0x5555555555555555ull;
}

// The bases of chunk k before `within`, counted by bit plane: bits 0-8
// those whose low bit is set (codes 1 and 3), bits 9-17 those whose high
// bit is set (2 and 3), bits 18-26 code 3. No count reaches 512, so sums
// of these words never carry from one field into the next.
FM_HD uint32_t planes_before(const U4& q, int k, int within) {
  uint32_t s = 0;
  for (int h = 0; h < 2; ++h) {
    const uint64_t m = low_bits_before(within - 64 * k - 32 * h);
    const uint64_t lo = half(q, h) & m, hi = (half(q, h) >> 1) & m;
    s += (uint32_t)popc64(lo) + ((uint32_t)popc64(hi) << 9) +
         ((uint32_t)popc64(lo & hi) << 18);
  }
  return s;
}

// The bases of chunk k before `within` equal to the char whose repeated
// pattern (c * 0x5555...) is given: XOR-NOT turns them into 11
FM_HD uint32_t count_before(const U4& q, int k, uint64_t pattern,
                            int within) {
  uint32_t s = 0;
  for (int h = 0; h < 2; ++h) {
    const uint64_t x = ~(half(q, h) ^ pattern);
    s += (uint32_t)popc64(x & (x >> 1) &
                          low_bits_before(within - 64 * k - 32 * h));
  }
  return s;
}

// the count of c before `within` from the summed planes (code 0 is every
// base that is none of the others)
FM_HD int count_of(uint32_t f, int within, int c) {
  const int lo = (int)(f & 511), hi = (int)((f >> 9) & 511),
            c3 = (int)((f >> 18) & 511);
  return c == 3 ? c3 : c == 2 ? hi - c3 : c == 1 ? lo - c3
                                                 : within - lo - hi + c3;
}

// Part p (of G) of the scan of one row. kAll: the planes before
// `within` in its chunks (the counts of every code, for a walk that
// learns the code from this scan); else the count of the char whose
// pattern is given (bits 0-9). Either way, from the part holding it, the
// code at `within` (bits 27-28). A chunk wholly past `within` is not
// read. Nothing branches on the part: the threads of a tile hold
// different chunks, and a branch on it would split the tile. A chunk not
// read counts nothing, as its mask is empty.
template <int G, bool kAll>
struct ScanPart {
  const uint32_t* words;
  int within;
  uint64_t pattern;
  FM_HDM uint32_t operator()(int p) const {
    uint32_t s = 0;
    FM_UNROLL
    for (int i = 0; i < kChunks / G; ++i) {
      const int k = i * G + p;
      U4 q{};
      if (64 * k <= within) q = ldg4(words + 4 * k);
      s += kAll ? planes_before(q, k, within)
                : count_before(q, k, pattern, within);
      const uint32_t code =
          (pick(q, (within >> 4) & 3) >> (2 * (within & 15))) & 3u;
      s += ((within >> 6) == k ? code : 0u) << 27;
    }
    return s;
  }
};

// Part p (of G) of two ranks of one char: before `wa` in row a (bits
// 0-15) and before `wb` in row b (bits 16-31). The loads of both rows
// are issued before either is counted, and a row that both ranks share
// is read once. A chunk wholly past its rank, or of a null row, is not
// read; as in ScanPart nothing branches on the part, and a chunk past
// its rank counts nothing (a null row's count is not used).
template <int G>
struct PairPart {
  const uint32_t* a;
  const uint32_t* b;
  int wa, wb;
  uint64_t pattern;
  FM_HDM uint32_t operator()(int p) const {
    constexpr int K = kChunks / G;
    const bool same = a == b;
    U4 qa[K]{}, qb[K]{};
    FM_UNROLL
    for (int i = 0; i < K; ++i) {
      const int k = i * G + p;
      const bool la = a != nullptr && 64 * k < wa;
      const bool lb = b != nullptr && 64 * k < wb;
      if (same) {
        if (la || lb) qa[i] = qb[i] = ldg4(a + 4 * k);
      } else {
        if (la) qa[i] = ldg4(a + 4 * k);
        if (lb) qb[i] = ldg4(b + 4 * k);
      }
    }
    uint32_t s = 0;
    FM_UNROLL
    for (int i = 0; i < K; ++i) {
      const int k = i * G + p;
      s += count_before(qa[i], k, pattern, wa) +
           (count_before(qb[i], k, pattern, wb) << 16);
    }
    return s;
  }
};

// A row's occ checkpoint: one 16-byte load narrow, two wide, the char
// picked after (K3 learns it from the same scan). A null row reads 0.
template <typename R>
struct Occ {
  U4 lo, hi;
  FM_HDM R at(int c) const {
    if constexpr (sizeof(R) == 8) {
      return (R)(((uint64_t)pick(hi, c) << 32) | (uint64_t)pick(lo, c));
    } else {
      return (R)pick(lo, c);
    }
  }
};

template <typename R>
FM_HD Occ<R> load_occ(const uint32_t* row) {
  Occ<R> o{};
  if (row == nullptr) return o;
  o.lo = ldg4(row);
  if constexpr (sizeof(R) == 8) o.hi = ldg4(row + 4);
  return o;
}

// BWT[r] into *code, and the rank before r of c (c < 0: of BWT[r]), from
// one scan of r's block row by the group. A row that no table holds
// reads code 0 and rank 0: an owner-masked read that no shard answers.
template <typename R, typename T, typename Grp>
FM_HD R scan_rank(const T& t, const Grp& g, R r, int c, int* code) {
  const uint32_t* row = t.row(r);
  if (T::kMasked && row == nullptr) {
    *code = 0;
    return 0;
  }
  const int within = (int)(r & 511);
  const Occ<R> occ = load_occ<R>(row);
  const uint32_t* words = row + Geo<R>::kWordOff;
  int n;
  if (c < 0) {
    const uint32_t f = g.sum(ScanPart<Grp::kG, true>{words, within, 0});
    *code = (int)(f >> 27);
    c = *code;
    n = count_of(f, within, c);
  } else {
    const uint32_t f = g.sum(ScanPart<Grp::kG, false>{
        words, within, (uint64_t)c * 0x5555555555555555ull});
    *code = (int)(f >> 27);
    n = (int)(f & 1023);
  }
  return occ.at(c) + (R)n - (R)((c == 0 && t.zoff < r) ? 1 : 0);
}

// The ranks of c before a and before b, the two rows' loads in flight
// together (one summed word carries both counts).
template <typename R, typename T, typename Grp>
FM_HD void rank_pair(const T& t, const Grp& g, R a, R b, int c, R* ra,
                     R* rb) {
  const uint32_t* rowa = t.row(a);
  const uint32_t* rowb = t.row(b);
  const Occ<R> oa = load_occ<R>(rowa), ob = load_occ<R>(rowb);
  const uint32_t f = g.sum(PairPart<Grp::kG>{
      rowa == nullptr ? nullptr : rowa + Geo<R>::kWordOff,
      rowb == nullptr ? nullptr : rowb + Geo<R>::kWordOff, (int)(a & 511),
      (int)(b & 511), (uint64_t)c * 0x5555555555555555ull});
  *ra = (T::kMasked && rowa == nullptr)
            ? (R)0
            : oa.at(c) + (R)(f & 0xFFFFu) -
                  (R)((c == 0 && t.zoff < a) ? 1 : 0);
  *rb = (T::kMasked && rowb == nullptr)
            ? (R)0
            : ob.at(c) + (R)(f >> 16) - (R)((c == 0 && t.zoff < b) ? 1 : 0);
}

// fchr[0..3] in registers, loaded once a lane or row
template <typename R>
struct Fc4 {
  R f[4];
  FM_HDM R at(int c) const {
    return c == 0 ? f[0] : c == 1 ? f[1] : c == 2 ? f[2] : f[3];
  }
};

template <typename R, typename T>
FM_HD Fc4<R> load_fc(const T& t) {
  return Fc4<R>{{t.fc(0), t.fc(1), t.fc(2), t.fc(3)}};
}

// Ask for r's block row (its first and last line) ahead of its scan, so
// that the fetch overlaps what the lane does before the scan. A hint: no
// thread waits on it, and the host does nothing.
template <typename R, typename T>
FM_HD void prefetch_row(const T& t, R r) {
#if defined(__CUDA_ARCH__)
  const uint32_t* row = t.row(r);
  if (T::kMasked && row == nullptr) return;
  asm volatile("prefetch.global.L1 [%0];" ::"l"(row));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(row + Geo<R>::kWidth - 1));
#else
  (void)t;
  (void)r;
#endif
}

// ---- the greedy search (K1, K6) ----

template <typename R>
struct SearchArgs {
  const uint8_t* reads;  // [L, row_bytes]: reversed codes, 2 per byte
  int64_t row_bytes;
  const int32_t* lengths;
  const int32_t* start;
  R* h_top;  // [L, mh]
  R* h_bot;
  int32_t* h_off;
  int32_t* h_len;
  int32_t* nhits;  // [L]
  int32_t* sums;
  int32_t mh;
  int32_t min_hitlen;
  int32_t increment;
  int32_t first_hit_only;
};

// base code at position pos of a lane's reversed read (0-3, 4 = N)
FM_HD int read_code(const uint8_t* rd, int pos) {
  const uint8_t b = rd[pos >> 1];
  return (pos & 1) ? (b >> 4) : (b & 15);
}

// The greedy partial-hit scan of one (read, strand) lane (hi_aligner.h
// partialSearch under the classifier's driver policy), as a state that
// advances one table read at a time: search_begin sets it up and each
// search_step makes at most one read (an ftab entry or an extension
// step). A kernel's loop then takes a new lane in the very iteration
// that another group's lane ends, so no group of a warp waits at a loop's
// exit for a longer lane. search_lane runs one lane to its end.
// Outputs match classify/engine.search_loop of the JAX package: hits in
// emission order, an empty hit is top == bot == -1, unused slots hold
// (-1, -1, 0, 0), and a lane that emits more than mh hits keeps
// overwriting its last slot (the caller re-runs it with a larger mh).
// With a depth-12 table (t.deep()) a start first tries the 12-char prime.
// The group g runs the lane: its threads clear the slots between them,
// and the leader writes each hit, in emission order, after they have (so
// an overflowing lane's last slot ends as its last hit).
template <typename R>
struct SearchLane {
  int64_t lane;
  const uint8_t* rd;
  int n, cur, nh, sum;
  int reads;  // table reads (ftab entries and extension steps)
  int dep;    // the next char of an extension
  bool no12;  // the deep prime of this start came back empty
  bool ext;   // an extension is under way: (top, bot) matches [cur, dep)
  R top, bot;
};

// the lane's counts, once it is done
template <typename R, typename Grp>
FM_HD void search_end(const SearchArgs<R>& a, const Grp& g,
                      const SearchLane<R>& s) {
  if (g.leader()) {
    a.nhits[s.lane] = s.nh;
    a.sums[s.lane] = s.sum;
  }
}

// Sets up lane; false when it has nothing to scan (its counts written).
template <typename R, typename Grp>
FM_HD bool search_begin(const SearchArgs<R>& a, int64_t lane, const Grp& g,
                        SearchLane<R>* s) {
  R* ht = a.h_top + lane * a.mh;
  R* hb = a.h_bot + lane * a.mh;
  int32_t* ho = a.h_off + lane * a.mh;
  int32_t* hl = a.h_len + lane * a.mh;
  for (int k = g.rank(); k < a.mh; k += g.size()) {
    ht[k] = -1;
    hb[k] = -1;
    ho[k] = 0;
    hl[k] = 0;
  }
  g.sync();
  s->lane = lane;
  s->rd = a.reads + lane * a.row_bytes;
  s->n = a.lengths[lane];
  s->cur = a.start[lane];
  s->nh = s->sum = s->reads = 0;
  s->dep = s->cur;
  s->no12 = s->ext = false;
  s->top = s->bot = 0;
  if (s->cur < s->n) return true;
  search_end<R>(a, g, *s);
  return false;
}

// One step of the lane: at most one table read, then the hit it ends, if
// any. False once the lane is done (its counts written).
template <typename R, typename T, typename Grp>
FM_HD bool search_step(const T& t, const SearchArgs<R>& a,
                       const Fc4<R>& fc, const Grp& g, SearchLane<R>& s) {
  const int n = s.n;
  R e_top = -1, e_bot = -1;
  int e_len, e_cur;
  if (s.ext) {
    // ---- extend one char; top and bot rank from their own blocks, both
    // rows read at once; a one-row range extends only if BWT[top] == c
    // and top is not the '$' row, the code and the rank from one read of
    // its row ----
    bool more = s.dep < n;
    const int c = more ? read_code(s.rd, s.dep) : 4;
    more = more && c <= 3;
    R t2 = 0, b2 = 0;
    if (more && s.bot - s.top == 1) {
      more = s.top != t.zoff;
      if (more) {
        ++s.reads;
        int code;
        const R rk = scan_rank<R>(t, g, s.top, c, &code);
        more = code == c;
        t2 = fc.at(c) + rk;
        b2 = t2 + 1;
      }
    } else if (more) {
      ++s.reads;
      R rt, rb;
      rank_pair<R>(t, g, s.top, s.bot, c, &rt, &rb);
      t2 = fc.at(c) + rt;
      b2 = fc.at(c) + rb;
      more = b2 > t2;
    }
    if (more) {
      s.top = t2;
      s.bot = b2;
      ++s.dep;
      return true;
    }
    e_top = s.top;
    e_bot = s.bot;
    e_len = s.dep - s.cur;
    e_cur = s.dep;
    s.ext = false;
  } else {
    // ---- start: deep 12-char prime, else the 10-char ftab window ----
    const int left = n - s.cur;
    if (t.deep() && !s.no12 && left >= 12) {
      int64_t fi12 = 0;
      bool has_n = false;
      for (int j = 0; j < 12; ++j) {
        const int c = read_code(s.rd, s.cur + j);
        has_n |= c > 3;
        fi12 |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
      }
      if (!has_n) {
        t.ftab12_at(fi12, &s.top, &s.bot);
        ++s.reads;
        // an empty 12-mer range retries this start on the plain path
        s.no12 = s.bot <= s.top;
        s.ext = !s.no12;
        s.dep = s.cur + 12;
        return true;
      }
    }
    if (left < kFtabChars) {
      e_len = left;
      e_cur = n;
    } else {
      int fn = kFtabChars;
      int64_t fi = 0;
      for (int j = 0; j < kFtabChars; ++j) {
        const int c = read_code(s.rd, s.cur + j);
        if (c > 3 && fn == kFtabChars) fn = j;
        fi |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
      }
      if (fn < kFtabChars) {
        e_len = fn + 1;
        e_cur = s.cur + fn + 1;
      } else {
        t.ftab10(fi, &s.top, &s.bot);
        ++s.reads;
        if (s.bot > s.top) {
          s.ext = true;
          s.dep = s.cur + kFtabChars;
          return true;
        }
        e_len = kFtabChars;
        e_cur = s.cur + kFtabChars;
      }
    }
  }
  // ---- emit ----
  if (g.leader()) {
    const int64_t slot = s.lane * a.mh + (s.nh < a.mh ? s.nh : a.mh - 1);
    a.h_top[slot] = e_top;
    a.h_bot[slot] = e_bot;
    a.h_off[slot] = s.cur;
    a.h_len[slot] = e_len;
  }
  ++s.nh;
  if (e_len >= a.min_hitlen) s.sum += e_len;
  s.no12 = false;
  // ---- driver policy: skip one position after a long hit, stop when
  // the tail can no longer hold a min_hitlen hit ----
  if (!a.first_hit_only && e_cur < n) {
    const int next = e_len > a.increment ? e_cur + 1 : e_cur;
    if (next + a.min_hitlen < n) {
      s.cur = next;
      return true;
    }
  }
  search_end<R>(a, g, s);
  return false;
}

// One lane run to its end by the group g; returns its count of table
// reads: the lockstep loop's step count for this lane.
template <typename R, typename T, typename Grp>
FM_HD int search_lane(const T& t, const SearchArgs<R>& a, int64_t lane,
                      const Grp& g) {
  const Fc4<R> fc = load_fc<R>(t);
  SearchLane<R> s;
  if (search_begin<R>(a, lane, g, &s))
    while (search_step<R>(t, a, fc, g, s)) {
    }
  return s.reads;
}

// ---- SA resolution (K3, K6): SA row -> sequence index ----

template <typename R>
struct ResolveArgs {
  const R* brows;        // [nb] sorted genome-boundary rows
  const int32_t* brefs;  // [nb] their refs
  int64_t nb;
  int32_t offrate;
  int32_t narrow;     // npat <= 0xFFFF: boundary refs masked to 16 bits
  int32_t max_steps;  // LF step bound, tested once per T::kUnroll steps
};

// The exits of one row (ops/fm_jax.py _try_offset of the JAX package;
// tryOffset, bt2_idx.h:1980-2014): the '$' row gives 0 and wins; else a
// sampled row gives its sample (the reader's: clipped to the padded
// table, or 0 where no shard owns it); else a boundary row gives its
// ref, checked only when the last boundary row is nonzero and the row
// does not pass it; else -1. Every thread of a group runs the binary
// search over the boundary rows (a few hundred bytes, held in L1).
template <typename R, typename T>
FM_HD int32_t try_offset(const T& t, const ResolveArgs<R>& a, R row) {
  int32_t v = -1;
  if ((row & (((R)1 << a.offrate) - 1)) == 0) {
    v = t.sample(row >> a.offrate);
  } else if (a.nb > 0) {
    int64_t lo = 0, hi = a.nb;  // searchsorted, side "left"
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (ldg(a.brows + mid) < row) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t pos = lo < a.nb ? lo : a.nb - 1;
    const R last = ldg(a.brows + a.nb - 1);
    if (ldg(a.brows + pos) == row && last > 0 && row <= last)
      v = a.narrow ? (ldg(a.brefs + pos) & 0xFFFF) : ldg(a.brefs + pos);
  }
  if (row == t.zoff) v = 0;
  return v;
}

// The walk's LF step bound: the JAX walks count steps and test max_steps
// once per unrolled while-loop iteration (8 steps on one device, 4 over
// shards), so they give up after max_steps rounded up to a multiple of
// the unroll.
FM_HD int64_t walk_budget(int64_t max_steps, int unroll) {
  return (max_steps + unroll - 1) / unroll * unroll;
}

// The LF walk of one row until an exit, or -1 after walk_budget steps.
// A row's result does not depend on the other rows of its batch, so the
// per-row walk gives the lockstep walk's output. Each LF step takes the
// code and the rank from one scan of the row by the group g, and the
// next row's fetch is asked for while its exits are checked. *rounds,
// where given, receives the row's rounds of table reads (its exits, then
// one per LF step): the lockstep walk's step count for this row.
template <typename R, typename T, typename Grp>
FM_HD int32_t resolve_row(const T& t, const ResolveArgs<R>& a, R row,
                          const Grp& g, int64_t* rounds = nullptr) {
  const Fc4<R> fc = load_fc<R>(t);
  prefetch_row<R>(t, row);
  int32_t v = try_offset<R>(t, a, row);
  const int64_t budget = walk_budget(a.max_steps, T::kUnroll);
  int64_t k = 0;
  for (; v < 0 && k < budget; ++k) {
    int code;
    const R rk = scan_rank<R>(t, g, row, -1, &code);
    row = fc.at(code) + rk;
    prefetch_row<R>(t, row);
    v = try_offset<R>(t, a, row);
  }
  if (rounds != nullptr) *rounds = k + 1;
  return v;
}

// ---- presolve pick (K5): the SA rows a mate's classification asks for ----

template <typename R>
struct PickArgs {
  const R* h_top;  // [2M, mh] first-pass hit buffers; lanes 2m, 2m+1 are
  const R* h_bot;  // mate m's fw and rc strands
  const int32_t* h_len;
  int32_t mh;
  int32_t khits;
  int32_t ihits;
  int32_t min_hitlen;
  int32_t rk;
  R* rows;         // [M, rk]; unused slots 0
  int32_t* nrows;  // [M]
};

template <typename R>
FM_HD R hit_size(const R* t, const R* b, int i) {
  return t[i] >= 0 ? b[i] - t[i] : 0;
}

// Mate m's rows, as classify/engine.py _presolve_pick_rows of the JAX
// package: strand choice by score then max length, the
// max_genome_hit_size budget mghs, the gate len > min_hitlen, size != 0,
// chosen strand, min(size, mghs) <= ihits; gated hits in the stable
// order of the key min(size, 2^18) * 4096 - len (fw hits before rc on
// ties), each taken while the nelts before it sum to less than mghs,
// its rows laid into the rk slots from that sum on. Entry i is strand
// i / mh, slot i % mh. A hit's place in the stable order is the number
// of gated hits that sort before it, so no sort is needed: 2 mh is at
// most 32 on the first pass.
template <typename R>
FM_HD void pick_mate(const PickArgs<R>& a, int64_t m) {
  const int mh = a.mh, n = 2 * a.mh;
  const R* t = a.h_top + 2 * m * mh;
  const R* b = a.h_bot + 2 * m * mh;
  const int32_t* ln = a.h_len + 2 * m * mh;
  int32_t sc[2] = {0, 0}, mx[2] = {0, 0};
  for (int i = 0; i < n; ++i) {
    const int s = i / mh;
    if (ln[i] >= a.min_hitlen && hit_size<R>(t, b, i) != 0) {
      sc[s] += (ln[i] - 15) * (ln[i] - 15);
      if (ln[i] > mx[s]) mx[s] = ln[i];
    }
  }
  const bool fw = sc[0] > sc[1] || (sc[0] == sc[1] && mx[0] > mx[1]);
  const bool rc = sc[1] > sc[0] || (sc[0] == sc[1] && mx[1] > mx[0]);
  const bool use[2] = {fw || (!fw && !rc), rc || (!fw && !rc)};
  R maxsz = 0;
  for (int i = 0; i < n; ++i) {
    const R size = hit_size<R>(t, b, i);
    if (ln[i] >= a.min_hitlen && size != 0 && use[i / mh] && size > maxsz)
      maxsz = size;
  }
  const R mghs = maxsz > (R)a.khits
                     ? maxsz + (R)((int)use[0] + (int)use[1]) * (R)a.khits
                     : (R)a.khits;
  R* rows = a.rows + m * a.rk;
  for (int s = 0; s < a.rk; ++s) rows[s] = 0;
  R total = 0;
  for (int i = 0; i < n; ++i) {
    const R size = hit_size<R>(t, b, i);
    const R nelt = size < mghs ? size : mghs;
    if (!(ln[i] > a.min_hitlen && size != 0 && use[i / mh] &&
          nelt <= (R)a.ihits))
      continue;
    const R key = (size < ((R)1 << 18) ? size : ((R)1 << 18)) * 4096 - ln[i];
    R prev = 0;  // nelts of the gated hits that sort before hit i
    for (int k = 0; k < n; ++k) {
      const R sk = hit_size<R>(t, b, k);
      const R nk = sk < mghs ? sk : mghs;
      if (k == i || !(ln[k] > a.min_hitlen && sk != 0 && use[k / mh] &&
                      nk <= (R)a.ihits))
        continue;
      const R kk = (sk < ((R)1 << 18) ? sk : ((R)1 << 18)) * 4096 - ln[k];
      if (kk < key || (kk == key && k < i)) prev += nk;
    }
    if (nelt > 0 && prev < mghs) {
      total += nelt;
      for (R s = prev; s < prev + nelt && s < (R)a.rk; ++s)
        rows[s] = t[i] + (s - prev);
    }
  }
  a.nrows[m] = (int32_t)(total < (R)a.rk ? total : (R)a.rk);
}

}  // namespace fm
