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
// G = 1, and the host twin at every G). K0 ranks each query with the
// same row scan (scan_rank); its level-1 entry and K4 scan both ends of
// a range once for every code (scan_ends, ftab12_range) under the same
// groups, and K5 picks a mate's rows
// (mate_rows) under a group of 32 lanes: Tile<32>, a warp, on the card,
// Serial<32> in the twin. Tables are read through the read-only path
// (ldg).
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

FM_HD int popc64(uint64_t x) {
#if defined(__CUDA_ARCH__)
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// the index of the lowest set bit (x != 0)
FM_HD int ctz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
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

// An entry's (top, bot) in one 8-byte (narrow) or 16-byte (wide) store
// on the card. Rows are 144 and 160 bytes, so with the table 16-byte
// aligned every entry is aligned to its size.
template <typename R>
FM_HD void ftab_store(uint32_t* rows, int64_t fi, R top, R bot) {
  uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    uint32_t* q = row + (int)(fi & 7) * 4;
    const uint32_t v[4] = {(uint32_t)((uint64_t)top & 0xFFFFFFFFu),
                           (uint32_t)((uint64_t)top >> 32),
                           (uint32_t)((uint64_t)bot & 0xFFFFFFFFu),
                           (uint32_t)((uint64_t)bot >> 32)};
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint4*>(q) = make_uint4(v[0], v[1], v[2], v[3]);
#else
    for (int k = 0; k < 4; ++k) q[k] = v[k];
#endif
  } else {
    uint32_t* q = row + (int)(fi & 15) * 2;
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<uint2*>(q) = make_uint2((uint32_t)top, (uint32_t)bot);
#else
    q[0] = (uint32_t)top;
    q[1] = (uint32_t)bot;
#endif
  }
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

// K5 runs one mate on a warp, lane p holding its entries p, p + 32, ...:
// the per-lane steps are functions of the lane p, and the group gives
// the collectives over them. vals(f) is each lane's f(p) (own(p), the
// lane's own; at(k), lane k's, a shuffle on the card); sum, max and
// ballot reduce f over the lanes; each(f) runs f for the thread's lanes.
template <typename T, int G>
struct SerialVals {
  T v[G];
  FM_HDM T own(int p) const { return v[p]; }
  FM_HDM T at(int k) const { return v[k]; }
};

// A group's stage for K1's pool mode (stage_words(mh) words: 3 mh, and
// one more so that the stages of a warp's tiles start in different banks)
FM_HD int stage_words(int mh) { return 3 * mh + 1; }

template <int G>
struct Serial {
  static constexpr int kG = G;
  int32_t* stage_buf = nullptr;  // the caller's stage (the twin's loop)
  FM_HDM int32_t* stage(int) const { return stage_buf; }
  template <typename Part>
  FM_HDM auto sum(const Part& part) const -> decltype(part(0)) {
    decltype(part(0)) s = 0;
    for (int p = 0; p < G; ++p) s += part(p);
    return s;
  }
  template <typename F>
  FM_HDM auto max(const F& f) const -> decltype(f(0)) {
    decltype(f(0)) m = f(0);
    for (int p = 1; p < G; ++p) {
      const auto v = f(p);
      if (v > m) m = v;
    }
    return m;
  }
  template <typename F>
  FM_HDM uint32_t ballot(const F& f) const {
    uint32_t b = 0;
    for (int p = 0; p < G; ++p) b |= (f(p) ? 1u : 0u) << p;
    return b;
  }
  template <typename F>
  FM_HDM auto vals(const F& f) const -> SerialVals<decltype(f(0)), G> {
    SerialVals<decltype(f(0)), G> v;
    for (int p = 0; p < G; ++p) v.v[p] = f(p);
    return v;
  }
  template <typename F>
  FM_HDM void each(const F& f) const {
    for (int p = 0; p < G; ++p) f(p);
  }
  FM_HDM bool leader() const { return true; }
  FM_HDM int rank() const { return 0; }
  FM_HDM int size() const { return 1; }
  FM_HDM void sync() const {}
  // n items reserved on a counter that only this group adds to: the
  // twin's loop over lanes, the one caller in pool mode (K6 runs padded)
  FM_HDM int64_t reserve(int32_t* next, int n) const {
    const int32_t v = *next;
    *next = v + n;
    return (int64_t)v;
  }
};

#if defined(__CUDACC__)
namespace cg = cooperative_groups;

// The members run on the card only; the host pass of nvcc sees bodies
// that it never calls.
template <typename T, int G>
struct TileVals {
  T mine;
  const cg::thread_block_tile<G>* tile;
  FM_HDM T own(int) const { return mine; }
  FM_HDM T at(int k) const {
#if defined(__CUDA_ARCH__)
    return tile->shfl(mine, k);
#else
    (void)k;
    return mine;
#endif
  }
};

template <int G>
struct Tile {
  static constexpr int kG = G;
  cg::thread_block_tile<G> tile;
  // the tile's stage: its part of the block's dynamic shared memory
  FM_HDM int32_t* stage(int mh) const {
#if defined(__CUDA_ARCH__)
    extern __shared__ int32_t fm_tile_stages[];
    return fm_tile_stages + threadIdx.x / G * stage_words(mh);
#else
    (void)mh;
    return nullptr;
#endif
  }
  template <typename Part>
  FM_HDM auto sum(const Part& part) const -> decltype(part(0)) {
    using T = decltype(part(0));
#if defined(__CUDA_ARCH__)
    return cg::reduce(tile, part((int)tile.thread_rank()), cg::plus<T>());
#else
    return part(0);
#endif
  }
  template <typename F>
  FM_HDM auto max(const F& f) const -> decltype(f(0)) {
    using T = decltype(f(0));
#if defined(__CUDA_ARCH__)
    return cg::reduce(tile, f((int)tile.thread_rank()), cg::greater<T>());
#else
    return f(0);
#endif
  }
  template <typename F>
  FM_HDM uint32_t ballot(const F& f) const {
#if defined(__CUDA_ARCH__)
    return tile.ballot(f((int)tile.thread_rank()));
#else
    return f(0) ? 1u : 0u;
#endif
  }
  template <typename F>
  FM_HDM auto vals(const F& f) const -> TileVals<decltype(f(0)), G> {
    return TileVals<decltype(f(0)), G>{f(rank()), &tile};
  }
  template <typename F>
  FM_HDM void each(const F& f) const {
    f(rank());
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
  FM_HDM int64_t take(int32_t* next) const { return reserve(next, 1); }
  // n items reserved the same way: the first of them
  FM_HDM int64_t reserve(int32_t* next, int n) const {
#if defined(__CUDA_ARCH__)
    int32_t v = 0;
    if (tile.thread_rank() == 0) v = atomicAdd(next, n);
    return (int64_t)tile.shfl(v, 0);
#else
    (void)next;
    (void)n;
    return 0;
#endif
  }
};

// The group of G threads that runs one item on the card: G threads of a
// warp, or at G = 1 the one-thread group.
template <int G>
__device__ __forceinline__ auto card_group() {
  if constexpr (G == 1) {
    return Serial<1>{};
  } else {
    return Tile<G>{cg::tiled_partition<G>(cg::this_thread_block())};
  }
}

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

// ---- the scan of a block row by a group (K0, K1, K3, K6) ----

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

// ---- ranges extended by every code (K0's level 1, K4) ----

// Part p (of G) of the all-code scans of two rows: the bit planes before
// `wa` in row a (bits 0-26, as ScanPart<G, true> counts them) and before
// `wb` in row b (bits 32-58). Both rows' loads are issued before either
// is counted, and a row that both ends share is read once, as in
// PairPart. A chunk wholly past its end is not read and counts nothing.
template <int G>
struct PairAllPart {
  const uint32_t* a;
  const uint32_t* b;
  int wa, wb;
  FM_HDM uint64_t operator()(int p) const {
    constexpr int K = kChunks / G;
    const bool same = a == b;
    U4 qa[K]{}, qb[K]{};
    FM_UNROLL
    for (int i = 0; i < K; ++i) {
      const int k = i * G + p;
      const bool la = 64 * k < wa, lb = 64 * k < wb;
      if (same) {
        if (la || lb) qa[i] = qb[i] = ldg4(a + 4 * k);
      } else {
        if (la) qa[i] = ldg4(a + 4 * k);
        if (lb) qb[i] = ldg4(b + 4 * k);
      }
    }
    uint64_t s = 0;
    FM_UNROLL
    for (int i = 0; i < K; ++i) {
      const int k = i * G + p;
      s += (uint64_t)planes_before(qa[i], k, wa) +
           ((uint64_t)planes_before(qb[i], k, wb) << 32);
    }
    return s;
  }
};

// Both ends of a range [lt, lb), scanned once by a group for every
// code: the block rows of both ends read once (a row they share, once),
// every code counted before each end in one scan, so LF(lt, c) and
// LF(lb, c) of all four codes come from it with the '$' correction once
// per end. An empty range (lb <= lt) reads nothing and extends to (0, 0),
// the guard of native/fmwalk.cpp fm_ftab_extend at both levels.
template <typename R>
struct EndsLF {
  Occ<R> ot, ob;
  uint64_t f;  // the planes before lt (bits 0-26) and lb (bits 32-58)
  R lt, lb;
  FM_HDM bool live() const { return lb > lt; }
  FM_HDM R top(const Fc4<R>& fc, R zoff, int c) const {
    return live() ? fc.at(c) + ot.at(c) +
                        (R)count_of((uint32_t)f, (int)(lt & 511), c) -
                        (R)((c == 0 && zoff < lt) ? 1 : 0)
                  : (R)0;
  }
  FM_HDM R bot(const Fc4<R>& fc, R zoff, int c) const {
    return live() ? fc.at(c) + ob.at(c) +
                        (R)count_of((uint32_t)(f >> 32), (int)(lb & 511),
                                    c) -
                        (R)((c == 0 && zoff < lb) ? 1 : 0)
                  : (R)0;
  }
};

template <typename R, typename Grp>
FM_HD EndsLF<R> scan_ends(const uint32_t* blocks, const Grp& g, R lt,
                          R lb) {
  EndsLF<R> e{};
  e.lt = lt;
  e.lb = lb;
  if (e.live()) {
    const uint32_t* rt = blocks + (int64_t)(lt >> 9) * Geo<R>::kWidth;
    const uint32_t* rb = blocks + (int64_t)(lb >> 9) * Geo<R>::kWidth;
    e.ot = load_occ<R>(rt);
    e.ob = load_occ<R>(rb);
    e.f = g.sum(PairAllPart<Grp::kG>{rt + Geo<R>::kWordOff,
                                     rb + Geo<R>::kWordOff, (int)(lt & 511),
                                     (int)(lb & 511)});
  }
  return e;
}

// ---- the depth-12 ftab (K4): one level-1 range a group ----

// The 2^22 level-1 ranges: i1 = e10 | c10 << 20, t1/b1[i1] = LF(t0[e10],
// c10) / LF(b0[e10], c10) from K0's level-1 entry (scan_ends of the
// depth-10 range); the depth-12 entries of i1 are idx = i1 | c11 << 22
// (the window layout of the search: the char at cur + j sits at bits
// 2j).
constexpr int64_t kN10 = (int64_t)1 << 20;
constexpr int64_t kN1 = (int64_t)1 << 22;

template <typename R>
struct Ftab12Args {
  const uint32_t* blocks;
  R zoff;
  const R* t0;  // [2^20] the depth-10 ranges
  const R* b0;
  const R* t1;  // [2^22] their level-1 extensions
  const R* b1;
  uint32_t* out;  // packed depth-12 rows
};

// Level-1 range i1 under the guard of native/fmwalk.cpp fm_ftab_extend:
// an empty depth-10 parent gives the empty range (0, 0). The four loads
// do not wait on each other.
template <typename R>
FM_HD void level1_range(const Ftab12Args<R>& a, int64_t i1, R* lt, R* lb) {
  const int64_t e10 = i1 & (kN10 - 1);
  const R t0 = ldg(a.t0 + e10), b0 = ldg(a.b0 + e10);
  const R t1 = ldg(a.t1 + i1), b1 = ldg(a.b1 + i1);
  const bool parent = b0 > t0;
  *lt = parent ? t1 : (R)0;
  *lb = parent ? b1 : (R)0;
}

// The four depth-12 entries that extend level-1 range i1, (lt, lb) as
// level1_range gives it, by the group g: both ends scanned once
// (scan_ends), LF of both ends for every c11, the group's threads
// splitting the four stores.
template <typename R, typename Grp>
FM_HD void ftab12_range(const Ftab12Args<R>& a, const Fc4<R>& fc,
                        const Grp& g, int64_t i1, R lt, R lb) {
  const EndsLF<R> e = scan_ends<R>(a.blocks, g, lt, lb);
  for (int c = g.rank(); c < 4; c += g.size())
    ftab_store<R>(a.out, i1 | ((int64_t)c << 22), e.top(fc, a.zoff, c),
                  e.bot(fc, a.zoff, c));
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
  // Pool mode (pool set; narrow rows only): the h_* buffers and nhits,
  // sums are unused. A lane's min(nh, mh) hits, in emission order, go to
  // the records [base[lane], base[lane] + n) of a dense pool shared by
  // all lanes, n reserved on *pool_next when the lane ends; a record is
  // {top, bot, off << 16 | len} (int32), record j at pool + 3 j below
  // `budget`, at spill + 3 (j - budget) from it; tail[lane] is
  // nh << 16 | sum.
  int32_t* pool = nullptr;
  int32_t* spill = nullptr;
  int64_t budget = 0;
  int32_t* base = nullptr;  // [L]
  int32_t* tail = nullptr;  // [L]
  int32_t* pool_next = nullptr;
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
// an overflowing lane's last slot ends as its last hit). In pool mode
// (SearchArgs.pool) the leader writes each hit to the group's stage
// (g.stage) instead, by the same slot rule, and the lane's end moves the
// staged records to the pool.
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

// the lane's counts, once it is done; in pool mode also its records: the
// leader reserves them with one add on the pool counter, and the group
// copies them from its stage
template <typename R, typename Grp>
FM_HD void search_end(const SearchArgs<R>& a, const Grp& g,
                      const SearchLane<R>& s) {
  if (a.pool == nullptr) {
    if (g.leader()) {
      a.nhits[s.lane] = s.nh;
      a.sums[s.lane] = s.sum;
    }
    return;
  }
  const int n = s.nh < a.mh ? s.nh : a.mh;
  const int64_t b = n > 0 ? g.reserve(a.pool_next, n) : 0;
  g.sync();  // the leader's staged records, to every thread of the group
  const int32_t* stage = g.stage(a.mh);
  for (int k = g.rank(); k < 3 * n; k += g.size()) {
    const int64_t j = b + k / 3;
    int32_t* rec = j < a.budget ? a.pool + 3 * j
                                : a.spill + 3 * (j - a.budget);
    rec[k % 3] = stage[k];
  }
  if (g.leader()) {
    a.base[s.lane] = (int32_t)b;
    a.tail[s.lane] = (int32_t)((uint32_t)s.nh << 16 | (uint32_t)s.sum);
  }
}

// Sets up lane; false when it has nothing to scan (its counts written).
template <typename R, typename Grp>
FM_HD bool search_begin(const SearchArgs<R>& a, int64_t lane, const Grp& g,
                        SearchLane<R>* s) {
  if (a.pool == nullptr) {
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
  }
  // the slots cleared, or the stage's last lane copied out, before the
  // leader writes a hit
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
    const int k = s.nh < a.mh ? s.nh : a.mh - 1;
    if (a.pool != nullptr) {
      int32_t* rec = g.stage(a.mh) + 3 * k;
      rec[0] = (int32_t)e_top;
      rec[1] = (int32_t)e_bot;
      rec[2] = (int32_t)((uint32_t)s.cur << 16 | (uint32_t)e_len);
    } else {
      const int64_t slot = s.lane * a.mh + k;
      a.h_top[slot] = e_top;
      a.h_bot[slot] = e_bot;
      a.h_off[slot] = s.cur;
      a.h_len[slot] = e_len;
    }
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

// ---- the presolve (K5): the SA rows a mate's classification asks for ----

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
  R* flat;    // [n] the mates' rows, one after another
  int64_t n;
};

// A kernel block's mates (kPickWarps warps of kPickMatesPerWarp mates):
// the block scans their row counts as one warp. A mate lays at most
// kPickMaxRk rows (the block stages its mates' rows in shared memory).
constexpr int kPickWarps = 16;
constexpr int kPickMatesPerWarp = 2;
constexpr int kPickMates = kPickWarps * kPickMatesPerWarp;  // 32
constexpr int kPickMaxRk = 128;

// Entry i (0..2 mh) of mate m: strand i / mh, slot i % mh; past 2 mh,
// an empty entry.
template <typename R>
struct Hit {
  R top, size;
  int32_t len;
};

template <typename R>
FM_HD Hit<R> load_hit(const PickArgs<R>& a, int64_t m, int i) {
  Hit<R> h{0, 0, 0};
  if (i < 2 * a.mh) {
    const int64_t o = 2 * m * a.mh + i;
    h.top = ldg(a.h_top + o);
    h.size = h.top >= 0 ? ldg(a.h_bot + o) - h.top : (R)0;
    h.len = ldg(a.h_len + o);
  }
  return h;
}

// Mate m's rows, as classify/engine.py _presolve_pick_rows of the JAX
// package, on a group of 32 lanes (a warp on the card), lane p holding
// entries p, p + 32, ...: the strand choice by score (the sign of one
// warp sum of fw's scores less rc's) then max length (warp maxima), the
// max_genome_hit_size budget mghs, the gate len > min_hitlen, size !=
// 0, chosen strand, nelt = min(size, mghs) <= ihits; gated hits in the
// stable order of the key min(size, 2^18) * 4096 - len, fw before rc on
// ties. A hit's place is the sum `prev` of the nelts of the gated hits
// that sort before it, from the keys and nelts shuffled round the warp
// (only lanes whose nelt is not 0 are visited); it is taken when nelt >
// 0 and prev < mghs, its rows laid into rows[prev ..], clipped to rk.
// Returns nrows = min(total, rk); rows[0 .. nrows) are written.
template <typename R, typename W>
FM_HD int32_t mate_rows(const PickArgs<R>& a, const W& w, int64_t m,
                        R* rows) {
  constexpr int P = W::kG;
  const int mh = a.mh, rounds = (2 * mh + P - 1) / P;
  const auto scoring = [&](const Hit<R>& e) {
    return e.len >= a.min_hitlen && e.size != 0;
  };
  int64_t diff = 0;  // fw's score less rc's
  int32_t mx[2] = {0, 0};
  for (int r = 0; r < rounds; ++r) {
    const auto h = w.vals([&](int p) { return load_hit<R>(a, m, r * P + p); });
    diff += w.sum([&](int p) -> int64_t {
      const Hit<R> e = h.own(p);
      const int64_t l = e.len, sc = scoring(e) ? (l - 15) * (l - 15) : 0;
      return r * P + p < mh ? sc : -sc;
    });
    for (int s = 0; s < 2; ++s) {
      const int32_t v = w.max([&](int p) -> int32_t {
        const Hit<R> e = h.own(p);
        return scoring(e) && (r * P + p < mh) == (s == 0) ? e.len : 0;
      });
      if (v > mx[s]) mx[s] = v;
    }
  }
  const bool fw = diff > 0 || (diff == 0 && mx[0] > mx[1]);
  const bool rc = diff < 0 || (diff == 0 && mx[1] > mx[0]);
  const bool use0 = fw || !rc, use1 = rc || !fw;
  // entry i's strand is chosen (an entry past 2 mh is empty)
  const auto uses = [&](int i) { return i < mh ? use0 : use1; };
  R maxsz = 0;
  for (int r = 0; r < rounds; ++r) {
    const R v = w.max([&](int p) -> R {
      const Hit<R> e = load_hit<R>(a, m, r * P + p);
      return scoring(e) && uses(r * P + p) ? e.size : (R)0;
    });
    if (v > maxsz) maxsz = v;
  }
  const int64_t mghs =
      maxsz > (R)a.khits
          ? (int64_t)maxsz + ((int64_t)use0 + (int64_t)use1) * a.khits
          : (int64_t)a.khits;
  // entry i's sort key and nelt (0 when not gated)
  struct Keyed {
    int64_t key, nelt;
    R top;
  };
  const auto keyed = [&](int i) {
    const Hit<R> e = load_hit<R>(a, m, i);
    const int64_t size = e.size, nelt = size < mghs ? size : mghs;
    Keyed k;
    k.key = (size < ((int64_t)1 << 18) ? size : ((int64_t)1 << 18)) * 4096 -
            e.len;
    k.nelt = e.len > a.min_hitlen && size != 0 && uses(i) && nelt <= a.ihits
                 ? nelt
                 : 0;
    k.top = e.top;
    return k;
  };
  int64_t total = 0;
  for (int r = 0; r < rounds; ++r) {
    const auto me = w.vals([&](int p) { return keyed(r * P + p); });
    auto prev = w.vals([](int) -> int64_t { return 0; });
    for (int r2 = 0; r2 < rounds; ++r2) {
      const auto other = w.vals([&](int p) {
        return r2 == r ? me.own(p) : keyed(r2 * P + p);
      });
      const auto okey = w.vals([&](int p) { return other.own(p).key; });
      const auto onelt = w.vals([&](int p) { return other.own(p).nelt; });
      // the entries that add to a prev: gated, nelt not 0
      const uint32_t live = w.ballot([&](int p) { return onelt.own(p) != 0; });
      prev = w.vals([&](int p) {
        int64_t s = prev.own(p);
        const int64_t mine = me.own(p).key;
        const int i = r * P + p;
        for (uint32_t bits = live; bits != 0; bits &= bits - 1) {
          const int k = ctz32(bits);
          const int64_t kk = okey.at(k), nk = onelt.at(k);
          if (kk < mine || (kk == mine && r2 * P + k < i)) s += nk;
        }
        return s;
      });
    }
    const auto taken = [&](int p) {
      return me.own(p).nelt > 0 && prev.own(p) < mghs;
    };
    total += w.sum([&](int p) -> int64_t {
      return taken(p) ? me.own(p).nelt : 0;
    });
    w.each([&](int p) {
      if (!taken(p)) return;
      const int64_t lo = prev.own(p), hi = lo + me.own(p).nelt;
      const R top = me.own(p).top;
      for (int64_t s = lo; s < hi && s < a.rk; ++s)
        rows[s] = top + (R)(s - lo);
    });
  }
  return (int32_t)(total < a.rk ? total : a.rk);
}

// A mate's nrows rows into flat[doff ..], slots past n dropped: slots
// rank, rank + size, ... of them, for the thread `rank` of `size`.
template <typename R>
FM_HD void lay_rows(const R* rows, int32_t nrows, int64_t doff, R* flat,
                    int64_t n, int rank, int size) {
  for (int s = rank; s < nrows; s += size)
    if (doff + s < n) flat[doff + s] = rows[s];
}

// The flat slots from the mates' grand total to n hold 0: slots rank,
// rank + size, ... of them, for the thread `rank` of `size`.
template <typename R>
FM_HD void fill_tail(R* flat, int64_t total, int64_t n, int rank, int size) {
  for (int64_t j = (total < n ? total : n) + rank; j < n; j += size)
    flat[j] = 0;
}

}  // namespace fm
