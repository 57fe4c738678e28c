// Host build of fm_common.cuh, for the CPU tests only: the per-lane
// functions the CUDA kernels call, looped over the lanes on the host, so
// the kernels' arithmetic is checked against the plain PyTorch versions
// on a machine without a CUDA compiler. The port itself never loads it:
// on the CPU its wrappers run the plain versions.
//
// The search, the walk and the row scan run under fm::Serial<G>, the
// one-thread group that computes the G parts of every row scan in a loop
// and sums them: the part functions that a tile of G threads runs on the
// card (K1, K3), and at G = 1 K6's group. `group` selects G (1, 2, 4 or
// 8); an entry returns -1 for any other.
//
//   g++ -std=c++17 -O2 -shared -fPIC cpu_twin.cpp -o cpu_twin.so
#include <stdint.h>

#include "fm_common.cuh"

namespace {

// f(fm::Serial<G>{}) for group G, or -1
template <typename F>
int64_t with_group(int32_t group, F&& f) {
  switch (group) {
    case 1:
      return f(fm::Serial<1>{});
    case 2:
      return f(fm::Serial<2>{});
    case 4:
      return f(fm::Serial<4>{});
    case 8:
      return f(fm::Serial<8>{});
    default:
      return -1;
  }
}

// group 0: K0's rank (fm::rank) of each (row, char). Else the group's
// row scan: the rank of each (row, char) into out (char -1: of BWT[row])
// and BWT[row] into codes, and into pair_out, where every char is 0..3,
// the two ranks of each pair of queries (2m, 2m + 1), both of char 2m,
// from one pair scan.
template <typename R>
int64_t rank_all(const void* blocks, const void* fchr, int64_t zoff,
                 const void* rows, const void* chars, void* out, int64_t n,
                 int32_t group, void* codes, void* pair_out) {
  const R* rr = (const R*)rows;
  const int32_t* cc = (const int32_t*)chars;
  const R* fc = (const R*)fchr;
  R* o = (R*)out;
  if (group == 0) {
    for (int64_t i = 0; i < n; ++i) {
      R r = fm::rank<R>((const uint32_t*)blocks, (R)zoff, rr[i], cc[i]);
      o[i] = fc != nullptr ? fc[cc[i]] + r : r;
    }
    return 0;
  }
  fm::FlatTables<R> t{};
  t.blocks = (const uint32_t*)blocks;
  t.zoff = (R)zoff;
  return with_group(group, [&](auto g) -> int64_t {
    for (int64_t i = 0; i < n; ++i) {
      int code = 0;
      const R r = fm::scan_rank<R>(t, g, rr[i], cc[i], &code);
      o[i] = fc != nullptr ? fc[cc[i] < 0 ? code : cc[i]] + r : r;
      ((int32_t*)codes)[i] = code;
    }
    R* po = (R*)pair_out;
    for (int64_t i = 0; i + 1 < n && cc[i] >= 0; i += 2)
      fm::rank_pair<R>(t, g, rr[i], rr[i + 1], cc[i], po + i, po + i + 1);
    return 0;
  });
}

template <typename R>
fm::SearchArgs<R> search_args(const void* reads, int64_t row_bytes,
                              const void* lengths, const void* start,
                              void* h_top, void* h_bot, void* h_off,
                              void* h_len, void* nhits, void* sums,
                              int32_t mh, int32_t min_hitlen,
                              int32_t increment, int32_t first_hit_only) {
  fm::SearchArgs<R> a;
  a.reads = (const uint8_t*)reads;
  a.row_bytes = row_bytes;
  a.lengths = (const int32_t*)lengths;
  a.start = (const int32_t*)start;
  a.h_top = (R*)h_top;
  a.h_bot = (R*)h_bot;
  a.h_off = (int32_t*)h_off;
  a.h_len = (int32_t*)h_len;
  a.nhits = (int32_t*)nhits;
  a.sums = (int32_t*)sums;
  a.mh = mh;
  a.min_hitlen = min_hitlen;
  a.increment = increment;
  a.first_hit_only = first_hit_only;
  return a;
}

// search_lane over every lane; the longest lane's count of table reads
template <typename R, typename T, typename Grp>
int64_t search_lanes(const T& t, const fm::SearchArgs<R>& a, int64_t L,
                     const Grp& g) {
  int64_t most = 0;
  for (int64_t lane = 0; lane < L; ++lane) {
    const int64_t r = fm::search_lane<R>(t, a, lane, g);
    if (r > most) most = r;
  }
  return most;
}

// resolve_row (walk = 1) or try_offset (walk = 0) over every row; the
// longest walk's rounds of table reads
template <typename R, typename T, typename Grp>
int64_t resolve_rows(const T& t, const fm::ResolveArgs<R>& a, int32_t walk,
                     const R* rows, int32_t* tidx, int64_t n, const Grp& g) {
  int64_t most = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t rounds = 1;
    tidx[i] = walk ? fm::resolve_row<R>(t, a, rows[i], g, &rounds)
                   : fm::try_offset<R>(t, a, rows[i]);
    if (rounds > most) most = rounds;
  }
  return most;
}

template <typename R>
fm::ResolveArgs<R> resolve_args(const void* brows, const void* brefs,
                                int64_t nb, int32_t offrate, int32_t narrow,
                                int32_t max_steps) {
  fm::ResolveArgs<R> a;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.max_steps = max_steps;
  return a;
}

// Returns the longest lane's count of table reads.
template <typename R>
int64_t search_all(const void* blocks, const void* fchr, int64_t zoff,
                   const void* ftab, const void* ftab12, const void* reads,
                   int64_t row_bytes, const void* lengths, const void* start,
                   void* h_top, void* h_bot, void* h_off, void* h_len,
                   void* nhits, void* sums, int64_t L, int32_t mh,
                   int32_t min_hitlen, int32_t increment,
                   int32_t first_hit_only, int32_t deep, int32_t group) {
  fm::FlatTables<R> t{};
  t.blocks = (const uint32_t*)blocks;
  t.fchr = (const R*)fchr;
  t.zoff = (R)zoff;
  t.ftab = (const uint32_t*)ftab;
  t.ftab12 = deep ? (const uint32_t*)ftab12 : nullptr;
  const fm::SearchArgs<R> a =
      search_args<R>(reads, row_bytes, lengths, start, h_top, h_bot, h_off,
                     h_len, nhits, sums, mh, min_hitlen, increment,
                     first_hit_only);
  return with_group(group,
                    [&](auto g) { return search_lanes<R>(t, a, L, g); });
}

template <typename R>
void ftab12_all(const void* blocks, const void* fchr, int64_t zoff,
                const void* t0, const void* b0, const void* t1,
                const void* b1, void* out) {
  for (int64_t idx = 0; idx < ((int64_t)1 << 24); ++idx)
    fm::ftab12_entry<R>((const uint32_t*)blocks, (const R*)fchr, (R)zoff,
                        (const R*)t0, (const R*)b0, (const R*)t1,
                        (const R*)b1, (uint32_t*)out, idx);
}

// the longest walk's rounds of table reads
template <typename R>
int64_t resolve_all(const void* blocks, const void* fchr, int64_t zoff,
                    const void* offs, int64_t noffs, const void* brows,
                    const void* brefs, int64_t nb, int32_t offrate,
                    int32_t narrow, int32_t max_steps, int32_t walk,
                    const void* rows, void* tidx, int64_t n, int32_t group) {
  fm::FlatTables<R> t{};
  t.blocks = (const uint32_t*)blocks;
  t.fchr = (const R*)fchr;
  t.zoff = (R)zoff;
  t.offs = (const int32_t*)offs;
  t.noffs = noffs;
  const fm::ResolveArgs<R> a =
      resolve_args<R>(brows, brefs, nb, offrate, narrow, max_steps);
  return with_group(group, [&](auto g) {
    return resolve_rows<R>(t, a, walk, (const R*)rows, (int32_t*)tidx, n, g);
  });
}

template <typename R>
void pick_all(const void* h_top, const void* h_bot, const void* h_len,
              int64_t M, int32_t mh, int32_t khits, int32_t ihits,
              int32_t min_hitlen, int32_t rk, void* rows, void* nrows) {
  fm::PickArgs<R> a;
  a.h_top = (const R*)h_top;
  a.h_bot = (const R*)h_bot;
  a.h_len = (const int32_t*)h_len;
  a.mh = mh;
  a.khits = khits;
  a.ihits = ihits;
  a.min_hitlen = min_hitlen;
  a.rk = rk;
  a.rows = (R*)rows;
  a.nrows = (int32_t*)nrows;
  for (int64_t m = 0; m < M; ++m) fm::pick_mate<R>(a, m);
}

// K6's lane loops over a dp row's shards, from the descriptor words that
// parallel/sharded.py builds for csrc/sharded.cu. Each returns the
// longest lane's (row's) count of table reads, or -1 for a descriptor
// the kernels refuse.
template <typename R>
int64_t shard_search_all(const int64_t* desc, const void* reads,
                         int64_t row_bytes, const void* lengths,
                         const void* start, void* h_top, void* h_bot,
                         void* h_off, void* h_len, void* nhits, void* sums,
                         int64_t L, int32_t mh, int32_t min_hitlen,
                         int32_t increment, int32_t first_hit_only) {
  fm::ShardSet<R> s;
  if (!fm::shard_set<R>(desc, &s)) return -1;
  return search_lanes<R>(s,
                         search_args<R>(reads, row_bytes, lengths, start,
                                        h_top, h_bot, h_off, h_len, nhits,
                                        sums, mh, min_hitlen, increment,
                                        first_hit_only),
                         L, fm::Serial<1>{});
}

template <typename R>
int64_t shard_resolve_all(const int64_t* desc, const void* brows,
                          const void* brefs, int64_t nb, int32_t offrate,
                          int32_t narrow, int32_t max_steps,
                          const void* rows, void* tidx, int64_t n) {
  fm::ShardSet<R> s;
  if (!fm::shard_set<R>(desc, &s)) return -1;
  return resolve_rows<R>(s,
                         resolve_args<R>(brows, brefs, nb, offrate, narrow,
                                         max_steps),
                         1, (const R*)rows, (int32_t*)tidx, n,
                         fm::Serial<1>{});
}

}  // namespace

#define TWIN(KIND, R)                                                      \
  extern "C" int64_t twin_rank_##KIND(                                     \
      const void* blocks, const void* fchr, int64_t zoff, const void* rows, \
      const void* chars, void* out, int64_t n, int32_t group, void* codes, \
      void* pair_out) {                                                    \
    return rank_all<R>(blocks, fchr, zoff, rows, chars, out, n, group,     \
                       codes, pair_out);                                   \
  }                                                                        \
  extern "C" int64_t twin_search_##KIND(                                   \
      const void* blocks, const void* fchr, int64_t zoff, const void* ftab, \
      const void* ftab12, const void* reads, int64_t row_bytes,            \
      const void* lengths, const void* start, void* h_top, void* h_bot,    \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,        \
      int32_t mh, int32_t min_hitlen, int32_t increment,                   \
      int32_t first_hit_only, int32_t deep, int32_t group) {               \
    return search_all<R>(blocks, fchr, zoff, ftab, ftab12, reads,          \
                         row_bytes, lengths, start, h_top, h_bot, h_off,   \
                         h_len, nhits, sums, L, mh, min_hitlen, increment, \
                         first_hit_only, deep, group);                     \
  }                                                                        \
  extern "C" void twin_ftab12_##KIND(                                      \
      const void* blocks, const void* fchr, int64_t zoff, const void* t0,  \
      const void* b0, const void* t1, const void* b1, void* out) {         \
    ftab12_all<R>(blocks, fchr, zoff, t0, b0, t1, b1, out);                \
  }                                                                        \
  /* walk = 0: try_offset only; walk = 1: resolve_row */                   \
  extern "C" int64_t twin_resolve_##KIND(                                  \
      const void* blocks, const void* fchr, int64_t zoff, const void* offs, \
      int64_t noffs, const void* brows, const void* brefs, int64_t nb,     \
      int32_t offrate, int32_t narrow, int32_t max_steps, int32_t walk,    \
      const void* rows, void* tidx, int64_t n, int32_t group) {            \
    return resolve_all<R>(blocks, fchr, zoff, offs, noffs, brows, brefs,   \
                          nb, offrate, narrow, max_steps, walk, rows, tidx, \
                          n, group);                                       \
  }                                                                        \
  extern "C" void twin_pick_##KIND(                                        \
      const void* h_top, const void* h_bot, const void* h_len, int64_t M,  \
      int32_t mh, int32_t khits, int32_t ihits, int32_t min_hitlen,        \
      int32_t rk, void* rows, void* nrows) {                               \
    pick_all<R>(h_top, h_bot, h_len, M, mh, khits, ihits, min_hitlen, rk,  \
                rows, nrows);                                              \
  }                                                                        \
  extern "C" int64_t twin_shard_search_##KIND(                             \
      const int64_t* desc, const void* reads, int64_t row_bytes,           \
      const void* lengths, const void* start, void* h_top, void* h_bot,    \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,        \
      int32_t mh, int32_t min_hitlen, int32_t increment,                   \
      int32_t first_hit_only) {                                            \
    return shard_search_all<R>(desc, reads, row_bytes, lengths, start,     \
                               h_top, h_bot, h_off, h_len, nhits, sums, L, \
                               mh, min_hitlen, increment, first_hit_only); \
  }                                                                        \
  extern "C" int64_t twin_shard_resolve_##KIND(                            \
      const int64_t* desc, const void* brows, const void* brefs,           \
      int64_t nb, int32_t offrate, int32_t narrow, int32_t max_steps,      \
      const void* rows, void* tidx, int64_t n) {                           \
    return shard_resolve_all<R>(desc, brows, brefs, nb, offrate, narrow,   \
                                max_steps, rows, tidx, n);                 \
  }

TWIN(narrow, int32_t)
TWIN(wide, int64_t)
