// Host build of fm_common.cuh, for the CPU tests only: the per-lane
// functions the CUDA kernels call, looped over the lanes on the host, so
// the kernels' arithmetic is checked against the plain PyTorch versions
// on a machine without a CUDA compiler. The port itself never loads it:
// on the CPU its wrappers run the plain versions.
//
// The rank, the search, the walk, the row scan, the level 1 and the
// depth-12 ftab run under fm::Serial<G>, the one-thread group that
// computes the G parts of every row scan in a loop and sums them: the
// part functions that a tile of G threads runs on the card (K0, K1, K3,
// K4), and at G = 1 K6's group.
// `group` selects G (1, 2, 4 or 8); an entry returns -1 for any other.
// The presolve runs its warp's 32 lanes as fm::Serial<32>.
//
//   g++ -std=c++17 -O2 -shared -fPIC cpu_twin.cpp -o cpu_twin.so
#include <stdint.h>

#include <vector>

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

// The group's row scan (K0's query, and K1's and K3's step): the rank of
// each (row, char) into out (char -1: of BWT[row]; plus fchr of the char
// when fchr is given) and BWT[row] into codes, and into pair_out, where
// every char is 0..3, the two ranks of each pair of queries (2m, 2m + 1),
// both of char 2m, from one pair scan.
template <typename R>
int64_t rank_all(const void* blocks, const void* fchr, int64_t zoff,
                 const void* rows, const void* chars, void* out, int64_t n,
                 int32_t group, void* codes, void* pair_out) {
  const R* rr = (const R*)rows;
  const int32_t* cc = (const int32_t*)chars;
  const R* fc = (const R*)fchr;
  R* o = (R*)out;
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

// K4's 2^22 level-1 ranges (fm_common.cuh level1_range, ftab12_range),
// run by the group of `group` parts.
template <typename R>
int64_t ftab12_all(const void* blocks, const void* fchr, int64_t zoff,
                   const void* t0, const void* b0, const void* t1,
                   const void* b1, void* out, int32_t group) {
  fm::Ftab12Args<R> a;
  a.blocks = (const uint32_t*)blocks;
  a.zoff = (R)zoff;
  a.t0 = (const R*)t0;
  a.b0 = (const R*)b0;
  a.t1 = (const R*)t1;
  a.b1 = (const R*)b1;
  a.out = (uint32_t*)out;
  const R* f = (const R*)fchr;
  const fm::Fc4<R> fc{{f[0], f[1], f[2], f[3]}};
  return with_group(group, [&](auto g) -> int64_t {
    for (int64_t i1 = 0; i1 < fm::kN1; ++i1) {
      R lt, lb;
      fm::level1_range<R>(a, i1, &lt, &lb);
      fm::ftab12_range<R>(a, fc, g, i1, lt, lb);
    }
    return 0;
  });
}

// K0's level 1 over n depth-10 ranges (fm_common.cuh scan_ends), run by
// the group of `group` parts: t1/b1[e + c * n] = LF(t0[e], c) /
// LF(b0[e], c), or 0 where the range is empty.
template <typename R>
int64_t level1_all(const void* blocks, const void* fchr, int64_t zoff,
                   const void* t0, const void* b0, void* t1, void* b1,
                   int64_t n, int32_t group) {
  const R* f = (const R*)fchr;
  const fm::Fc4<R> fc{{f[0], f[1], f[2], f[3]}};
  const R *pt = (const R*)t0, *pb = (const R*)b0;
  R *ot = (R*)t1, *ob = (R*)b1;
  return with_group(group, [&](auto g) -> int64_t {
    for (int64_t e = 0; e < n; ++e) {
      const fm::EndsLF<R> x =
          fm::scan_ends<R>((const uint32_t*)blocks, g, pt[e], pb[e]);
      for (int c = 0; c < 4; ++c) {
        ot[e + c * n] = x.top(fc, (R)zoff, c);
        ob[e + c * n] = x.bot(fc, (R)zoff, c);
      }
    }
    return 0;
  });
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

// K5 as its kernel runs it, with the warp emulated by fm::Serial<32>:
// each mate's rows laid into its rk staging slots and counted; per
// block of fm::kPickMates mates the exclusive scan of the counts, and
// the block's offset from the blocks before it; then each mate's rows
// copied to flat[offset ..] (slots past n dropped) and the slots from
// the grand total to n set to 0. The kernel's warps and blocks write in
// no fixed order, so here the mates are staged from the last to the
// first, and the tail is filled before the rows are copied, last mate
// first: a slot that two writes share shows. nrows, where given,
// receives each mate's count.
template <typename R>
void presolve_all(const void* h_top, const void* h_bot, const void* h_len,
                  int64_t M, int32_t mh, int32_t khits, int32_t ihits,
                  int32_t min_hitlen, int32_t rk, void* flat, int64_t n,
                  void* nrows) {
  fm::PickArgs<R> a;
  a.h_top = (const R*)h_top;
  a.h_bot = (const R*)h_bot;
  a.h_len = (const int32_t*)h_len;
  a.mh = mh;
  a.khits = khits;
  a.ihits = ihits;
  a.min_hitlen = min_hitlen;
  a.rk = rk;
  a.flat = (R*)flat;
  a.n = n;
  const fm::Serial<32> w;
  // each mate's rk slots, then slack for the most rows a mate's hits
  // could lay unclipped (2 mh hits of ihits rows)
  std::vector<R> stage(M * rk + 2 * (int64_t)mh * (ihits > 0 ? ihits : 0));
  std::vector<int32_t> cnt(M);
  std::vector<int64_t> doff(M);
  for (int64_t m = M - 1; m >= 0; --m)
    cnt[m] = fm::mate_rows<R>(a, w, m, stage.data() + m * rk);
  int64_t base = 0;
  for (int64_t m0 = 0; m0 < M; m0 += fm::kPickMates) {
    int32_t agg = 0;  // the block's scan
    for (int j = 0; j < fm::kPickMates && m0 + j < M; ++j) {
      doff[m0 + j] = base + agg;
      agg += cnt[m0 + j];
      if (nrows != nullptr) ((int32_t*)nrows)[m0 + j] = cnt[m0 + j];
    }
    base += agg;
  }
  fm::fill_tail<R>(a.flat, base, n, 0, 1);
  for (int64_t m = M - 1; m >= 0; --m)
    fm::lay_rows<R>(stage.data() + m * rk, cnt[m], doff[m], a.flat, n, 0, 1);
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
  extern "C" int64_t twin_level1_##KIND(                                   \
      const void* blocks, const void* fchr, int64_t zoff, const void* t0,  \
      const void* b0, void* t1, void* b1, int64_t n, int32_t group) {      \
    return level1_all<R>(blocks, fchr, zoff, t0, b0, t1, b1, n, group);   \
  }                                                                        \
  extern "C" int64_t twin_ftab12_##KIND(                                   \
      const void* blocks, const void* fchr, int64_t zoff, const void* t0,  \
      const void* b0, const void* t1, const void* b1, void* out,           \
      int32_t group) {                                                     \
    return ftab12_all<R>(blocks, fchr, zoff, t0, b0, t1, b1, out, group); \
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
  extern "C" void twin_presolve_##KIND(                                    \
      const void* h_top, const void* h_bot, const void* h_len, int64_t M,  \
      int32_t mh, int32_t khits, int32_t ihits, int32_t min_hitlen,        \
      int32_t rk, void* flat, int64_t n, void* nrows) {                    \
    presolve_all<R>(h_top, h_bot, h_len, M, mh, khits, ihits, min_hitlen, \
                    rk, flat, n, nrows);                                   \
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
