// Host build of fm_common.cuh, for the CPU tests only: the per-lane
// functions the CUDA kernels call, looped over the lanes on the host, so
// the kernels' arithmetic is checked against the plain PyTorch versions
// on a machine without a CUDA compiler. The port itself never loads it:
// on the CPU its wrappers run the plain versions.
//
//   g++ -std=c++17 -O2 -shared -fPIC cpu_twin.cpp -o cpu_twin.so
#include <stdint.h>

#include <vector>

#include "fm_common.cuh"

namespace {

template <typename R>
void rank_all(const void* blocks, const void* fchr, int64_t zoff,
              const void* rows, const void* chars, void* out, int64_t n) {
  const R* rr = (const R*)rows;
  const int32_t* cc = (const int32_t*)chars;
  const R* fc = (const R*)fchr;
  R* o = (R*)out;
  for (int64_t i = 0; i < n; ++i) {
    R r = fm::rank<R>((const uint32_t*)blocks, (R)zoff, rr[i], cc[i]);
    o[i] = fc != nullptr ? fc[cc[i]] + r : r;
  }
}

template <typename R>
void search_all(const void* blocks, const void* fchr, int64_t zoff,
                const void* ftab, const void* ftab12, const void* reads,
                int64_t row_bytes, const void* lengths, const void* start,
                void* h_top, void* h_bot, void* h_off, void* h_len,
                void* nhits, void* sums, int64_t L, int32_t mh,
                int32_t min_hitlen, int32_t increment,
                int32_t first_hit_only, int32_t deep) {
  fm::SearchArgs<R> a;
  a.blocks = (const uint32_t*)blocks;
  a.fchr = (const R*)fchr;
  a.zoff = (R)zoff;
  a.ftab = (const uint32_t*)ftab;
  a.ftab12 = (const uint32_t*)ftab12;
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
  a.deep = deep && ftab12 != nullptr;
  for (int64_t lane = 0; lane < L; ++lane) fm::search_lane<R>(a, lane);
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

template <typename R>
void resolve_all(const void* blocks, const void* fchr, int64_t zoff,
                 const void* offs, int64_t noffs, const void* brows,
                 const void* brefs, int64_t nb, int32_t offrate,
                 int32_t narrow, int32_t max_steps, int32_t walk,
                 const void* rows, void* tidx, int64_t n) {
  fm::ResolveArgs<R> a;
  a.blocks = (const uint32_t*)blocks;
  a.fchr = (const R*)fchr;
  a.zoff = (R)zoff;
  a.offs = (const int32_t*)offs;
  a.noffs = noffs;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.max_steps = max_steps;
  const R* rr = (const R*)rows;
  int32_t* o = (int32_t*)tidx;
  for (int64_t i = 0; i < n; ++i)
    o[i] = walk ? fm::resolve_row<R>(a, rr[i]) : fm::try_offset<R>(a, rr[i]);
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

// K6 as csrc/sharded.cu drives it, with the n_fm shards as the slices of
// one fm-padded table: the first advance, then per step each shard's
// partials and the advance, until no lane is left. Returns the steps.
template <typename R>
int64_t shard_search_all(const void* blocks, const void* ftab_tb,
                         const void* fchr, int64_t zoff, int64_t nblk_per,
                         int64_t nftab_per, int32_t n_fm, const void* reads,
                         int64_t row_bytes, const void* lengths,
                         const void* start, void* h_top, void* h_bot,
                         void* h_off, void* h_len, void* nhits, void* sums,
                         int64_t L, int32_t mh, int32_t min_hitlen,
                         int32_t increment, int32_t first_hit_only) {
  std::vector<int32_t> cur(L), dep(L), phase(L), qk(L);
  std::vector<R> top(L), bot(L), qa(L), qb(L);
  std::vector<R> p0(n_fm * L), p1(n_fm * L);
  std::vector<int32_t> p2(n_fm * L);
  fm::ShardSearchArgs<R> a;
  a.reads = (const uint8_t*)reads;
  a.row_bytes = row_bytes;
  a.lengths = (const int32_t*)lengths;
  a.start = (const int32_t*)start;
  a.fchr = (const R*)fchr;
  a.zoff = (R)zoff;
  a.cur = cur.data();
  a.dep = dep.data();
  a.phase = phase.data();
  a.top = top.data();
  a.bot = bot.data();
  a.qa = qa.data();
  a.qb = qb.data();
  a.qk = qk.data();
  a.p0 = p0.data();
  a.p1 = p1.data();
  a.p2 = p2.data();
  a.n_fm = n_fm;
  a.L = L;
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
  int64_t live = 0, steps = 0;
  for (int64_t i = 0; i < L; ++i) live += fm::search_advance<R>(a, i, true);
  while (live > 0) {
    for (int32_t f = 0; f < n_fm; ++f) {
      fm::Shard<R> s{};
      s.blocks = (const uint32_t*)blocks + f * nblk_per * fm::Geo<R>::kWidth;
      s.ftab_tb = (const R*)ftab_tb + 2 * f * nftab_per;
      s.fchr = (const R*)fchr;
      s.zoff = (R)zoff;
      s.blk_base = f * nblk_per;
      s.nblk_per = nblk_per;
      s.ftab_base = f * nftab_per;
      s.nftab_per = nftab_per;
      for (int64_t i = 0; i < L; ++i)
        fm::search_partials<R>(s, qa.data(), qb.data(), qk.data(),
                               p0.data() + f * L, p1.data() + f * L,
                               p2.data() + f * L, i);
    }
    live = 0;
    for (int64_t i = 0; i < L; ++i) live += fm::search_advance<R>(a, i, false);
    ++steps;
  }
  return steps;
}

template <typename R>
int64_t shard_resolve_all(const void* blocks, const void* offs,
                          const void* fchr, int64_t zoff, int64_t nblk_per,
                          int64_t noffs_per, int32_t n_fm, int32_t offrate,
                          const void* brows, const void* brefs, int64_t nb,
                          int32_t narrow, int64_t budget, const void* rows,
                          void* tidx, int64_t N) {
  std::vector<R> q((const R*)rows, (const R*)rows + N), p0(n_fm * N);
  std::vector<int32_t> p1(n_fm * N);
  fm::ShardResolveArgs<R> a;
  a.zoff = (R)zoff;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.q = q.data();
  a.tidx = (int32_t*)tidx;
  a.p0 = p0.data();
  a.p1 = p1.data();
  a.n_fm = n_fm;
  a.N = N;
  int64_t step = 0;
  for (int64_t live = N; live > 0 && step <= budget; ++step) {
    for (int32_t f = 0; f < n_fm; ++f) {
      fm::Shard<R> s{};
      s.blocks = (const uint32_t*)blocks + f * nblk_per * fm::Geo<R>::kWidth;
      s.offs = (const int32_t*)offs + f * noffs_per;
      s.fchr = (const R*)fchr;
      s.zoff = (R)zoff;
      s.blk_base = f * nblk_per;
      s.nblk_per = nblk_per;
      s.offs_base = f * noffs_per;
      s.noffs_per = noffs_per;
      s.offrate = offrate;
      for (int64_t i = 0; i < N; ++i)
        fm::resolve_partials<R>(s, q.data(), p0.data() + f * N,
                                p1.data() + f * N, i);
    }
    live = 0;
    for (int64_t i = 0; i < N; ++i)
      live += fm::resolve_advance<R>(a, i, step, budget);
  }
  return step;
}

}  // namespace

#define TWIN(KIND, R)                                                      \
  extern "C" void twin_rank_##KIND(const void* blocks, const void* fchr,   \
                                   int64_t zoff, const void* rows,         \
                                   const void* chars, void* out,           \
                                   int64_t n) {                            \
    rank_all<R>(blocks, fchr, zoff, rows, chars, out, n);                  \
  }                                                                        \
  extern "C" void twin_search_##KIND(                                      \
      const void* blocks, const void* fchr, int64_t zoff, const void* ftab, \
      const void* ftab12, const void* reads, int64_t row_bytes,            \
      const void* lengths, const void* start, void* h_top, void* h_bot,    \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,        \
      int32_t mh, int32_t min_hitlen, int32_t increment,                   \
      int32_t first_hit_only, int32_t deep) {                              \
    search_all<R>(blocks, fchr, zoff, ftab, ftab12, reads, row_bytes,      \
                  lengths, start, h_top, h_bot, h_off, h_len, nhits, sums, \
                  L, mh, min_hitlen, increment, first_hit_only, deep);     \
  }                                                                        \
  extern "C" void twin_ftab12_##KIND(                                      \
      const void* blocks, const void* fchr, int64_t zoff, const void* t0,  \
      const void* b0, const void* t1, const void* b1, void* out) {         \
    ftab12_all<R>(blocks, fchr, zoff, t0, b0, t1, b1, out);                \
  }                                                                        \
  /* walk = 0: try_offset only; walk = 1: resolve_row */                   \
  extern "C" void twin_resolve_##KIND(                                     \
      const void* blocks, const void* fchr, int64_t zoff, const void* offs, \
      int64_t noffs, const void* brows, const void* brefs, int64_t nb,     \
      int32_t offrate, int32_t narrow, int32_t max_steps, int32_t walk,    \
      const void* rows, void* tidx, int64_t n) {                           \
    resolve_all<R>(blocks, fchr, zoff, offs, noffs, brows, brefs, nb,      \
                   offrate, narrow, max_steps, walk, rows, tidx, n);       \
  }                                                                        \
  extern "C" void twin_pick_##KIND(                                        \
      const void* h_top, const void* h_bot, const void* h_len, int64_t M,  \
      int32_t mh, int32_t khits, int32_t ihits, int32_t min_hitlen,        \
      int32_t rk, void* rows, void* nrows) {                               \
    pick_all<R>(h_top, h_bot, h_len, M, mh, khits, ihits, min_hitlen, rk,  \
                rows, nrows);                                              \
  }                                                                        \
  extern "C" int64_t twin_shard_search_##KIND(                             \
      const void* blocks, const void* ftab_tb, const void* fchr,           \
      int64_t zoff, int64_t nblk_per, int64_t nftab_per, int32_t n_fm,     \
      const void* reads, int64_t row_bytes, const void* lengths,           \
      const void* start, void* h_top, void* h_bot, void* h_off,            \
      void* h_len, void* nhits, void* sums, int64_t L, int32_t mh,         \
      int32_t min_hitlen, int32_t increment, int32_t first_hit_only) {     \
    return shard_search_all<R>(blocks, ftab_tb, fchr, zoff, nblk_per,      \
                               nftab_per, n_fm, reads, row_bytes, lengths, \
                               start, h_top, h_bot, h_off, h_len, nhits,   \
                               sums, L, mh, min_hitlen, increment,         \
                               first_hit_only);                            \
  }                                                                        \
  extern "C" int64_t twin_shard_resolve_##KIND(                            \
      const void* blocks, const void* offs, const void* fchr, int64_t zoff, \
      int64_t nblk_per, int64_t noffs_per, int32_t n_fm, int32_t offrate,  \
      const void* brows, const void* brefs, int64_t nb, int32_t narrow,    \
      int64_t budget, const void* rows, void* tidx, int64_t N) {           \
    return shard_resolve_all<R>(blocks, offs, fchr, zoff, nblk_per,        \
                                noffs_per, n_fm, offrate, brows, brefs, nb, \
                                narrow, budget, rows, tidx, N);            \
  }

TWIN(narrow, int32_t)
TWIN(wide, int64_t)
