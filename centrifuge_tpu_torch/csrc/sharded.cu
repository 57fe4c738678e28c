// K6: the greedy FM search and the SA resolve walk over an index whose
// block rows, ftab entries and SA samples are split by range over n_fm
// shards. Four kernels, one thread per lane (or row) each:
//   search_partials   one launch per shard: the shard's owner-masked
//                     answers to each lane's query (ftab entry, or the
//                     ranks and BWT char of an extension step)
//   search_advance    one launch per step on the dp row's lead device:
//                     the partials summed over the shards, the rest of the
//                     lane's transition, its next query
//   resolve_partials  one launch per shard: the LF successor (from the
//                     block owner) and the sample (from the sample owner)
//   resolve_advance   one launch per step: the sums, the exits, the move
// The per-lane logic is fm_common.cuh (search_partials, search_advance,
// resolve_partials, resolve_advance); the host (parallel/sharded.py)
// drives the steps and reads the live count back every few steps.
//
// Replaces the JAX package's parallel/sharded.py _shard_kernels (the
// masked local gathers and the psum over the fm axis), _sharded_try_offset,
// make_sharded_search and make_sharded_resolver. On the TPU every lookup
// of a lockstep step is an owner-masked gather on each shard and a psum
// over the mesh's fm axis; here the sum over shards is the advance
// kernel's loop over the partials buffer [n_fm, L], which a shard on the
// lead's device writes directly and a shard on another device fills by a
// peer copy.
//
// Bound on an H100: the same table reads as K1 and K3 (each 32-byte
// sector of the block, ftab and sample tables that the lanes touch, once,
// over 3.35 TB/s, against the rank arithmetic at the card's integer and
// popcount rates); no collective on one card. The design pays a launch per
// shard and one per step, and a round trip of the lane state through
// device memory per step, for a kernel that is simple and right: it is
// launch-bound, not bound by the card's memory.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename R>
fm::Shard<R> make_shard(const void* blocks, const void* ftab_tb,
                        const void* offs, const void* fchr, int64_t zoff,
                        int64_t blk_base, int64_t nblk_per, int64_t ftab_base,
                        int64_t nftab_per, int64_t offs_base,
                        int64_t noffs_per, int32_t offrate) {
  fm::Shard<R> s;
  s.blocks = (const uint32_t*)blocks;
  s.ftab_tb = (const R*)ftab_tb;
  s.offs = (const int32_t*)offs;
  s.fchr = (const R*)fchr;
  s.zoff = (R)zoff;
  s.blk_base = blk_base;
  s.nblk_per = nblk_per;
  s.ftab_base = ftab_base;
  s.nftab_per = nftab_per;
  s.offs_base = offs_base;
  s.noffs_per = noffs_per;
  s.offrate = offrate;
  return s;
}

unsigned grid_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// one atomic add per block of the lanes (rows) left walking
__device__ void count_live(bool live, int32_t* counter) {
  const int n = __syncthreads_count(live);
  if (threadIdx.x == 0 && n > 0) atomicAdd(counter, n);
}

template <typename R>
__global__ void search_partials_kernel(fm::Shard<R> s, const R* qa,
                                       const R* qb, const int32_t* qk, R* p0,
                                       R* p1, int32_t* p2, int64_t L) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < L) fm::search_partials<R>(s, qa, qb, qk, p0, p1, p2, i);
}

template <typename R>
__global__ void search_advance_kernel(fm::ShardSearchArgs<R> a, int32_t first,
                                      int32_t* live) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < a.L && fm::search_advance<R>(a, i, first != 0);
  count_live(on, live);
}

template <typename R>
__global__ void resolve_partials_kernel(fm::Shard<R> s, const R* q, R* p0,
                                        int32_t* p1, int64_t N) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) fm::resolve_partials<R>(s, q, p0, p1, i);
}

template <typename R>
__global__ void resolve_advance_kernel(fm::ShardResolveArgs<R> a, int64_t step,
                                       int64_t budget, int32_t* live) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < a.N && fm::resolve_advance<R>(a, i, step, budget);
  count_live(on, live);
}

template <typename R>
int search_partials(const void* blocks, const void* ftab_tb, const void* fchr,
                    int64_t zoff, int64_t blk_base, int64_t nblk_per,
                    int64_t ftab_base, int64_t nftab_per, const void* qa,
                    const void* qb, const void* qk, void* p0, void* p1,
                    void* p2, int64_t L, void* stream) {
  const fm::Shard<R> s =
      make_shard<R>(blocks, ftab_tb, nullptr, fchr, zoff, blk_base, nblk_per,
                    ftab_base, nftab_per, 0, 0, 0);
  if (L > 0)
    search_partials_kernel<R><<<grid_of(L), kThreads, 0,
                                (cudaStream_t)stream>>>(
        s, (const R*)qa, (const R*)qb, (const int32_t*)qk, (R*)p0, (R*)p1,
        (int32_t*)p2, L);
  return (int)cudaGetLastError();
}

template <typename R>
int search_advance(const void* reads, int64_t row_bytes, const void* lengths,
                   const void* start, const void* fchr, int64_t zoff,
                   void* cur, void* dep, void* phase, void* top, void* bot,
                   void* qa, void* qb, void* qk, const void* p0,
                   const void* p1, const void* p2, int32_t n_fm, int64_t L,
                   void* h_top, void* h_bot, void* h_off, void* h_len,
                   void* nhits, void* sums, int32_t mh, int32_t min_hitlen,
                   int32_t increment, int32_t first_hit_only, int32_t first,
                   void* live, void* stream) {
  fm::ShardSearchArgs<R> a;
  a.reads = (const uint8_t*)reads;
  a.row_bytes = row_bytes;
  a.lengths = (const int32_t*)lengths;
  a.start = (const int32_t*)start;
  a.fchr = (const R*)fchr;
  a.zoff = (R)zoff;
  a.cur = (int32_t*)cur;
  a.dep = (int32_t*)dep;
  a.phase = (int32_t*)phase;
  a.top = (R*)top;
  a.bot = (R*)bot;
  a.qa = (R*)qa;
  a.qb = (R*)qb;
  a.qk = (int32_t*)qk;
  a.p0 = (const R*)p0;
  a.p1 = (const R*)p1;
  a.p2 = (const int32_t*)p2;
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
  if (L > 0)
    search_advance_kernel<R><<<grid_of(L), kThreads, 0,
                               (cudaStream_t)stream>>>(a, first,
                                                       (int32_t*)live);
  return (int)cudaGetLastError();
}

template <typename R>
int resolve_partials(const void* blocks, const void* offs, const void* fchr,
                     int64_t zoff, int64_t blk_base, int64_t nblk_per,
                     int64_t offs_base, int64_t noffs_per, int32_t offrate,
                     const void* q, void* p0, void* p1, int64_t N,
                     void* stream) {
  const fm::Shard<R> s =
      make_shard<R>(blocks, nullptr, offs, fchr, zoff, blk_base, nblk_per, 0,
                    0, offs_base, noffs_per, offrate);
  if (N > 0)
    resolve_partials_kernel<R><<<grid_of(N), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        s, (const R*)q, (R*)p0, (int32_t*)p1, N);
  return (int)cudaGetLastError();
}

template <typename R>
int resolve_advance(int64_t zoff, const void* brows, const void* brefs,
                    int64_t nb, int32_t offrate, int32_t narrow, void* q,
                    void* tidx, const void* p0, const void* p1, int32_t n_fm,
                    int64_t N, int64_t step, int64_t budget, void* live,
                    void* stream) {
  fm::ShardResolveArgs<R> a;
  a.zoff = (R)zoff;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.q = (R*)q;
  a.tidx = (int32_t*)tidx;
  a.p0 = (const R*)p0;
  a.p1 = (const int32_t*)p1;
  a.n_fm = n_fm;
  a.N = N;
  if (N > 0)
    resolve_advance_kernel<R><<<grid_of(N), kThreads, 0,
                                (cudaStream_t)stream>>>(a, step, budget,
                                                        (int32_t*)live);
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_SHARDED_ENTRIES(KIND, R)                                          \
  extern "C" int fm_shard_search_partials_##KIND(                            \
      const void* blocks, const void* ftab_tb, const void* fchr,             \
      int64_t zoff, int64_t blk_base, int64_t nblk_per, int64_t ftab_base,   \
      int64_t nftab_per, const void* qa, const void* qb, const void* qk,     \
      void* p0, void* p1, void* p2, int64_t L, void* stream) {               \
    return search_partials<R>(blocks, ftab_tb, fchr, zoff, blk_base,         \
                              nblk_per, ftab_base, nftab_per, qa, qb, qk,    \
                              p0, p1, p2, L, stream);                        \
  }                                                                          \
  extern "C" int fm_shard_search_advance_##KIND(                             \
      const void* reads, int64_t row_bytes, const void* lengths,             \
      const void* start, const void* fchr, int64_t zoff, void* cur,          \
      void* dep, void* phase, void* top, void* bot, void* qa, void* qb,      \
      void* qk, const void* p0, const void* p1, const void* p2,              \
      int32_t n_fm, int64_t L, void* h_top, void* h_bot, void* h_off,        \
      void* h_len, void* nhits, void* sums, int32_t mh, int32_t min_hitlen,  \
      int32_t increment, int32_t first_hit_only, int32_t first, void* live,  \
      void* stream) {                                                        \
    return search_advance<R>(reads, row_bytes, lengths, start, fchr, zoff,   \
                             cur, dep, phase, top, bot, qa, qb, qk, p0, p1,  \
                             p2, n_fm, L, h_top, h_bot, h_off, h_len, nhits, \
                             sums, mh, min_hitlen, increment,                \
                             first_hit_only, first, live, stream);           \
  }                                                                          \
  extern "C" int fm_shard_resolve_partials_##KIND(                           \
      const void* blocks, const void* offs, const void* fchr, int64_t zoff,  \
      int64_t blk_base, int64_t nblk_per, int64_t offs_base,                 \
      int64_t noffs_per, int32_t offrate, const void* q, void* p0, void* p1, \
      int64_t N, void* stream) {                                             \
    return resolve_partials<R>(blocks, offs, fchr, zoff, blk_base, nblk_per, \
                               offs_base, noffs_per, offrate, q, p0, p1, N,  \
                               stream);                                      \
  }                                                                          \
  extern "C" int fm_shard_resolve_advance_##KIND(                            \
      int64_t zoff, const void* brows, const void* brefs, int64_t nb,        \
      int32_t offrate, int32_t narrow, void* q, void* tidx, const void* p0,  \
      const void* p1, int32_t n_fm, int64_t N, int64_t step, int64_t budget, \
      void* live, void* stream) {                                            \
    return resolve_advance<R>(zoff, brows, brefs, nb, offrate, narrow, q,    \
                              tidx, p0, p1, n_fm, N, step, budget, live,     \
                              stream);                                       \
  }

FM_SHARDED_ENTRIES(narrow, int32_t)
FM_SHARDED_ENTRIES(wide, int64_t)
