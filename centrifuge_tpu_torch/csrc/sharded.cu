// K6: the greedy FM search and the SA resolve walk over an index whose
// block rows, ftab entries and SA samples are split by range over n_fm
// shards. Two kernels, one launch per dp row of the mesh each, on the
// row's lead device; one thread runs one lane (or row) to its own end
// (the one-thread group fm::Serial<1>, which scans a row's 8 chunks of
// 16 bytes itself; K1 and K3 run the same loops with a tile a lane):
//   search   fm_common.cuh search_lane over the row's ShardSet (K1's
//            loop without the depth-12 prime)
//   resolve  fm_common.cuh resolve_row over the row's ShardSet (K3's loop
//            with the sharded exits and a 4-step budget granularity)
// Every table read goes to the shard that owns its key (key / per-shard
// count, bounds-checked; a key no shard owns reads 0), in registers: the
// shards' pointers and bases are one kernel parameter, built once per
// dp row when the mesh index is placed (parallel/sharded.py). A shard on
// another card is read through its peer mapping over NVLink, enabled once
// at that build (fm_shard_enable_peer).
//
// Replaces the JAX package's parallel/sharded.py _shard_kernels (the
// masked local gathers and the psum over the fm axis), _sharded_try_offset,
// make_sharded_search and make_sharded_resolver. On the TPU every lookup
// of a lockstep step is an owner-masked gather on each shard and a psum
// over the mesh's fm axis. The ranges are disjoint, so that sum is the
// owner's value, or 0 where no shard owns the key: one read of the owner
// gives it, and each lane walks on without waiting for the others.
//
// Bound on an H100: the same table reads as K1 and K3 (each 32-byte
// sector of the block, ftab and sample tables that the lanes touch, once,
// over 3.35 TB/s, against the rank arithmetic at the card's integer and
// popcount rates); no collective on one card. Each lane is a chain of
// dependent row reads, so the kernels are latency-bound like K1 and K3;
// 128-thread blocks keep every lane of a batch resident (65,536 lanes are
// 512 blocks on 132 SMs) for the card to overlap the chains.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

constexpr int kThreads = 128;

unsigned grid_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename R>
__global__ void search_kernel(const __grid_constant__ fm::ShardSet<R> s,
                              const fm::SearchArgs<R> a, int64_t L) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L) fm::search_lane<R>(s, a, lane, fm::Serial<1>{});
}

template <typename R>
__global__ void resolve_kernel(const __grid_constant__ fm::ShardSet<R> s,
                               const fm::ResolveArgs<R> a,
                               const R* __restrict__ rows,
                               int32_t* __restrict__ tidx, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    tidx[i] = fm::resolve_row<R>(s, a, rows[i], fm::Serial<1>{});
}

template <typename R>
int search(const int64_t* desc, const void* reads, int64_t row_bytes,
           const void* lengths, const void* start, void* h_top, void* h_bot,
           void* h_off, void* h_len, void* nhits, void* sums, int64_t L,
           int32_t mh, int32_t min_hitlen, int32_t increment,
           int32_t first_hit_only, void* stream) {
  fm::ShardSet<R> s;
  if (!fm::shard_set<R>(desc, &s)) return (int)cudaErrorInvalidValue;
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
  if (L > 0)
    search_kernel<R><<<grid_of(L), kThreads, 0, (cudaStream_t)stream>>>(s, a,
                                                                         L);
  return (int)cudaGetLastError();
}

template <typename R>
int resolve(const int64_t* desc, const void* brows, const void* brefs,
            int64_t nb, int32_t offrate, int32_t narrow, int32_t max_steps,
            const void* rows, void* tidx, int64_t n, void* stream) {
  fm::ShardSet<R> s;
  if (!fm::shard_set<R>(desc, &s)) return (int)cudaErrorInvalidValue;
  fm::ResolveArgs<R> a;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.max_steps = max_steps;
  if (n > 0)
    resolve_kernel<R><<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
        s, a, (const R*)rows, (int32_t*)tidx, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_SHARDED_ENTRIES(KIND, R)                                          \
  extern "C" int fm_shard_search_##KIND(                                     \
      const int64_t* desc, const void* reads, int64_t row_bytes,             \
      const void* lengths, const void* start, void* h_top, void* h_bot,      \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,          \
      int32_t mh, int32_t min_hitlen, int32_t increment,                     \
      int32_t first_hit_only, void* stream) {                                \
    return search<R>(desc, reads, row_bytes, lengths, start, h_top, h_bot,   \
                     h_off, h_len, nhits, sums, L, mh, min_hitlen,           \
                     increment, first_hit_only, stream);                     \
  }                                                                          \
  extern "C" int fm_shard_resolve_##KIND(                                    \
      const int64_t* desc, const void* brows, const void* brefs, int64_t nb, \
      int32_t offrate, int32_t narrow, int32_t max_steps, const void* rows,  \
      void* tidx, int64_t n, void* stream) {                                 \
    return resolve<R>(desc, brows, brefs, nb, offrate, narrow, max_steps,    \
                      rows, tidx, n, stream);                                \
  }

FM_SHARDED_ENTRIES(narrow, int32_t)
FM_SHARDED_ENTRIES(wide, int64_t)

// Let kernels on card `lead` read card `peer`'s memory (a shard there):
// once per pair, at the mesh index's build. Access already enabled is
// success; the calling thread's current card is restored.
extern "C" int fm_shard_enable_peer(int32_t lead, int32_t peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(lead);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}
