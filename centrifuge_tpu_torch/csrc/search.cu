// K1: the greedy FM partial-hit search, one thread per (read, strand)
// lane, each lane run to its end with no lockstep.
//
// Replaces the JAX package's classify/engine.py search_loop (entered at
// batched_search_packed) and its step ops/fm_jax.py fused_step_lookup1.
// The TPU version steps every lane in lockstep inside a lax.while_loop,
// with one-row deferral, survivor compaction and masked-sum selects, all
// of which exist for the TPU's lack of a scalar gather; here each thread
// follows its own lane (fm_common.cuh search_lane over the one-device
// FlatTables reader; K6 runs the same loop over its shards) and the
// outputs are the same.
//
// Bound on an H100: every extension step ranks one (one-row range) or
// two (top and bot) rows, each needing its occ checkpoint and part of
// one block's words, at data-dependent addresses. The bound counts each
// 32-byte sector of the block and ftab tables the lanes touch once (at
// most the 72 MB block table at 256 Mbp), plus the reads in and the hit
// buffers out, over 3.35 TB/s, against the rank arithmetic at the
// card's integer and popcount rates. In practice the chain of
// dependent row reads per lane makes it latency-bound; the design keeps
// enough lanes in flight (65,536 per batch, 128 threads per block) for
// the card to overlap them. Lanes diverge (each stops when its own read
// ends); the simple kernel accepts that.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

template <typename R>
__global__ void search_kernel(fm::FlatTables<R> t, fm::SearchArgs<R> a,
                              int64_t L) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  fm::search_lane<R>(t, a, lane);
}

template <typename R>
int launch(const void* blocks, const void* fchr, int64_t zoff,
           const void* ftab, const void* ftab12, const void* reads,
           int64_t row_bytes, const void* lengths, const void* start,
           void* h_top, void* h_bot, void* h_off, void* h_len, void* nhits,
           void* sums, int64_t L, int32_t mh, int32_t min_hitlen,
           int32_t increment, int32_t first_hit_only, int32_t deep,
           void* stream) {
  fm::FlatTables<R> t{};
  t.blocks = (const uint32_t*)blocks;
  t.fchr = (const R*)fchr;
  t.zoff = (R)zoff;
  t.ftab = (const uint32_t*)ftab;
  t.ftab12 = deep ? (const uint32_t*)ftab12 : nullptr;
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
  if (L > 0) {
    const int threads = 128;
    const int64_t grid = (L + threads - 1) / threads;
    search_kernel<R><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        t, a, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_SEARCH_ENTRY(NAME, R)                                           \
  extern "C" int NAME(                                                     \
      const void* blocks, const void* fchr, int64_t zoff, const void* ftab, \
      const void* ftab12, const void* reads, int64_t row_bytes,            \
      const void* lengths, const void* start, void* h_top, void* h_bot,    \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,        \
      int32_t mh, int32_t min_hitlen, int32_t increment,                   \
      int32_t first_hit_only, int32_t deep, void* stream) {                \
    return launch<R>(blocks, fchr, zoff, ftab, ftab12, reads, row_bytes,   \
                     lengths, start, h_top, h_bot, h_off, h_len, nhits,    \
                     sums, L, mh, min_hitlen, increment, first_hit_only,   \
                     deep, stream);                                        \
  }

FM_SEARCH_ENTRY(fm_search_narrow, int32_t)
FM_SEARCH_ENTRY(fm_search_wide, int64_t)
