// K1: the greedy FM partial-hit search. A tile of kTile threads runs one
// (read, strand) lane to its end; a persistent grid feeds the tiles
// lanes from a work counter.
//
// Replaces the JAX package's classify/engine.py search_loop (entered at
// batched_search_packed) and its step ops/fm_jax.py fused_step_lookup1.
// The TPU version steps every lane in lockstep inside a lax.while_loop,
// with one-row deferral, survivor compaction and masked-sum selects, all
// of which exist for the TPU's lack of a scalar gather; here each tile
// follows its own lane (fm_common.cuh search_lane over the one-device
// FlatTables reader and the Tile group; K6 runs the same loop over its
// shards, one thread a lane) and the outputs are the same.
//
// Bound on an H100: bytes. Every extension step ranks one (one-row
// range) or two (top and bot) block rows at data-dependent addresses,
// each needing the row's occ checkpoint and the words before the rank.
// The bound counts each 32-byte sector of the block and ftab tables that
// the lanes touch once (at most the 72 MB block table at 256 Mbp), plus
// the reads in and the hit buffers out, over 3.35 TB/s (PERF.md §6). What
// held the one-thread-per-lane design far from it: every thread of a
// warp ranked in a different row with one 4-byte load per word, so each
// warp-wide load touched 32 rows for 4 useful bytes each, and a warp ran
// until its longest lane ended. The design:
//   - a tile reads a row's words in 16-byte chunks, each thread one or
//     two, in a loop of fixed trip count (a chunk past the rank is not
//     read), and sums its parts with cg::reduce; the occ checkpoint is
//     one 16-byte load (two wide);
//   - a two-row step issues both rows' loads before it reduces either,
//     and a one-row step takes BWT[top] and the rank from one read;
//   - the grid is what stays resident (the occupancy query, once per
//     device), capped at what L lanes fill, and a tile whose lane ends
//     takes the next from an int32 counter that the wrapper zeroes.
//     The kernel's one loop makes one table read a turn (search_step),
//     so a tile whose lane ends takes its next lane in the same turn:
//     the tiles of a warp reconverge every turn instead of waiting at an
//     extension loop's exit for the warp's longest extension. Results go
//     by lane index, so they do not depend on the order.
// Pool mode (fm_search_pool, narrow rows): the copy back to the host is
// the link's time, and most lanes fill fewer than half of their hit
// slots, so each tile stages its lane's hits in shared memory and, when
// the lane ends, reserves their records in one dense pool with one
// atomicAdd (the pool counter sits beside the work counter, in the array
// the wrapper zeroes) and writes them there; the host copies back a
// budget of the pool and each lane's base and counts (classify/engine.py).
// The stage's address is worked out at each use (Tile::stage), not kept
// in the lane's state: so the kernel keeps to 64 registers a thread and 8
// blocks a multiprocessor, where a kept pointer took it to 67 and 7 and
// cost the 65,536-lane launches 1-2% (PERF.md §6).
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

// Threads per lane: 4, chosen on the card over 8 (PERF.md §6,
// evaluation/tile_sweep.py, which builds this source at each size).
constexpr int kTile = 4;
constexpr int kThreads = 128;

template <typename R>
__global__ void __launch_bounds__(kThreads)
    search_kernel(const fm::FlatTables<R> t, const fm::SearchArgs<R> a,
                  int64_t L, int32_t* __restrict__ next) {
  const fm::Tile<kTile> g{
      fm::cg::tiled_partition<kTile>(fm::cg::this_thread_block())};
  const fm::Fc4<R> fc = fm::load_fc<R>(t);
  fm::SearchLane<R> s;
  bool live = false;
  for (;;) {  // one table read a turn: a lane that ends is replaced at once
    if (live) {
      live = fm::search_step<R>(t, a, fc, g, s);
    } else {
      const int64_t lane = g.take(next);
      if (lane >= L) break;
      live = fm::search_begin<R>(a, lane, g, &s);
    }
  }
}

// pool: null (padded mode), or the pool buffer of int32 words: `budget`
// records, base [L], tail [L], then the records from `budget` on (room
// for L mh records in all). next: the zeroed work counter, and in pool
// mode the pool counter after it.
template <typename R>
int launch(const void* blocks, const void* fchr, int64_t zoff,
           const void* ftab, const void* ftab12, const void* reads,
           int64_t row_bytes, const void* lengths, const void* start,
           void* h_top, void* h_bot, void* h_off, void* h_len, void* nhits,
           void* sums, int64_t L, int32_t mh, int32_t min_hitlen,
           int32_t increment, int32_t first_hit_only, int32_t deep,
           void* next, void* stream, void* pool = nullptr,
           int64_t budget = 0) {
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
  size_t smem = 0;
  if (pool != nullptr) {
    a.pool = (int32_t*)pool;
    a.budget = budget;
    a.base = a.pool + 3 * budget;
    a.tail = a.base + L;
    a.spill = a.tail + L;
    a.pool_next = (int32_t*)next + 1;
    // each tile's stage (Tile::stage), none in padded mode
    smem = sizeof(int32_t) * fm::stage_words(mh) * (kThreads / kTile);
  }
  if (L > 0) {
    int grid = 0;
    const cudaError_t e =
        fm::persistent_grid<search_kernel<R>>(kThreads, kTile, L, &grid);
    if (e != cudaSuccess) return (int)e;
    search_kernel<R><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        t, a, L, (int32_t*)next);
  }
  return (int)cudaGetLastError();
}

// The launch shape for L lanes: tile, threads a block, grid, registers
// a thread (ptxas's count, from cudaFuncGetAttributes), resident grid.
template <typename R>
int config(int64_t L, int32_t* out) {
  int grid = 0, resident = 0;
  cudaError_t e = fm::persistent_grid<search_kernel<R>>(kThreads, kTile, L,
                                                        &grid, &resident);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, search_kernel<R>);
  if (e != cudaSuccess) return (int)e;
  out[0] = kTile;
  out[1] = kThreads;
  out[2] = grid;
  out[3] = attr.numRegs;
  out[4] = resident;
  return 0;
}

}  // namespace

#define FM_SEARCH_ENTRY(NAME, R)                                           \
  extern "C" int NAME(                                                     \
      const void* blocks, const void* fchr, int64_t zoff, const void* ftab, \
      const void* ftab12, const void* reads, int64_t row_bytes,            \
      const void* lengths, const void* start, void* h_top, void* h_bot,    \
      void* h_off, void* h_len, void* nhits, void* sums, int64_t L,        \
      int32_t mh, int32_t min_hitlen, int32_t increment,                   \
      int32_t first_hit_only, int32_t deep, void* next, void* stream) {    \
    return launch<R>(blocks, fchr, zoff, ftab, ftab12, reads, row_bytes,   \
                     lengths, start, h_top, h_bot, h_off, h_len, nhits,    \
                     sums, L, mh, min_hitlen, increment, first_hit_only,   \
                     deep, next, stream);                                  \
  }

FM_SEARCH_ENTRY(fm_search_narrow, int32_t)
FM_SEARCH_ENTRY(fm_search_wide, int64_t)

// Pool mode, narrow rows only (launch's pool and budget).
extern "C" int fm_search_pool(const void* blocks, const void* fchr,
                              int64_t zoff, const void* ftab,
                              const void* ftab12, const void* reads,
                              int64_t row_bytes, const void* lengths,
                              const void* start, void* pool, int64_t budget,
                              int64_t L, int32_t mh, int32_t min_hitlen,
                              int32_t increment, int32_t deep, void* next,
                              void* stream) {
  return launch<int32_t>(blocks, fchr, zoff, ftab, ftab12, reads, row_bytes,
                         lengths, start, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, L, mh, min_hitlen, increment, 0,
                         deep, next, stream, pool, budget);
}

extern "C" int fm_search_config(int32_t wide, int64_t L, int32_t* out) {
  return wide ? config<int64_t>(L, out) : config<int32_t>(L, out);
}
