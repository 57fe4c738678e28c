// K3: SA row -> sequence index. A tile of kTile threads walks one row's
// LF steps to its own exit ('$' row, sampled row or genome-boundary
// row); a persistent grid feeds the tiles rows from a work counter.
//
// Replaces the JAX package's ops/fm_jax.py resolve walk: _try_offset,
// _resolve_body, resolve_rows_core (through _resolve_rows and
// make_resolver) and resolve_rows_two_phase. The TPU version steps all
// rows in lockstep, 8 unrolled steps per while-loop iteration, so every
// row pays the longest walk of its batch; the two-phase variant compacts
// the survivors to cut that tail. Here each tile stops at its own exit
// (fm_common.cuh resolve_row over the one-device FlatTables reader and
// the Tile group; K6 walks the same loop over its shards, one thread a
// row), which gives the single-phase outputs, including the -1 of a row
// still unresolved after max_steps steps rounded up to a multiple of 8.
//
// Bound on an H100: bytes. Each LF step needs BWT[row] and the rank of
// that code in the same block row (occ checkpoint and the words before
// the row), at a data-dependent address; an exit reads one sample. The
// bound counts each 32-byte sector of the block and sample tables that
// the walk touches once, plus the rows in and the results out, over
// 3.35 TB/s (PERF.md §6). What held the one-thread-per-row design far
// from it: scalar 4-byte loads, each warp-wide load over 32 rows, a
// second read of the row for the code, and warps of 32 rows that ran to
// their longest walk (4.1 steps a row on average, far more for some).
// The design:
//   - a tile reads the row's words in 16-byte chunks (one or two a
//     thread, fixed trip count, a chunk past the row's base not read)
//     and one cg::reduce sums the counts of every code and brings the
//     code at the row, so a step is one read of its row; the occ
//     checkpoint is one 16-byte load (two wide), picked after;
//   - the grid is what stays resident (the occupancy query, once per
//     device), capped at what n rows fill, and a tile whose walk ends
//     takes the next row from an int32 counter that the wrapper zeroes.
//     Results go by row index, so they do not depend on the order.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

// Threads per row: 8, chosen on the card over 4 (PERF.md §6,
// evaluation/tile_sweep.py, which builds this source at each size).
constexpr int kTile = 8;
constexpr int kThreads = 128;

template <typename R>
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(const fm::FlatTables<R> t, const fm::ResolveArgs<R> a,
                   const R* __restrict__ rows, int32_t* __restrict__ tidx,
                   int64_t n, int32_t* __restrict__ next) {
  const fm::Tile<kTile> g{
      fm::cg::tiled_partition<kTile>(fm::cg::this_thread_block())};
  // A row's walk runs to its end before the tile takes the next: unlike
  // K1's lanes, a walk is one short chain of dependent row reads, and
  // the longest walk of the batch sets the kernel's time (PERF.md §6).
  for (int64_t i = g.take(next); i < n; i = g.take(next)) {
    const int32_t v = fm::resolve_row<R>(t, a, rows[i], g);
    if (g.leader()) tidx[i] = v;
  }
}

template <typename R>
int launch(const void* blocks, const void* fchr, int64_t zoff,
           const void* offs, int64_t noffs, const void* brows,
           const void* brefs, int64_t nb, int32_t offrate, int32_t narrow,
           int32_t max_steps, const void* rows, void* tidx, int64_t n,
           void* next, void* stream) {
  fm::FlatTables<R> t{};
  t.blocks = (const uint32_t*)blocks;
  t.fchr = (const R*)fchr;
  t.zoff = (R)zoff;
  t.offs = (const int32_t*)offs;
  t.noffs = noffs;
  fm::ResolveArgs<R> a;
  a.brows = (const R*)brows;
  a.brefs = (const int32_t*)brefs;
  a.nb = nb;
  a.offrate = offrate;
  a.narrow = narrow;
  a.max_steps = max_steps;
  if (n > 0) {
    int grid = 0;
    const cudaError_t e =
        fm::persistent_grid<resolve_kernel<R>>(kThreads, kTile, n, &grid);
    if (e != cudaSuccess) return (int)e;
    resolve_kernel<R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        t, a, (const R*)rows, (int32_t*)tidx, n, (int32_t*)next);
  }
  return (int)cudaGetLastError();
}

// The launch shape for n rows: tile, threads a block, grid, registers a
// thread (ptxas's count, from cudaFuncGetAttributes), resident grid.
template <typename R>
int config(int64_t n, int32_t* out) {
  int grid = 0, resident = 0;
  cudaError_t e = fm::persistent_grid<resolve_kernel<R>>(kThreads, kTile, n,
                                                         &grid, &resident);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, resolve_kernel<R>);
  if (e != cudaSuccess) return (int)e;
  out[0] = kTile;
  out[1] = kThreads;
  out[2] = grid;
  out[3] = attr.numRegs;
  out[4] = resident;
  return 0;
}

}  // namespace

#define FM_RESOLVE_ENTRY(NAME, R)                                           \
  extern "C" int NAME(const void* blocks, const void* fchr, int64_t zoff,   \
                      const void* offs, int64_t noffs, const void* brows,   \
                      const void* brefs, int64_t nb, int32_t offrate,       \
                      int32_t narrow, int32_t max_steps, const void* rows,  \
                      void* tidx, int64_t n, void* next, void* stream) {    \
    return launch<R>(blocks, fchr, zoff, offs, noffs, brows, brefs, nb,     \
                     offrate, narrow, max_steps, rows, tidx, n, next,       \
                     stream);                                               \
  }

FM_RESOLVE_ENTRY(fm_resolve_narrow, int32_t)
FM_RESOLVE_ENTRY(fm_resolve_wide, int64_t)

extern "C" int fm_resolve_config(int32_t wide, int64_t n, int32_t* out) {
  return wide ? config<int64_t>(n, out) : config<int32_t>(n, out);
}
