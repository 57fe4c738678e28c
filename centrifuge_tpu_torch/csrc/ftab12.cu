// K4: the depth-12 ftab, level 2, written in place into its
// preallocated packed-row table.
//
// Replaces the JAX package's ops/fm_jax.py _ftab12_rows_graph (and the
// in-place _ufm_write_rows). The level-1 ranges t1/b1[i1] = LF(t0[e10],
// c10) / LF(b0[e10], c10), i1 = e10 | c10 << 20, come from one launch of
// the rank kernel (rank.cu) before this one, on the same stream. Here a
// tile of kTile threads takes one level-1 range (fm_common.cuh
// ftab12_range): it reads the block rows of the range's two ends once,
// in 16-byte chunks split over its threads, counts every code before
// each end in one scan, and writes the four entries i1 | c11 << 22 that
// extend the range, one c11 a thread. The four entries share their
// level-1 range, so a range's rows are scanned once, not once per c11:
// at most 2^23 row scans where one thread an entry made 2^25. Guards
// follow native/fmwalk.cpp fm_ftab_extend.
//
// A warp takes 32 consecutive ranges at a time from an int32 work
// counter (one atomic for the warp, not one a range), over a persistent
// grid (the resident blocks), and loads their ends at once; its tiles
// then scan neighbouring ranges each round, so the stores of each c11
// quarter coalesce. Consecutive i1 are neighbouring 11-mers (c10 is the
// most significant char, c0 the least), so their ranges lie side by
// side in the BWT and neighbouring tiles read the same or the next
// block rows: the sweep reads the block table in order. Columns 32-35
// (narrow) and 32-39 (wide) of each row are not written.
//
// Bound on an H100: the larger of the bytes (the level-1 pairs and the
// depth-10 pairs in, every entry out, each 32-byte sector of the block
// table that the scans touch once) over 3.35 TB/s and the arithmetic of
// one all-code scan per non-empty range end (chip_smoke.py counts both).
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

// Threads per level-1 range, chosen on the card (PERF.md §6,
// evaluation/tile_sweep.py, which builds this source at each size).
constexpr int kTile = 4;
constexpr int kThreads = 128;
constexpr int kPerWarp = 32 / kTile;  // ranges a warp scans at once

// A warp takes 32 consecutive level-1 ranges from the counter: lane l
// loads range l's ends (one coalesced load of each table, none waiting
// on another), then the warp's tiles scan the 32 in 32 / kPerWarp
// rounds, each tile's ends shuffled to it from the lane holding them.
template <typename R>
__global__ void __launch_bounds__(kThreads)
    ftab12_kernel(const fm::Ftab12Args<R> a, const R* __restrict__ fchr,
                  int32_t* __restrict__ next) {
  namespace cg = fm::cg;
  const auto block = cg::this_thread_block();
  const auto warp = cg::tiled_partition<32>(block);
  const fm::Tile<kTile> g{cg::tiled_partition<kTile>(block)};
  const int lane = (int)warp.thread_rank(), sub = lane / kTile;
  const fm::Fc4<R> fc{{fm::ldg(fchr), fm::ldg(fchr + 1), fm::ldg(fchr + 2),
                       fm::ldg(fchr + 3)}};
  for (;;) {
    int32_t v = 0;
    if (lane == 0) v = atomicAdd(next, 1);
    const int64_t base = (int64_t)warp.shfl(v, 0) * 32;
    if (base >= fm::kN1) break;
    R lt, lb;
    fm::level1_range<R>(a, base + lane, &lt, &lb);
    for (int r = 0; r < 32 / kPerWarp; ++r) {
      const int k = r * kPerWarp + sub;
      fm::ftab12_range<R>(a, fc, g, base + k, warp.shfl(lt, k),
                          warp.shfl(lb, k));
    }
  }
}

static_assert(fm::kN1 % 32 == 0, "the warp takes divide the ranges");

template <typename R>
int launch(const void* blocks, const void* fchr, int64_t zoff,
           const void* t0, const void* b0, const void* t1, const void* b1,
           void* out, void* next, void* stream) {
  fm::Ftab12Args<R> a;
  a.blocks = (const uint32_t*)blocks;
  a.zoff = (R)zoff;
  a.t0 = (const R*)t0;
  a.b0 = (const R*)b0;
  a.t1 = (const R*)t1;
  a.b1 = (const R*)b1;
  a.out = (uint32_t*)out;
  int grid = 0;
  const cudaError_t e = fm::persistent_grid<ftab12_kernel<R>>(
      kThreads, kTile, fm::kN1, &grid);
  if (e != cudaSuccess) return (int)e;
  ftab12_kernel<R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, (const R*)fchr, (int32_t*)next);
  return (int)cudaGetLastError();
}

// The launch shape: tile, threads a block, grid, registers a thread
// (ptxas's count), resident grid (n is fixed: the 2^22 ranges).
template <typename R>
int config(int32_t* out) {
  int grid = 0, resident = 0;
  cudaError_t e = fm::persistent_grid<ftab12_kernel<R>>(
      kThreads, kTile, fm::kN1, &grid, &resident);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ftab12_kernel<R>);
  if (e != cudaSuccess) return (int)e;
  out[0] = kTile;
  out[1] = kThreads;
  out[2] = grid;
  out[3] = attr.numRegs;
  out[4] = resident;
  return 0;
}

}  // namespace

#define FM_FTAB12_ENTRY(NAME, R)                                            \
  extern "C" int NAME(const void* blocks, const void* fchr, int64_t zoff,   \
                      const void* t0, const void* b0, const void* t1,       \
                      const void* b1, void* out, void* next,                \
                      void* stream) {                                       \
    return launch<R>(blocks, fchr, zoff, t0, b0, t1, b1, out, next,         \
                     stream);                                               \
  }

FM_FTAB12_ENTRY(fm_ftab12_narrow, int32_t)
FM_FTAB12_ENTRY(fm_ftab12_wide, int64_t)

extern "C" int fm_ftab12_config(int32_t wide, int64_t, int32_t* out) {
  return wide ? config<int64_t>(out) : config<int32_t>(out);
}
