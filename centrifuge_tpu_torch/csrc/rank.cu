// K0: batched rank_c(row) / LF(row, c) over the packed BWT blocks, and
// the depth-12 ftab's level 1 (LF of both ends of every depth-10 range
// for every code).
//
// Replaces the JAX package's Pallas kernel ops/pallas_rank.py:91
// (pallas_rank / _rank_kernel_body, with rank_with_pallas' '$'
// subtraction) and its XLA twins ops/fm_jax.py:516,526 rank_kernel /
// lf_kernel, narrow and wide layouts; the level-1 entry computes what
// _ftab12_rows_graph's level 1 (ops/fm_jax.py:474-481) asks of
// lf_kernel, under the same empty-parent guard.
//
// Bound on an H100: bytes. A query needs its occ checkpoint and the
// words of its block row before the rank (half of the 128 B on
// average) at a data-dependent address, plus its own input and output;
// the bound counts each 32-byte sector touched once over 3.35 TB/s. The
// level 1 needs the depth-10 pairs in, the level-1 pairs out and each
// sector of the block rows at the ranges' ends once (about 115 MB at
// 256 Mbp: the 75 MB table, which is past the 50 MB L2, read about
// once). The arithmetic (one masked count per 16-byte chunk) comes
// nowhere near the card's integer rates before the bytes.
//
// What held the one-thread-per-query design: each thread counted its
// row in a loop of 4-byte loads whose trip count (0-31) differed from
// lane to lane, so a warp waited for its longest lane and each warp-wide
// load touched 32 rows for 4 useful bytes each; and the level 1 asked
// each depth-10 end four times (once per code), the four 2^20 queries
// apart, so each row came back from device memory four times, after the
// glue had written 67 MB of query rows and chars. The design:
//   - a tile of kTile threads (one, from the sweep) ranks one query
//     through K1's row scan (fm_common.cuh scan_rank): the row's words in
//     16-byte chunks, each thread one or more, in a loop of fixed trip
//     count (a chunk past the rank is not read), the occ checkpoint in
//     one 16-byte load, the '$' correction once;
//   - the level-1 entry gives a tile of kTileL1 threads one depth-10
//     range: both ends' rows read once with every code counted in one
//     scan (scan_ends, K4's scan one level down), and the eight values
//     written straight into t1/b1[e + c * n], with no query tensors;
//   - a warp loads 32 consecutive items with one coalesced load, runs
//     them in rounds on its tiles, shuffles each result back to the
//     lane of its item and stores them with one coalesced store;
//   - the grid is what stays resident (the occupancy query, once per
//     device), capped at what n items fill, and each warp strides over
//     the chunks of 32 items: an item's work is bounded (at most 8
//     chunks of a row, all loaded at once), so a work counter would buy
//     little balance for a zeroed counter a launch and an atomic a
//     chunk.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

// Threads per query (kTile) and per depth-10 range (kTileL1), chosen on
// the card from 1, 2, 4 and 8 (PERF.md §6, evaluation/tile_sweep.py,
// which builds this source at each size): one thread a query, whose
// chunk loads issue together, was fastest on random and on sorted
// queries; a range's two rows took two to four.
constexpr int kTile = 1;
constexpr int kTileL1 = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// A warp's 32 consecutive items, lane l loading item l, run by its
// tiles of G threads in G rounds of 32 / G: in round k tile s runs item
// k * (32 / G) + s, and lane l takes item l's results from the first
// thread of the tile that ran it.
template <int G>
struct Rounds {
  static constexpr int kPer = 32 / G;
  int lane;
  __device__ __forceinline__ int item(int k) const {
    return k * kPer + lane / G;
  }
  __device__ __forceinline__ int from(int k) const {
    return ((lane - k * kPer) * G) & 31;
  }
  __device__ __forceinline__ bool mine(int k) const {
    return lane / kPer == k;
  }
};

// The warp's first chunk of 32 items, and the stride to its next
__device__ __forceinline__ int64_t first_chunk() {
  return ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) * 32;
}
__device__ __forceinline__ int64_t chunk_stride() {
  return (int64_t)gridDim.x * kThreads;
}

template <typename R>
__device__ __forceinline__ fm::Fc4<R> fc_or_zero(const R* fchr) {
  if (fchr == nullptr) return fm::Fc4<R>{};
  return fm::Fc4<R>{{fm::ldg(fchr), fm::ldg(fchr + 1), fm::ldg(fchr + 2),
                     fm::ldg(fchr + 3)}};
}

// out[i] = rank_{chars[i]}(rows[i]), plus fchr[chars[i]] when fchr is
// given.
template <typename R>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const uint32_t* __restrict__ blocks,
                const R* __restrict__ fchr, R zoff,
                const R* __restrict__ rows,
                const int32_t* __restrict__ chars, R* __restrict__ out,
                int64_t n) {
  const auto warp = fm::cg::tiled_partition<32>(fm::cg::this_thread_block());
  const auto g = fm::card_group<kTile>();
  const Rounds<kTile> w{(int)warp.thread_rank()};
  fm::FlatTables<R> t{};
  t.blocks = blocks;
  t.zoff = zoff;
  const fm::Fc4<R> fc = fc_or_zero<R>(fchr);
  for (int64_t base = first_chunk(); base < n; base += chunk_stride()) {
    const int64_t i = base + w.lane;
    R r = 0;
    int c = 0;
    if (i < n) {
      r = fm::ldg(rows + i);
      c = fm::ldg(chars + i);
    }
    R res = 0;
    FM_UNROLL
    for (int k = 0; k < kTile; ++k) {
      const int q = w.item(k);
      const R rq = warp.shfl(r, q);
      const int cq = warp.shfl(c, q);
      int code = 0;
      const R v = fm::scan_rank<R>(t, g, rq, cq, &code) + fc.at(cq);
      const R back = warp.shfl(v, w.from(k));
      if (w.mine(k)) res = back;
    }
    if (i < n) out[i] = res;
  }
}

// t1/b1[e + c * n] = LF(t0[e], c) / LF(b0[e], c) where b0[e] > t0[e],
// else 0.
template <typename R>
__global__ void __launch_bounds__(kThreads)
    level1_kernel(const uint32_t* __restrict__ blocks,
                  const R* __restrict__ fchr, R zoff,
                  const R* __restrict__ t0, const R* __restrict__ b0,
                  R* __restrict__ t1, R* __restrict__ b1, int64_t n) {
  const auto warp = fm::cg::tiled_partition<32>(fm::cg::this_thread_block());
  const auto g = fm::card_group<kTileL1>();
  const Rounds<kTileL1> w{(int)warp.thread_rank()};
  const fm::Fc4<R> fc = fc_or_zero<R>(fchr);
  for (int64_t base = first_chunk(); base < n; base += chunk_stride()) {
    const int64_t e = base + w.lane;
    R lt = 0, lb = 0;
    if (e < n) {
      lt = fm::ldg(t0 + e);
      lb = fm::ldg(b0 + e);
    }
    R top[4] = {}, bot[4] = {};
    FM_UNROLL
    for (int k = 0; k < kTileL1; ++k) {
      const int q = w.item(k);
      const fm::EndsLF<R> x =
          fm::scan_ends<R>(blocks, g, warp.shfl(lt, q), warp.shfl(lb, q));
      FM_UNROLL
      for (int c = 0; c < 4; ++c) {
        const R vt = warp.shfl(x.top(fc, zoff, c), w.from(k));
        const R vb = warp.shfl(x.bot(fc, zoff, c), w.from(k));
        if (w.mine(k)) {
          top[c] = vt;
          bot[c] = vb;
        }
      }
    }
    if (e < n) {
      FM_UNROLL
      for (int c = 0; c < 4; ++c) {
        t1[e + c * n] = top[c];
        b1[e + c * n] = bot[c];
      }
    }
  }
}

// The grid for n items: a block covers kThreads items a pass (a warp
// loads 32), capped at the resident blocks.
template <auto Kernel>
cudaError_t grid_for(int64_t n, int* grid, int* resident = nullptr) {
  return fm::persistent_grid<Kernel>(kThreads, 1, n, grid, resident);
}

template <typename R>
int launch_rank(const void* blocks, const void* fchr, int64_t zoff,
                const void* rows, const void* chars, void* out, int64_t n,
                void* stream) {
  if (n > 0) {
    int grid = 0;
    const cudaError_t e = grid_for<rank_kernel<R>>(n, &grid);
    if (e != cudaSuccess) return (int)e;
    rank_kernel<R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)blocks, (const R*)fchr, (R)zoff, (const R*)rows,
        (const int32_t*)chars, (R*)out, n);
  }
  return (int)cudaGetLastError();
}

template <typename R>
int launch_level1(const void* blocks, const void* fchr, int64_t zoff,
                  const void* t0, const void* b0, void* t1, void* b1,
                  int64_t n, void* stream) {
  if (n > 0) {
    int grid = 0;
    const cudaError_t e = grid_for<level1_kernel<R>>(n, &grid);
    if (e != cudaSuccess) return (int)e;
    level1_kernel<R><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)blocks, (const R*)fchr, (R)zoff, (const R*)t0,
        (const R*)b0, (R*)t1, (R*)b1, n);
  }
  return (int)cudaGetLastError();
}

// The launch shape for n items: tile, threads a block, grid, registers
// a thread (ptxas's count), resident grid.
template <auto Kernel>
int config(int tile, int64_t n, int32_t* out) {
  int grid = 0, resident = 0;
  cudaError_t e = grid_for<Kernel>(n, &grid, &resident);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, Kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = tile;
  out[1] = kThreads;
  out[2] = grid;
  out[3] = attr.numRegs;
  out[4] = resident;
  return 0;
}

}  // namespace

// fchr may be null: then the result is rank_c(row), else LF(row, c).
#define FM_RANK_ENTRIES(KIND, R)                                            \
  extern "C" int fm_rank_##KIND(const void* blocks, const void* fchr,       \
                                int64_t zoff, const void* rows,             \
                                const void* chars, void* out, int64_t n,    \
                                void* stream) {                             \
    return launch_rank<R>(blocks, fchr, zoff, rows, chars, out, n, stream); \
  }                                                                         \
  extern "C" int fm_lf_level1_##KIND(                                       \
      const void* blocks, const void* fchr, int64_t zoff, const void* t0,   \
      const void* b0, void* t1, void* b1, int64_t n, void* stream) {        \
    return launch_level1<R>(blocks, fchr, zoff, t0, b0, t1, b1, n, stream); \
  }

FM_RANK_ENTRIES(narrow, int32_t)
FM_RANK_ENTRIES(wide, int64_t)

extern "C" int fm_rank_config(int32_t wide, int64_t n, int32_t* out) {
  return wide ? config<rank_kernel<int64_t>>(kTile, n, out)
              : config<rank_kernel<int32_t>>(kTile, n, out);
}

extern "C" int fm_lf_level1_config(int32_t wide, int64_t n, int32_t* out) {
  return wide ? config<level1_kernel<int64_t>>(kTileL1, n, out)
              : config<level1_kernel<int32_t>>(kTileL1, n, out);
}
