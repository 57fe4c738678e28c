// K3: SA row -> sequence index, one thread per row, each row walking LF
// to its own exit ('$' row, sampled row or genome-boundary row).
//
// Replaces the JAX package's ops/fm_jax.py resolve walk: _try_offset,
// _resolve_body, resolve_rows_core (through _resolve_rows and
// make_resolver) and resolve_rows_two_phase. The TPU version steps all
// rows in lockstep, 8 unrolled steps per while-loop iteration, so every
// row pays the longest walk of its batch; the two-phase variant compacts
// the survivors to cut that tail. Here each thread stops at its own exit
// (fm_common.cuh resolve_row over the one-device FlatTables reader; K6
// walks the same loop over its shards), which gives the single-phase
// outputs,
// including the -1 of a row still unresolved after max_steps steps
// rounded up to a multiple of 8.
//
// Bound on an H100: each LF step reads one BWT word and ranks in the
// same block row (occ checkpoint and the words before the row), at a
// data-dependent address; an exit reads one sample. The bound counts
// each 32-byte sector of the block and sample tables that the walk
// touches once, plus the rows in and the results out, over 3.35 TB/s,
// against the rank arithmetic at the card's integer and popcount rates.
// A walk is a chain of dependent row reads (about 2^offrate steps on
// average), so it is latency-bound; the design keeps many rows in
// flight (one thread each, 128 per block) so the card overlaps them.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

template <typename R>
__global__ void resolve_kernel(fm::FlatTables<R> t, fm::ResolveArgs<R> a,
                               const R* __restrict__ rows,
                               int32_t* __restrict__ tidx, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tidx[i] = fm::resolve_row<R>(t, a, rows[i]);
}

template <typename R>
int launch(const void* blocks, const void* fchr, int64_t zoff,
           const void* offs, int64_t noffs, const void* brows,
           const void* brefs, int64_t nb, int32_t offrate, int32_t narrow,
           int32_t max_steps, const void* rows, void* tidx, int64_t n,
           void* stream) {
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
    const int threads = 128;
    const int64_t grid = (n + threads - 1) / threads;
    resolve_kernel<R><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        t, a, (const R*)rows, (int32_t*)tidx, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_RESOLVE_ENTRY(NAME, R)                                           \
  extern "C" int NAME(const void* blocks, const void* fchr, int64_t zoff,   \
                      const void* offs, int64_t noffs, const void* brows,   \
                      const void* brefs, int64_t nb, int32_t offrate,       \
                      int32_t narrow, int32_t max_steps, const void* rows,  \
                      void* tidx, int64_t n, void* stream) {                \
    return launch<R>(blocks, fchr, zoff, offs, noffs, brows, brefs, nb,     \
                     offrate, narrow, max_steps, rows, tidx, n, stream);    \
  }

FM_RESOLVE_ENTRY(fm_resolve_narrow, int32_t)
FM_RESOLVE_ENTRY(fm_resolve_wide, int64_t)
