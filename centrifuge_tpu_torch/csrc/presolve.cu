// K5: the in-dispatch presolve. Per mate, the SA rows its classification
// is predicted to ask for, compacted into R flat slots that K3
// (resolve.cu) then resolves on the same stream.
//
// Replaces the JAX package's classify/engine.py _presolve_pick_rows and
// the compaction of batched_search_presolve (a cumsum, a searchsorted
// and a gather into R = 4 M slots). Three launches on one stream:
//   pick     one thread per mate (fm_common.cuh pick_mate): rows [M, rk]
//            and their count nrows [M]
//   scan     one block: the exclusive prefix sum of nrows, in two passes
//            (each thread sums a contiguous chunk; the block scans the
//            1024 chunk sums in shared memory; each thread writes its
//            chunk's prefixes)
//   compact  one thread per flat slot j: its mate is the last one whose
//            prefix is <= j; a slot past the mate's count, or past the
//            last mate's rows, holds 0; rows beyond R are dropped
//
// Bound on an H100: the hit buffers h_top, h_bot and h_len are read once
// and the R flat rows written once, over 3.35 TB/s; the arithmetic (about
// (2 mh)^2 key compares per mate) stays far below the integer issue
// rate. The pick reads a mate's 2 mh entries again for each compare; they
// stay in L1. The scan is one block, a few microseconds at M = 32,768.
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

constexpr int kScanThreads = 1024;

template <typename R>
__global__ void pick_kernel(fm::PickArgs<R> a, int64_t M) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  fm::pick_mate<R>(a, m);
}

__global__ void scan_kernel(const int32_t* __restrict__ nrows,
                            int32_t* __restrict__ doffs, int64_t M) {
  __shared__ int32_t part[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (M + kScanThreads - 1) / kScanThreads;
  const int64_t lo = (int64_t)t * per < M ? (int64_t)t * per : M;
  const int64_t hi = lo + per < M ? lo + per : M;
  int32_t own = 0;
  for (int64_t i = lo; i < hi; ++i) own += nrows[i];
  part[t] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int32_t v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int32_t run = part[t] - own;
  for (int64_t i = lo; i < hi; ++i) {
    doffs[i] = run;
    run += nrows[i];
  }
}

template <typename R>
__global__ void compact_kernel(const R* __restrict__ rows,
                               const int32_t* __restrict__ nrows,
                               const int32_t* __restrict__ doffs, int64_t M,
                               int32_t rk, R* __restrict__ flat, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int64_t lo = 0, hi = M;  // first mate whose prefix exceeds j
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)doffs[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t mate = lo - 1;  // doffs[0] = 0 <= j, so mate >= 0
  const int64_t slot = j - doffs[mate];
  flat[j] = slot < nrows[mate] ? rows[mate * rk + slot] : (R)0;
}

template <typename R>
int launch(const void* h_top, const void* h_bot, const void* h_len,
           int64_t M, int32_t mh, int32_t khits, int32_t ihits,
           int32_t min_hitlen, int32_t rk, void* rows, void* nrows,
           void* doffs, void* flat, int64_t n, void* stream) {
  if (M <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
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
  const int threads = 128;
  pick_kernel<R><<<(unsigned)((M + threads - 1) / threads), threads, 0, s>>>(
      a, M);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)nrows,
                                         (int32_t*)doffs, M);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  compact_kernel<R><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      s>>>((const R*)rows, (const int32_t*)nrows,
                           (const int32_t*)doffs, M, rk, (R*)flat, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_PRESOLVE_ENTRY(NAME, R)                                          \
  extern "C" int NAME(const void* h_top, const void* h_bot,                 \
                      const void* h_len, int64_t M, int32_t mh,             \
                      int32_t khits, int32_t ihits, int32_t min_hitlen,     \
                      int32_t rk, void* rows, void* nrows, void* doffs,     \
                      void* flat, int64_t n, void* stream) {                \
    return launch<R>(h_top, h_bot, h_len, M, mh, khits, ihits, min_hitlen,  \
                     rk, rows, nrows, doffs, flat, n, stream);              \
  }

FM_PRESOLVE_ENTRY(fm_presolve_narrow, int32_t)
FM_PRESOLVE_ENTRY(fm_presolve_wide, int64_t)
