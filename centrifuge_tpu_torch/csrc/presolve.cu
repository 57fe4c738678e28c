// K5: the in-dispatch presolve. Per mate, the SA rows its classification
// is predicted to ask for, laid into n = 4 M flat slots that K3
// (resolve.cu) then resolves on the same stream.
//
// Replaces the JAX package's classify/engine.py _presolve_pick_rows and
// the compaction of batched_search_presolve (a cumsum, a searchsorted
// and a gather into 4 M slots: a scatter serialises on the TPU). One
// launch:
//   - a warp takes a mate (fm_common.cuh mate_rows): lane p loads its
//     entries p, p + 32, ... (a mate's entries are contiguous, so the
//     loads coalesce); strand scores, maxima and the row total are warp
//     reductions, and each gated hit's place in the stable order comes
//     from the keys and nelts shuffled round the warp; the mate's rows
//     are laid into the block's shared memory (rk slots a mate);
//   - a block holds fm::kPickMates mates (kPickWarps warps of
//     kPickMatesPerWarp): warp 0 scans their row counts, and a
//     single-pass decoupled look-back over the blocks before it (a
//     window of 32 blocks' flags read at once by the warp) gives the
//     block's offset in the flat slots; each warp then copies its
//     mates' rows to flat[offset + s], coalesced, slots past n dropped;
//   - the block that holds the last mate fills the slots from the grand
//     total to n with 0.
// A block's place in the look-back is a ticket from an atomic counter,
// not blockIdx: a block then waits only on blocks that have started,
// which publish their count without waiting, so no block waits forever.
// The counter and the blocks' flags are one zeroed int64 buffer the
// wrapper passes ([0] the ticket, [1 + b] block b's flag: 0 not ready,
// else 1 << 62 | its count, or 2 << 62 | its inclusive prefix).
//
// Bound on an H100: the hit buffers h_top, h_bot and h_len read once
// and the n flat rows written once, over 3.35 TB/s (chip_smoke.py).
#include <cuda_runtime.h>

#include "fm_common.cuh"

namespace {

constexpr int kThreads = 32 * fm::kPickWarps;
constexpr unsigned long long kAgg = 1ull << 62, kPrefix = 2ull << 62,
                             kValue = (1ull << 62) - 1;
static_assert(fm::kPickMates == 32, "warp 0 scans one count a lane");

__device__ unsigned long long read_flag(const unsigned long long* f) {
  return *(const volatile unsigned long long*)f;
}

__device__ void write_flag(unsigned long long* f, unsigned long long v) {
  *(volatile unsigned long long*)f = v;
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    presolve_kernel(const fm::PickArgs<R> a, int64_t M,
                    unsigned long long* __restrict__ state) {
  namespace cg = fm::cg;
  extern __shared__ __align__(16) unsigned char smem[];
  R* stage = reinterpret_cast<R*>(smem);  // [kPickMates, rk] laid rows
  __shared__ int32_t nr[fm::kPickMates];  // counts, then in-block offsets
  __shared__ int32_t cnt[fm::kPickMates];
  __shared__ int64_t s_base, s_total;
  __shared__ int64_t s_b;
  const auto block = cg::this_thread_block();
  const fm::Tile<32> w{cg::tiled_partition<32>(block)};
  const int wi = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
  if (threadIdx.x == 0) s_b = (int64_t)atomicAdd(state, 1ull);
  __syncthreads();
  const int64_t b = s_b, m0 = b * fm::kPickMates;
  unsigned long long* flags = state + 1;
  for (int j = 0; j < fm::kPickMatesPerWarp; ++j) {
    const int local = wi * fm::kPickMatesPerWarp + j;
    const int64_t m = m0 + local;
    const int32_t k =
        m < M ? fm::mate_rows<R>(a, w, m, stage + local * a.rk) : 0;
    if (lane == 0) nr[local] = cnt[local] = k;
  }
  __syncthreads();
  if (wi == 0) {
    const int32_t own = nr[lane];
    int32_t inc = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t v = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += v;
    }
    nr[lane] = inc - own;
    const int64_t agg = __shfl_sync(0xFFFFFFFFu, inc, 31);
    // the look-back: the warp reads the flags of the 32 blocks before
    // the window's end at once, waits until each is set, and adds the
    // counts down to the nearest inclusive prefix (a block before block
    // 0 reads as a prefix of 0); without one it moves 32 blocks back
    int64_t base = 0;
    if (lane == 0)
      write_flag(flags + b, (b == 0 ? kPrefix : kAgg) |
                                (unsigned long long)agg);
    for (int64_t q = b - 1; b > 0; q -= 32) {
      const int64_t j = q - lane;
      unsigned long long f = j >= 0 ? read_flag(flags + j) : kPrefix;
      while (__any_sync(0xFFFFFFFFu, f == 0))
        if (f == 0) f = read_flag(flags + j);
      const uint32_t pre = __ballot_sync(0xFFFFFFFFu, (f & kPrefix) != 0);
      const int first = pre != 0 ? __ffs(pre) - 1 : 32;
      int64_t v = lane <= first ? (int64_t)(f & kValue) : 0;
      for (int d = 16; d > 0; d >>= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
      base += v;
      if (pre != 0) break;
    }
    if (lane == 0) {
      if (b > 0)
        write_flag(flags + b, kPrefix | (unsigned long long)(base + agg));
      s_base = base;
      s_total = base + agg;
    }
  }
  __syncthreads();
  const int64_t base = s_base;
  for (int j = 0; j < fm::kPickMatesPerWarp; ++j) {
    const int local = wi * fm::kPickMatesPerWarp + j;
    fm::lay_rows<R>(stage + local * a.rk, cnt[local], base + nr[local],
                    a.flat, a.n, lane, 32);
  }
  if (m0 + fm::kPickMates >= M)
    fm::fill_tail<R>(a.flat, s_total, a.n, (int)threadIdx.x, kThreads);
}

template <typename R>
int launch(const void* h_top, const void* h_bot, const void* h_len,
           int64_t M, int32_t mh, int32_t khits, int32_t ihits,
           int32_t min_hitlen, int32_t rk, void* flat, int64_t n,
           void* state, void* stream) {
  if (M <= 0 || n <= 0) return (int)cudaGetLastError();
  fm::PickArgs<R> a;
  a.h_top = (const R*)h_top;
  a.h_bot = (const R*)h_bot;
  a.h_len = (const int32_t*)h_len;
  a.mh = mh;
  a.khits = khits;
  a.ihits = ihits;
  a.min_hitlen = min_hitlen;
  a.rk = rk;
  a.flat = (R*)flat;
  a.n = n;
  if (rk < 1 || rk > fm::kPickMaxRk) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (M + fm::kPickMates - 1) / fm::kPickMates;
  const size_t smem = (size_t)fm::kPickMates * rk * sizeof(R);
  presolve_kernel<R><<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      a, M, (unsigned long long*)state);
  return (int)cudaGetLastError();
}

}  // namespace

#define FM_PRESOLVE_ENTRY(NAME, R)                                          \
  extern "C" int NAME(const void* h_top, const void* h_bot,                 \
                      const void* h_len, int64_t M, int32_t mh,             \
                      int32_t khits, int32_t ihits, int32_t min_hitlen,     \
                      int32_t rk, void* flat, int64_t n, void* state,       \
                      void* stream) {                                       \
    return launch<R>(h_top, h_bot, h_len, M, mh, khits, ihits, min_hitlen,  \
                     rk, flat, n, state, stream);                           \
  }

FM_PRESOLVE_ENTRY(fm_presolve_narrow, int32_t)
FM_PRESOLVE_ENTRY(fm_presolve_wide, int64_t)
