// Per-lane FM-index arithmetic shared by the CUDA kernels (rank.cu,
// search.cu, ftab12.cu, resolve.cu, presolve.cu, sharded.cu) and by the
// host build of the same header that the CPU tests compile
// (cpu_twin.cpp). Every function is
// __host__ __device__, so the arithmetic the card runs is the arithmetic
// the tests check.
//
// The search and the SA walk are one lane loop each (search_lane,
// resolve_row), templated over a table reader: FlatTables, the tables of
// one device (K1, K3), or ShardSet, the fm shards of one dp row of a mesh
// (K6). Tables are read through the read-only path (ldg).
//
// Block layout (ops/fm_torch.pack_bwt_blocks): uint32 rows of 512 bases,
//   narrow (R = int32_t): occ[4]              | words[32]   (36 words)
//   wide   (R = int64_t): occ_lo[4] occ_hi[4] | words[32]   (40 words)
// 16 bases per word, little-endian 2-bit codes. Occ checkpoints are
// global prefix counts. '$' is stored as code 0 at row zoff and the rank
// subtracts it once.
//
// Packed ftab rows (ops/fm_torch.pack_ftab_rows), same row width:
//   narrow: 16 (top, bot) pairs per row; wide: 8 (top_lo, top_hi, bot_lo,
//   bot_hi) quads per row.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FM_HD __host__ __device__ __forceinline__
#define FM_HDM __host__ __device__ __forceinline__
#else
#define FM_HD static inline
#define FM_HDM inline
#endif

namespace fm {

template <typename R>
struct Geo;
template <>
struct Geo<int32_t> {
  static constexpr int kWordOff = 4;
  static constexpr int kWidth = 36;
  static constexpr int kPerShift = 4;  // 16 ftab entries per row
};
template <>
struct Geo<int64_t> {
  static constexpr int kWordOff = 8;
  static constexpr int kWidth = 40;
  static constexpr int kPerShift = 3;  // 8 ftab entries per row
};

constexpr int kFtabChars = 10;

// Loads of the index tables, which no kernel writes: the read-only
// (non-coherent) path on the card.
FM_HD uint32_t ldg(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}
FM_HD int32_t ldg(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}
FM_HD int64_t ldg(const int64_t* p) {
#if defined(__CUDA_ARCH__)
  return (int64_t)__ldg((const long long*)p);
#else
  return *p;
#endif
}

FM_HD int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Bases equal to c among the first nvalid (0..16) bases of a word. The
// word XOR the char's repeated pattern turns matching bases into 00; the
// AND of the complement's two bit planes leaves one marker bit per base.
// The mask never shifts by 32 (undefined in C++ and CUDA).
FM_HD int count_in_word(uint32_t word, uint32_t pattern, int nvalid) {
  uint32_t x = ~(word ^ pattern);
  uint32_t y = x & (x >> 1) & 0x55555555u;
  uint32_t mask =
      nvalid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * (nvalid & 15))) - 1u);
  return popc32(y & mask);
}

template <typename R>
FM_HD R occ_at(const uint32_t* row, int c) {
  if constexpr (sizeof(R) == 8) {
    return (R)(((uint64_t)ldg(row + 4 + c) << 32) | (uint64_t)ldg(row + c));
  } else {
    return (R)ldg(row + c);
  }
}

// rank_c(r): occurrences of c in bwt[0:r], '$' excluded, from the block
// row that holds r (row = r's block, wherever the table holding it lies).
template <typename R>
FM_HD R rank_in_row(const uint32_t* row, R zoff, R r, int c) {
  const uint32_t* words = row + Geo<R>::kWordOff;
  const int within = (int)(r & 511);
  const uint32_t pattern = (uint32_t)c * 0x55555555u;
  const int full = within >> 4;
  int cnt = 0;
  for (int w = 0; w < full; ++w)
    cnt += count_in_word(ldg(words + w), pattern, 16);
  if (within & 15)
    cnt += count_in_word(ldg(words + full), pattern, within & 15);
  return occ_at<R>(row, c) + (R)cnt - (R)((c == 0 && zoff < r) ? 1 : 0);
}

template <typename R>
FM_HD R rank(const uint32_t* blocks, R zoff, R r, int c) {
  return rank_in_row<R>(blocks + (int64_t)(r >> 9) * Geo<R>::kWidth, zoff, r,
                        c);
}

template <typename R>
FM_HD R lf(const uint32_t* blocks, const R* fchr, R zoff, R r, int c) {
  return fchr[c] + rank<R>(blocks, zoff, r, c);
}

// BWT code at row r ('$' reads as the code 0 it is stored as), from the
// block row that holds r
template <typename R>
FM_HD int bwt_in_row(const uint32_t* row, R r) {
  const uint32_t* words = row + Geo<R>::kWordOff;
  return (int)((ldg(words + (int)((r & 511) >> 4)) >> (2 * (int)(r & 15))) &
               3u);
}

template <typename R>
FM_HD void ftab_entry(const uint32_t* rows, int64_t fi, R* top, R* bot) {
  const uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    const int q = (int)(fi & 7) * 4;
    *top = (R)(((uint64_t)ldg(row + q + 1) << 32) | (uint64_t)ldg(row + q));
    *bot = (R)(((uint64_t)ldg(row + q + 3) << 32) | (uint64_t)ldg(row + q + 2));
  } else {
    const int p = (int)(fi & 15) * 2;
    *top = (R)ldg(row + p);
    *bot = (R)ldg(row + p + 1);
  }
}

template <typename R>
FM_HD void ftab_store(uint32_t* rows, int64_t fi, R top, R bot) {
  uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    const int q = (int)(fi & 7) * 4;
    row[q] = (uint32_t)((uint64_t)top & 0xFFFFFFFFu);
    row[q + 1] = (uint32_t)((uint64_t)top >> 32);
    row[q + 2] = (uint32_t)((uint64_t)bot & 0xFFFFFFFFu);
    row[q + 3] = (uint32_t)((uint64_t)bot >> 32);
  } else {
    const int p = (int)(fi & 15) * 2;
    row[p] = (uint32_t)top;
    row[p + 1] = (uint32_t)bot;
  }
}

// One depth-12 ftab entry, idx = e10 | c10 << 20 | c11 << 22 (the
// window layout of the search: the char at cur+j sits at bits 2j). t1/b1
// hold LF(t0, c10) / LF(b0, c10) at e10 | c10 << 20. Guards as
// native/fmwalk.cpp fm_ftab_extend: an empty depth-10 parent gives an
// empty (0, 0) level-1 range, and level 2 extends only a non-empty
// level-1 range; every other entry stores (0, 0).
template <typename R>
FM_HD void ftab12_entry(const uint32_t* blocks, const R* fchr, R zoff,
                        const R* t0, const R* b0, const R* t1, const R* b1,
                        uint32_t* out, int64_t idx) {
  const int64_t e10 = idx & ((1 << 20) - 1);
  const int64_t i1 = idx & ((1 << 22) - 1);
  const int c11 = (int)((idx >> 22) & 3);
  R lt = 0, lb = 0;
  if (b0[e10] > t0[e10]) {
    lt = t1[i1];
    lb = b1[i1];
  }
  R top = 0, bot = 0;
  if (lb > lt) {
    top = lf<R>(blocks, fchr, zoff, lt, c11);
    bot = lf<R>(blocks, fchr, zoff, lb, c11);
  }
  ftab_store<R>(out, idx, top, bot);
}

// ---- the table readers ----
//
// A reader gives the lane loops their table reads: zoff; fc(c), fchr[c];
// row(r), the block row holding row r (null where no table holds it);
// ftab10(fi), the depth-10 ftab entry; deep() and ftab12_at(fi), the
// depth-12 prime; sample(si), SA sample si; kMasked, whether row() can
// be null; kUnroll, the walk's step-bound granularity.

// LF(r, c) and BWT[r] from the block row holding r (a rank of 0 and code
// 0 where none does: an owner-masked read that no shard answers)
template <typename R, typename T>
FM_HD R lf_in(const T& t, const uint32_t* row, R r, int c) {
  if (T::kMasked && row == nullptr) return t.fc(c);
  return t.fc(c) + rank_in_row<R>(row, t.zoff, r, c);
}

template <typename R, typename T>
FM_HD int bwt_in(const uint32_t* row, R r) {
  if (T::kMasked && row == nullptr) return 0;
  return bwt_in_row<R>(row, r);
}

// The whole index on one device: packed block and ftab rows, the
// (ceil(n/8), 8)-padded sample table, whose index is clipped to it.
template <typename R>
struct FlatTables {
  static constexpr bool kMasked = false;
  static constexpr int kUnroll = 8;  // the JAX walk's 8-step unroll
  const uint32_t* blocks;
  const R* fchr;
  R zoff;
  const uint32_t* ftab;    // packed depth-10 rows
  const uint32_t* ftab12;  // packed depth-12 rows, or null (no prime)
  const int32_t* offs;     // the samples, or null (search)
  int64_t noffs;           // their count, padding included

  FM_HDM R fc(int c) const { return ldg(fchr + c); }
  FM_HDM const uint32_t* row(R r) const {
    return blocks + (int64_t)(r >> 9) * Geo<R>::kWidth;
  }
  FM_HDM void ftab10(int64_t fi, R* top, R* bot) const {
    ftab_entry<R>(ftab, fi, top, bot);
  }
  FM_HDM bool deep() const { return ftab12 != nullptr; }
  FM_HDM void ftab12_at(int64_t fi, R* top, R* bot) const {
    ftab_entry<R>(ftab12, fi, top, bot);
  }
  FM_HDM int32_t sample(R si) const {
    if (si < 0) si = 0;
    if (si > (R)(noffs - 1)) si = (R)(noffs - 1);
    return ldg(offs + si);
  }
};

// The fm shards of one dp row (parallel/sharded.py ShardedFMArrays):
// shard f holds the block rows [blk_base[f], + nblk_per), the ftab
// entries [ftab_base[f], + nftab_per) as (top, bot) pairs and the SA
// samples [offs_base[f], + noffs_per), split by range, so a key's owner
// is key / per. A key no shard owns reads 0, as the JAX package's
// owner-masked gathers summed over the fm axis give. A shard on another
// card is read through its peer mapping. No depth-12 prime: the JAX
// sharded kernels have none.
constexpr int kMaxShards = 8;

template <typename R>
struct ShardSet {
  static constexpr bool kMasked = true;
  static constexpr int kUnroll = 4;  // the JAX sharded walk's unroll
  const uint32_t* blocks[kMaxShards];
  const R* ftab_tb[kMaxShards];
  const int32_t* offs[kMaxShards];
  int64_t blk_base[kMaxShards];
  int64_t ftab_base[kMaxShards];
  int64_t offs_base[kMaxShards];
  int64_t nblk_per, nftab_per, noffs_per;
  int32_t n_fm;
  const R* fchr;  // replicated, on the row's lead device
  R zoff;

  // the shard owning key (one of per keys each), or -1
  FM_HDM int owner(R key, int64_t per) const {
    if (key < 0) return -1;
    const R f = key / (R)per;
    return f < (R)n_fm ? (int)f : -1;
  }
  FM_HDM R fc(int c) const { return ldg(fchr + c); }
  FM_HDM const uint32_t* row(R r) const {
    const R key = r >> 9;
    const int f = owner(key, nblk_per);
    if (f < 0) return nullptr;
    return blocks[f] + (int64_t)(key - (R)blk_base[f]) * Geo<R>::kWidth;
  }
  FM_HDM void ftab10(int64_t fi, R* top, R* bot) const {
    const int f = owner((R)fi, nftab_per);
    *top = *bot = 0;
    if (f < 0) return;
    const R* p = ftab_tb[f] + 2 * (fi - ftab_base[f]);
    *top = ldg(p);
    *bot = ldg(p + 1);
  }
  FM_HDM bool deep() const { return false; }
  FM_HDM void ftab12_at(int64_t, R* top, R* bot) const { *top = *bot = 0; }
  FM_HDM int32_t sample(R si) const {
    const int f = owner(si, noffs_per);
    return f < 0 ? 0 : ldg(offs[f] + (si - (R)offs_base[f]));
  }
};

// A dp row's ShardSet from its descriptor words (parallel/sharded.py
// shard_descriptor): n_fm, nblk_per, nftab_per, noffs_per, zoff, fchr,
// then per shard blocks, ftab_tb, offs, blk_base, ftab_base, offs_base.
// False when n_fm is outside 1..kMaxShards.
template <typename R>
inline bool shard_set(const int64_t* d, ShardSet<R>* s) {
  if (d[0] < 1 || d[0] > kMaxShards) return false;
  *s = ShardSet<R>{};
  s->n_fm = (int32_t)d[0];
  s->nblk_per = d[1];
  s->nftab_per = d[2];
  s->noffs_per = d[3];
  s->zoff = (R)d[4];
  s->fchr = (const R*)(uintptr_t)d[5];
  for (int f = 0; f < s->n_fm; ++f) {
    const int64_t* e = d + 6 + 6 * f;
    s->blocks[f] = (const uint32_t*)(uintptr_t)e[0];
    s->ftab_tb[f] = (const R*)(uintptr_t)e[1];
    s->offs[f] = (const int32_t*)(uintptr_t)e[2];
    s->blk_base[f] = e[3];
    s->ftab_base[f] = e[4];
    s->offs_base[f] = e[5];
  }
  return true;
}

// ---- the greedy search (K1, K6) ----

template <typename R>
struct SearchArgs {
  const uint8_t* reads;  // [L, row_bytes]: reversed codes, 2 per byte
  int64_t row_bytes;
  const int32_t* lengths;
  const int32_t* start;
  R* h_top;  // [L, mh]
  R* h_bot;
  int32_t* h_off;
  int32_t* h_len;
  int32_t* nhits;  // [L]
  int32_t* sums;
  int32_t mh;
  int32_t min_hitlen;
  int32_t increment;
  int32_t first_hit_only;
};

// base code at position pos of a lane's reversed read (0-3, 4 = N)
FM_HD int read_code(const uint8_t* rd, int pos) {
  const uint8_t b = rd[pos >> 1];
  return (pos & 1) ? (b >> 4) : (b & 15);
}

// The greedy partial-hit scan of one (read, strand) lane, run to the end
// (hi_aligner.h partialSearch under the classifier's driver policy).
// Outputs match classify/engine.search_loop of the JAX package: hits in
// emission order, an empty hit is top == bot == -1, unused slots hold
// (-1, -1, 0, 0), and a lane that emits more than mh hits keeps
// overwriting its last slot (the caller re-runs it with a larger mh).
// With a depth-12 table (t.deep()) a start first tries the 12-char prime.
// Returns the lane's count of table reads (ftab entries and extension
// steps): the lockstep loop's step count for this lane.
template <typename R, typename T>
FM_HD int search_lane(const T& t, const SearchArgs<R>& a, int64_t lane) {
  const uint8_t* rd = a.reads + lane * a.row_bytes;
  const int n = a.lengths[lane];
  R* ht = a.h_top + lane * a.mh;
  R* hb = a.h_bot + lane * a.mh;
  int32_t* ho = a.h_off + lane * a.mh;
  int32_t* hl = a.h_len + lane * a.mh;
  for (int s = 0; s < a.mh; ++s) {
    ht[s] = -1;
    hb[s] = -1;
    ho[s] = 0;
    hl[s] = 0;
  }
  int cur = a.start[lane];
  int nh = 0, sum = 0, reads = 0;
  bool no12 = false;  // the deep prime of this start came back empty
  while (cur < n) {
    const int left = n - cur;
    bool go = false;
    R top = 0, bot = 0;
    int dep = cur;
    // ---- start: deep 12-char prime, else the 10-char ftab window ----
    if (t.deep() && !no12 && left >= 12) {
      int64_t fi12 = 0;
      bool has_n = false;
      for (int j = 0; j < 12; ++j) {
        const int c = read_code(rd, cur + j);
        has_n |= c > 3;
        fi12 |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
      }
      if (!has_n) {
        t.ftab12_at(fi12, &top, &bot);
        ++reads;
        if (bot <= top) {
          // an empty 12-mer range retries this start on the plain path
          no12 = true;
          continue;
        }
        go = true;
        dep = cur + 12;
      }
    }
    R e_top = -1, e_bot = -1;
    int e_off = cur, e_len, e_cur;
    if (!go) {
      if (left < kFtabChars) {
        e_len = left;
        e_cur = n;
      } else {
        int fn = kFtabChars;
        int64_t fi = 0;
        for (int j = 0; j < kFtabChars; ++j) {
          const int c = read_code(rd, cur + j);
          if (c > 3 && fn == kFtabChars) fn = j;
          fi |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
        }
        if (fn < kFtabChars) {
          e_len = fn + 1;
          e_cur = cur + fn + 1;
        } else {
          t.ftab10(fi, &top, &bot);
          ++reads;
          if (bot > top) {
            go = true;
            dep = cur + kFtabChars;
          } else {
            e_len = kFtabChars;
            e_cur = cur + kFtabChars;
          }
        }
      }
    }
    if (go) {
      // ---- extend one char at a time; top and bot rank from their own
      // blocks; a one-row range extends only if BWT[top] == c and
      // top is not the '$' row ----
      while (dep < n) {
        const int c = read_code(rd, dep);
        if (c > 3) break;
        R t2, b2;
        if (bot - top == 1) {
          if (top == t.zoff) break;
          const uint32_t* row = t.row(top);
          ++reads;
          if (bwt_in<R, T>(row, top) != c) break;
          t2 = lf_in<R>(t, row, top, c);
          b2 = t2 + 1;
        } else {
          ++reads;
          t2 = lf_in<R>(t, t.row(top), top, c);
          b2 = lf_in<R>(t, t.row(bot), bot, c);
          if (b2 <= t2) break;
        }
        top = t2;
        bot = b2;
        ++dep;
      }
      e_top = top;
      e_bot = bot;
      e_len = dep - cur;
      e_cur = dep;
    }
    // ---- emit ----
    const int slot = nh < a.mh ? nh : a.mh - 1;
    ht[slot] = e_top;
    hb[slot] = e_bot;
    ho[slot] = e_off;
    hl[slot] = e_len;
    ++nh;
    if (e_len >= a.min_hitlen) sum += e_len;
    no12 = false;
    // ---- driver policy: skip one position after a long hit, stop when
    // the tail can no longer hold a min_hitlen hit ----
    if (a.first_hit_only || e_cur >= n) break;
    const int next = e_len > a.increment ? e_cur + 1 : e_cur;
    if (next + a.min_hitlen >= n) break;
    cur = next;
  }
  a.nhits[lane] = nh;
  a.sums[lane] = sum;
  return reads;
}

// ---- SA resolution (K3, K6): SA row -> sequence index ----

template <typename R>
struct ResolveArgs {
  const R* brows;        // [nb] sorted genome-boundary rows
  const int32_t* brefs;  // [nb] their refs
  int64_t nb;
  int32_t offrate;
  int32_t narrow;     // npat <= 0xFFFF: boundary refs masked to 16 bits
  int32_t max_steps;  // LF step bound, tested once per T::kUnroll steps
};

// The exits of one row (ops/fm_jax.py _try_offset of the JAX package;
// tryOffset, bt2_idx.h:1980-2014): the '$' row gives 0 and wins; else a
// sampled row gives its sample (the reader's: clipped to the padded
// table, or 0 where no shard owns it); else a boundary row gives its
// ref, checked only when the last boundary row is nonzero and the row
// does not pass it; else -1.
// The exits given the row's sample value (read by the caller, only for a
// sampled row) and the genome-boundary table.
template <typename R>
FM_HD int32_t row_exit(R row, R zoff, bool sampled, int32_t sample,
                       const R* brows, const int32_t* brefs, int64_t nb,
                       int32_t narrow) {
  int32_t t = -1;
  if (sampled) {
    t = sample;
  } else if (nb > 0) {
    int64_t lo = 0, hi = nb;  // searchsorted, side "left"
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (brows[mid] < row) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t pos = lo < nb ? lo : nb - 1;
    const R last = brows[nb - 1];
    if (brows[pos] == row && last > 0 && row <= last)
      t = narrow ? (brefs[pos] & 0xFFFF) : brefs[pos];
  }
  if (row == zoff) t = 0;
  return t;
}

template <typename R, typename T>
FM_HD int32_t try_offset(const T& t, const ResolveArgs<R>& a, R row) {
  const bool sampled = (row & (((R)1 << a.offrate) - 1)) == 0;
  const int32_t sample = sampled ? t.sample(row >> a.offrate) : 0;
  return row_exit<R>(row, t.zoff, sampled, sample, a.brows, a.brefs, a.nb,
                     a.narrow);
}

// The walk's LF step bound: the JAX walks count steps and test max_steps
// once per unrolled while-loop iteration (8 steps on one device, 4 over
// shards), so they give up after max_steps rounded up to a multiple of
// the unroll.
FM_HD int64_t walk_budget(int64_t max_steps, int unroll) {
  return (max_steps + unroll - 1) / unroll * unroll;
}

// The LF walk of one row until an exit, or -1 after walk_budget steps.
// A row's result does not depend on the other rows of its batch, so the
// per-row walk gives the lockstep walk's output. *rounds, where given,
// receives the row's rounds of table reads (its exits, then one per LF
// step): the lockstep walk's step count for this row.
template <typename R, typename T>
FM_HD int32_t resolve_row(const T& t, const ResolveArgs<R>& a, R row,
                          int64_t* rounds = nullptr) {
  int32_t v = try_offset<R>(t, a, row);
  const int64_t budget = walk_budget(a.max_steps, T::kUnroll);
  int64_t k = 0;
  for (; v < 0 && k < budget; ++k) {
    const uint32_t* rw = t.row(row);
    row = lf_in<R>(t, rw, row, bwt_in<R, T>(rw, row));
    v = try_offset<R>(t, a, row);
  }
  if (rounds != nullptr) *rounds = k + 1;
  return v;
}

// ---- presolve pick (K5): the SA rows a mate's classification asks for ----

template <typename R>
struct PickArgs {
  const R* h_top;  // [2M, mh] first-pass hit buffers; lanes 2m, 2m+1 are
  const R* h_bot;  // mate m's fw and rc strands
  const int32_t* h_len;
  int32_t mh;
  int32_t khits;
  int32_t ihits;
  int32_t min_hitlen;
  int32_t rk;
  R* rows;         // [M, rk]; unused slots 0
  int32_t* nrows;  // [M]
};

template <typename R>
FM_HD R hit_size(const R* t, const R* b, int i) {
  return t[i] >= 0 ? b[i] - t[i] : 0;
}

// Mate m's rows, as classify/engine.py _presolve_pick_rows of the JAX
// package: strand choice by score then max length, the
// max_genome_hit_size budget mghs, the gate len > min_hitlen, size != 0,
// chosen strand, min(size, mghs) <= ihits; gated hits in the stable
// order of the key min(size, 2^18) * 4096 - len (fw hits before rc on
// ties), each taken while the nelts before it sum to less than mghs,
// its rows laid into the rk slots from that sum on. Entry i is strand
// i / mh, slot i % mh. A hit's place in the stable order is the number
// of gated hits that sort before it, so no sort is needed: 2 mh is at
// most 32 on the first pass.
template <typename R>
FM_HD void pick_mate(const PickArgs<R>& a, int64_t m) {
  const int mh = a.mh, n = 2 * a.mh;
  const R* t = a.h_top + 2 * m * mh;
  const R* b = a.h_bot + 2 * m * mh;
  const int32_t* ln = a.h_len + 2 * m * mh;
  int32_t sc[2] = {0, 0}, mx[2] = {0, 0};
  for (int i = 0; i < n; ++i) {
    const int s = i / mh;
    if (ln[i] >= a.min_hitlen && hit_size<R>(t, b, i) != 0) {
      sc[s] += (ln[i] - 15) * (ln[i] - 15);
      if (ln[i] > mx[s]) mx[s] = ln[i];
    }
  }
  const bool fw = sc[0] > sc[1] || (sc[0] == sc[1] && mx[0] > mx[1]);
  const bool rc = sc[1] > sc[0] || (sc[0] == sc[1] && mx[1] > mx[0]);
  const bool use[2] = {fw || (!fw && !rc), rc || (!fw && !rc)};
  R maxsz = 0;
  for (int i = 0; i < n; ++i) {
    const R size = hit_size<R>(t, b, i);
    if (ln[i] >= a.min_hitlen && size != 0 && use[i / mh] && size > maxsz)
      maxsz = size;
  }
  const R mghs = maxsz > (R)a.khits
                     ? maxsz + (R)((int)use[0] + (int)use[1]) * (R)a.khits
                     : (R)a.khits;
  R* rows = a.rows + m * a.rk;
  for (int s = 0; s < a.rk; ++s) rows[s] = 0;
  R total = 0;
  for (int i = 0; i < n; ++i) {
    const R size = hit_size<R>(t, b, i);
    const R nelt = size < mghs ? size : mghs;
    if (!(ln[i] > a.min_hitlen && size != 0 && use[i / mh] &&
          nelt <= (R)a.ihits))
      continue;
    const R key = (size < ((R)1 << 18) ? size : ((R)1 << 18)) * 4096 - ln[i];
    R prev = 0;  // nelts of the gated hits that sort before hit i
    for (int k = 0; k < n; ++k) {
      const R sk = hit_size<R>(t, b, k);
      const R nk = sk < mghs ? sk : mghs;
      if (k == i || !(ln[k] > a.min_hitlen && sk != 0 && use[k / mh] &&
                      nk <= (R)a.ihits))
        continue;
      const R kk = (sk < ((R)1 << 18) ? sk : ((R)1 << 18)) * 4096 - ln[k];
      if (kk < key || (kk == key && k < i)) prev += nk;
    }
    if (nelt > 0 && prev < mghs) {
      total += nelt;
      for (R s = prev; s < prev + nelt && s < (R)a.rk; ++s)
        rows[s] = t[i] + (s - prev);
    }
  }
  a.nrows[m] = (int32_t)(total < (R)a.rk ? total : (R)a.rk);
}

}  // namespace fm
