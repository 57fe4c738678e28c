// Per-lane FM-index arithmetic shared by the CUDA kernels (rank.cu,
// search.cu, ftab12.cu, resolve.cu, presolve.cu, sharded.cu) and by the
// host build of the same header that the CPU tests compile
// (cpu_twin.cpp). Every function is
// __host__ __device__, so the arithmetic the card runs is the arithmetic
// the tests check.
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
#else
#define FM_HD static inline
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
    return (R)(((uint64_t)row[4 + c] << 32) | (uint64_t)row[c]);
  } else {
    return (R)row[c];
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
  for (int w = 0; w < full; ++w) cnt += count_in_word(words[w], pattern, 16);
  if (within & 15) cnt += count_in_word(words[full], pattern, within & 15);
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
  return (int)((words[(int)((r & 511) >> 4)] >> (2 * (int)(r & 15))) & 3u);
}

template <typename R>
FM_HD int bwt_at(const uint32_t* blocks, R r) {
  return bwt_in_row<R>(blocks + (int64_t)(r >> 9) * Geo<R>::kWidth, r);
}

template <typename R>
FM_HD void ftab_entry(const uint32_t* rows, int64_t fi, R* top, R* bot) {
  const uint32_t* row = rows + (fi >> Geo<R>::kPerShift) * Geo<R>::kWidth;
  if constexpr (sizeof(R) == 8) {
    const int q = (int)(fi & 7) * 4;
    *top = (R)(((uint64_t)row[q + 1] << 32) | (uint64_t)row[q]);
    *bot = (R)(((uint64_t)row[q + 3] << 32) | (uint64_t)row[q + 2]);
  } else {
    const int p = (int)(fi & 15) * 2;
    *top = (R)row[p];
    *bot = (R)row[p + 1];
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

template <typename R>
struct SearchArgs {
  const uint32_t* blocks;
  const R* fchr;
  R zoff;
  const uint32_t* ftab;    // packed depth-10 rows
  const uint32_t* ftab12;  // packed depth-12 rows, or null
  const uint8_t* reads;    // [L, row_bytes]: reversed codes, 2 per byte
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
  int32_t deep;
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
template <typename R>
FM_HD void search_lane(const SearchArgs<R>& a, int64_t lane) {
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
  int nh = 0, sum = 0;
  bool no12 = false;  // the deep prime of this start came back empty
  while (cur < n) {
    const int left = n - cur;
    bool go = false;
    R top = 0, bot = 0;
    int dep = cur;
    // ---- start: deep 12-char prime, else the 10-char ftab window ----
    if (a.deep && !no12 && left >= 12) {
      int64_t fi12 = 0;
      bool has_n = false;
      for (int j = 0; j < 12; ++j) {
        const int c = read_code(rd, cur + j);
        has_n |= c > 3;
        fi12 |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
      }
      if (!has_n) {
        ftab_entry<R>(a.ftab12, fi12, &top, &bot);
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
          ftab_entry<R>(a.ftab, fi, &top, &bot);
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
          if (top == a.zoff || bwt_at<R>(a.blocks, top) != c) break;
          t2 = lf<R>(a.blocks, a.fchr, a.zoff, top, c);
          b2 = t2 + 1;
        } else {
          t2 = lf<R>(a.blocks, a.fchr, a.zoff, top, c);
          b2 = lf<R>(a.blocks, a.fchr, a.zoff, bot, c);
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
}

// ---- SA resolution (K3): SA row -> sequence index ----

template <typename R>
struct ResolveArgs {
  const uint32_t* blocks;
  const R* fchr;
  R zoff;
  const int32_t* offs;   // the padded (ceil(n/8), 8) sample table, flat
  int64_t noffs;         // its length, padding included
  const R* brows;        // [nb] sorted genome-boundary rows
  const int32_t* brefs;  // [nb] their refs
  int64_t nb;
  int32_t offrate;
  int32_t narrow;     // npat <= 0xFFFF: boundary refs masked to 16 bits
  int32_t max_steps;  // LF step bound, tested once per 8 steps
};

// The exits of one row (ops/fm_jax.py _try_offset of the JAX package;
// tryOffset, bt2_idx.h:1980-2014): the '$' row gives 0 and wins; else a
// sampled row gives its sample (index clipped to the padded table);
// else a boundary row gives its ref, checked only when the last
// boundary row is nonzero and the row does not pass it; else -1.
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

template <typename R>
FM_HD int32_t try_offset(const ResolveArgs<R>& a, R row) {
  const R mask = ((R)1 << a.offrate) - 1;
  const bool sampled = (row & mask) == 0;
  int32_t sample = 0;
  if (sampled) {
    R si = row >> a.offrate;
    if (si < 0) si = 0;
    if (si > (R)(a.noffs - 1)) si = (R)(a.noffs - 1);
    sample = a.offs[si];
  }
  return row_exit<R>(row, a.zoff, sampled, sample, a.brows, a.brefs, a.nb,
                     a.narrow);
}

// The LF walk of one row until an exit. The JAX walk runs 8 steps per
// while-loop iteration, counts steps and tests max_steps once per
// iteration, so it gives up (-1) after max_steps rounded up to a multiple
// of 8; a row's result does not depend on the other rows of its batch, so
// the per-row walk gives the lockstep walk's output.
template <typename R>
FM_HD int32_t resolve_row(const ResolveArgs<R>& a, R row) {
  int32_t t = try_offset<R>(a, row);
  const int64_t budget = ((int64_t)a.max_steps + 7) / 8 * 8;
  for (int64_t k = 0; t < 0 && k < budget; ++k) {
    row = lf<R>(a.blocks, a.fchr, a.zoff, row, bwt_at<R>(a.blocks, row));
    t = try_offset<R>(a, row);
  }
  return t;
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

// ---- K6: the search and the resolve walk over BWT-range shards ----
//
// The index is split by range over n_fm shards (parallel/sharded.py
// ShardedFMArrays): shard s holds the block rows [blk_base, blk_base +
// nblk_per), the ftab entries [ftab_base, ftab_base + nftab_per) as (top,
// bot) pairs and the SA samples [offs_base, offs_base + noffs_per); fchr
// is replicated. A lane's step is split at its table reads. The advance
// (on the lead device of the lane's dp row) leaves the lane's next query;
// every shard answers it from its own slice, each value masked to zero
// where the shard does not own its row, entry or sample (the partials);
// the next advance sums the partials over the shards, which gives the
// owner's value (the JAX package's psum), and applies the rest of the
// transition. No depth-12 prime: the JAX sharded kernels set no `deep`.

template <typename R>
struct Shard {
  const uint32_t* blocks;  // [nblk_per, W] block rows
  const R* ftab_tb;        // [nftab_per, 2] (top, bot), or null (resolve)
  const int32_t* offs;     // [noffs_per] samples, or null (search)
  const R* fchr;           // [5]
  R zoff;
  int64_t blk_base, nblk_per;
  int64_t ftab_base, nftab_per;
  int64_t offs_base, noffs_per;
  int32_t offrate;
};

// the block row of shard s holding row r, or null where s does not own it
template <typename R>
FM_HD const uint32_t* shard_row(const Shard<R>& s, R r) {
  const int64_t b = (int64_t)(r >> 9) - s.blk_base;
  return (b >= 0 && b < s.nblk_per) ? s.blocks + b * Geo<R>::kWidth
                                    : nullptr;
}

// A search lane's query: kind | c << 2. kQFtab: the ftab entry qa;
// kQOne: rank(qa, c) and BWT[qa] (a one-row range); kQRange: rank(qa, c)
// and rank(qb, c).
constexpr int32_t kQNone = 0, kQFtab = 1, kQOne = 2, kQRange = 3;
// lane phases
constexpr int32_t kStart = 0, kExtend = 1, kDone = 2;

// Shard s's partials of lane i's query: p0, p1 in the row dtype (ftab top
// and bot, or the two ranks), p2 the BWT char. Lanes without a query
// write nothing; the advance reads no partials for them.
template <typename R>
FM_HD void search_partials(const Shard<R>& s, const R* qa, const R* qb,
                           const int32_t* qk, R* p0, R* p1, int32_t* p2,
                           int64_t i) {
  const int32_t q = qk[i];
  const int kind = q & 3;
  if (kind == kQNone) return;
  R v0 = 0, v1 = 0;
  int32_t v2 = 0;
  if (kind == kQFtab) {
    const int64_t li = (int64_t)qa[i] - s.ftab_base;
    if (li >= 0 && li < s.nftab_per) {
      v0 = s.ftab_tb[2 * li];
      v1 = s.ftab_tb[2 * li + 1];
    }
  } else {
    const int c = q >> 2;
    const R t = qa[i];
    const uint32_t* row = shard_row<R>(s, t);
    if (row != nullptr) {
      v0 = rank_in_row<R>(row, s.zoff, t, c);
      if (kind == kQOne) v2 = bwt_in_row<R>(row, t);
    }
    if (kind == kQRange) {
      const R b = qb[i];
      row = shard_row<R>(s, b);
      if (row != nullptr) v1 = rank_in_row<R>(row, s.zoff, b, c);
    }
  }
  p0[i] = v0;
  p1[i] = v1;
  p2[i] = v2;
}

template <typename R>
struct ShardSearchArgs {
  const uint8_t* reads;  // [L, row_bytes]: reversed codes, 2 per byte
  int64_t row_bytes;
  const int32_t* lengths;
  const int32_t* start;
  const R* fchr;
  R zoff;
  // lane state
  int32_t* cur;
  int32_t* dep;
  int32_t* phase;
  R* top;
  R* bot;
  // the lane's query, and the partials [n_fm, L] that answer it
  R* qa;
  R* qb;
  int32_t* qk;
  const R* p0;
  const R* p1;
  const int32_t* p2;
  int32_t n_fm;
  int64_t L;
  // outputs, as SearchArgs
  R* h_top;
  R* h_bot;
  int32_t* h_off;
  int32_t* h_len;
  int32_t* nhits;
  int32_t* sums;
  int32_t mh;
  int32_t min_hitlen;
  int32_t increment;
  int32_t first_hit_only;
};

// search_lane's emit and driver policy, on a lane's local state
template <typename R>
FM_HD void shard_emit(const ShardSearchArgs<R>& a, int64_t i, int n,
                      int& cur, int& phase, int& nh, int& sum, R e_top,
                      R e_bot, int e_len, int e_cur) {
  const int slot = nh < a.mh ? nh : a.mh - 1;
  const int64_t k = i * a.mh + slot;
  a.h_top[k] = e_top;
  a.h_bot[k] = e_bot;
  a.h_off[k] = cur;
  a.h_len[k] = e_len;
  ++nh;
  if (e_len >= a.min_hitlen) sum += e_len;
  const int next = e_len > a.increment ? e_cur + 1 : e_cur;
  if (a.first_hit_only || e_cur >= n || next + a.min_hitlen >= n) {
    phase = kDone;
  } else {
    cur = next;
    phase = kStart;
  }
}

// One advance of lane i: on the first step, the lane's start (hit slots
// unused, cursor at start); after that, the transition its query asked
// for, from the partials summed over the shards. Then the table-free
// transitions of search_lane (a start too short for the ftab or with an
// N in its window, an extension past the read's end or into an N, a
// one-row range at the '$' row) until the lane needs a table read, which
// it leaves as its query, or is done. Returns whether it left a query.
template <typename R>
FM_HD bool search_advance(const ShardSearchArgs<R>& a, int64_t i,
                          bool first) {
  const int n = a.lengths[i];
  int cur, dep, phase, nh, sum;
  R top, bot;
  if (first) {
    for (int s = 0; s < a.mh; ++s) {
      a.h_top[i * a.mh + s] = -1;
      a.h_bot[i * a.mh + s] = -1;
      a.h_off[i * a.mh + s] = 0;
      a.h_len[i * a.mh + s] = 0;
    }
    cur = a.start[i];
    dep = cur;
    phase = cur < n ? kStart : kDone;
    nh = sum = 0;
    top = bot = 0;
  } else {
    phase = a.phase[i];
    if (phase == kDone) return false;
    cur = a.cur[i];
    dep = a.dep[i];
    top = a.top[i];
    bot = a.bot[i];
    nh = a.nhits[i];
    sum = a.sums[i];
    R v0 = 0, v1 = 0;
    int32_t v2 = 0;
    for (int f = 0; f < a.n_fm; ++f) {
      v0 += a.p0[f * a.L + i];
      v1 += a.p1[f * a.L + i];
      v2 += a.p2[f * a.L + i];
    }
    const int32_t q = a.qk[i];
    if ((q & 3) == kQFtab) {
      if (v1 > v0) {
        top = v0;
        bot = v1;
        dep = cur + kFtabChars;
        phase = kExtend;
      } else {
        shard_emit<R>(a, i, n, cur, phase, nh, sum, (R)-1, (R)-1, kFtabChars,
                      cur + kFtabChars);
      }
    } else {
      const int c = q >> 2;
      const R t2 = a.fchr[c] + v0;
      const R b2 = (q & 3) == kQOne ? t2 + 1 : a.fchr[c] + v1;
      if (((q & 3) == kQOne && v2 != c) || b2 <= t2) {
        shard_emit<R>(a, i, n, cur, phase, nh, sum, top, bot, dep - cur,
                      dep);
      } else {
        top = t2;
        bot = b2;
        ++dep;
      }
    }
  }
  const uint8_t* rd = a.reads + i * a.row_bytes;
  int32_t q = kQNone;
  while (phase != kDone && q == kQNone) {
    if (phase == kStart) {
      const int left = n - cur;
      if (left < kFtabChars) {
        shard_emit<R>(a, i, n, cur, phase, nh, sum, (R)-1, (R)-1, left, n);
        continue;
      }
      int fn = kFtabChars;
      int64_t fi = 0;
      for (int j = 0; j < kFtabChars; ++j) {
        const int c = read_code(rd, cur + j);
        if (c > 3 && fn == kFtabChars) fn = j;
        fi |= (int64_t)(c > 3 ? 3 : c) << (2 * j);
      }
      if (fn < kFtabChars) {
        shard_emit<R>(a, i, n, cur, phase, nh, sum, (R)-1, (R)-1, fn + 1,
                      cur + fn + 1);
        continue;
      }
      a.qa[i] = (R)fi;
      q = kQFtab;
    } else {
      const int c = dep < n ? read_code(rd, dep) : 4;
      if (c > 3 || (bot - top == 1 && top == a.zoff)) {
        shard_emit<R>(a, i, n, cur, phase, nh, sum, top, bot, dep - cur,
                      dep);
        continue;
      }
      a.qa[i] = top;
      a.qb[i] = bot;
      q = (bot - top == 1 ? kQOne : kQRange) | (c << 2);
    }
  }
  a.qk[i] = q;
  a.cur[i] = cur;
  a.dep[i] = dep;
  a.phase[i] = phase;
  a.top[i] = top;
  a.bot[i] = bot;
  a.nhits[i] = nh;
  a.sums[i] = sum;
  return q != kQNone;
}

// Shard s's partials of a walking row q[i] (q < 0: the row is done): the
// owner of its block computes the whole LF successor (it holds both the
// BWT char and the rank), the owner of its sample index reads the sample
// of a sampled row; no owner, as for an index past the table, gives 0.
template <typename R>
FM_HD void resolve_partials(const Shard<R>& s, const R* q, R* p0, int32_t* p1,
                            int64_t i) {
  const R r = q[i];
  if (r < 0) return;
  R v0 = 0;
  int32_t v1 = 0;
  const uint32_t* row = shard_row<R>(s, r);
  if (row != nullptr) {
    const int c = bwt_in_row<R>(row, r);
    v0 = s.fchr[c] + rank_in_row<R>(row, s.zoff, r, c);
  }
  if ((r & (((R)1 << s.offrate) - 1)) == 0) {
    const int64_t li = (int64_t)(r >> s.offrate) - s.offs_base;
    if (li >= 0 && li < s.noffs_per) v1 = s.offs[li];
  }
  p0[i] = v0;
  p1[i] = v1;
}

constexpr int32_t kWalking = -2;  // tidx of a row still walking

template <typename R>
struct ShardResolveArgs {
  R zoff;
  const R* brows;  // [nb] sorted genome-boundary rows (replicated)
  const int32_t* brefs;
  int64_t nb;
  int32_t offrate;
  int32_t narrow;  // npat <= 0xFFFF: boundary refs masked to 16 bits
  R* q;            // [N] the walking rows; -1 once done
  int32_t* tidx;   // [N] results; kWalking while walking
  const R* p0;     // [n_fm, N] partials
  const int32_t* p1;
  int32_t n_fm;
  int64_t N;
};

// Step `step` of row i: the exits of its row (_sharded_try_offset) with
// the sample summed over the shards; a row with no exit after `budget`
// LF steps gives -1, else it moves to its LF successor. Returns whether
// the row walks on.
template <typename R>
FM_HD bool resolve_advance(const ShardResolveArgs<R>& a, int64_t i,
                           int64_t step, int64_t budget) {
  if (step > 0 && a.tidx[i] != kWalking) return false;
  const R r = a.q[i];
  R v0 = 0;
  int32_t v1 = 0;
  for (int f = 0; f < a.n_fm; ++f) {
    v0 += a.p0[f * a.N + i];
    v1 += a.p1[f * a.N + i];
  }
  const bool sampled = (r & (((R)1 << a.offrate) - 1)) == 0;
  const int32_t t =
      row_exit<R>(r, a.zoff, sampled, v1, a.brows, a.brefs, a.nb, a.narrow);
  if (t >= 0 || step >= budget) {
    a.tidx[i] = t;
    a.q[i] = -1;
    return false;
  }
  a.tidx[i] = kWalking;
  a.q[i] = v0;
  return true;
}

}  // namespace fm
