// Native host-side assignment engine.
//
// Ports the per-read classification tail from classify/algo.py (which
// itself mirrors the reference classifier.h / aln_sink.h semantics) to
// C++: strand-state assembly, cross-strand extension/dedup/trim,
// candidate scoring, taxonomy-tree reduction to <= k labels, and result
// selection with the per-read LCG. The batched device interactions
// (extension re-searches, SA resolution) stay in Python/JAX via a phased
// protocol:
//
//   bh = batch_begin(...device hit arrays, unit structure...)
//   loop: n = batch_extension_misses(bh, out...)   // 0 => fixpoint done
//         batch_extension_feed(bh, device results)
//   n = batch_resolve_requests(bh, out tops/nelts)
//   batch_set_resolutions(bh, values)
//   n = batch_finalize(bh, ...output arrays...)    // + per-unit select
//
// Reference file:line markers below match the ones in algo.py.
//
// Build: g++ -O2 -shared -fPIC assign.cpp -o _assign.so (native/engine.py)

#include <algorithm>
#include <array>
#include <cstdint>
#include <thread>
#include <cstring>
#include <map>
#include <unordered_map>
#include <unordered_set>
#include <vector>

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i32 = int32_t;
using i64 = int64_t;

static const u64 OFF_MASK = ~0ULL;
static const int MAX_POS = 64;   // positions kept per candidate (kmer use only)

// ---------------------------------------------------------------- structures

struct PartialHit {
    u64 top, bot, bwoff, length;
    u64 size() const {
        if (top == OFF_MASK || bot <= top) return 0;
        return bot - top;
    }
    void reset() { top = bot = 0; bwoff = OFF_MASK; length = 0; }
};

struct TreeNode { u64 parent; u16 rank; u8 leaf; };

// Species-metrics accumulator state (mirrors classify/pipeline.py
// SpeciesMetrics / reference aln_sink.h:56-507, including the cur_ids
// carry-over across reads). Lives in the Ctx so the flat row path can
// update it without a Python round trip; drained via spm_export.
struct SpmCounts {
    i64 n_reads = 0, sum_score = 0;
    double summed_hit_len = 0.0, weighted = 0.0;
    i64 n_unique = 0;
};

struct Ctx {
    std::vector<u64> uid_tid;
    std::unordered_map<u64, std::array<u64, 10>> paths;
    std::unordered_map<u64, TreeNode> tree;
    std::unordered_set<u64> host, excl;
    i64 khits, min_hitlen, ihits, class_rank_slot;
    bool tree_traverse;
    i64 increment;
    // string tables for native row formatting (ctx_set_strings)
    std::vector<char> uid_blob;
    std::vector<i64> uid_off;       // n_uids + 1
    std::vector<char> rank_blob;
    std::vector<i64> rank_off;      // n_ranks + 1
    // species metrics (flat row path)
    std::unordered_map<u64, SpmCounts> spm_counts;
    std::map<std::vector<u64>, u64> spm_observed;
    std::vector<u64> spm_cur;
};

static void spm_add(Ctx* c, u64 tid, i64 score, i64 max_score, double slen,
                    i64 nres) {
    SpmCounts& sc = c->spm_counts[tid];
    sc.n_reads++;
    sc.sum_score++;             // the reference adds 1 (aln_sink.h:151)
    sc.weighted += 1.0 / (double)nres;
    sc.summed_hit_len += slen;
    if (nres == 1) sc.n_unique++;
    if (score >= max_score) {
        c->spm_cur.push_back(tid);
        if ((i64)c->spm_cur.size() == nres) {
            std::vector<u64> key = c->spm_cur;
            std::sort(key.begin(), key.end());
            c->spm_observed[key]++;
            c->spm_cur.clear();
        }
    }
}

struct HitCount {
    u64 unique_id, tax_id;
    int count = 0;
    i64 score = 0;
    i64 scores[2][2] = {{0, 0}, {0, 0}};
    double summed_len = 0.0;
    double summed_lens[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    i64 timestamp = 0;
    std::vector<std::pair<u32, u32>> positions;
    bool leaf = true;
    int num_leaves = 1;
    i64 rank = 0;
    const u64* path = nullptr;   // 10 slots or null
    i64 path_len = 0;

    void finalize(bool paired) {
        if (paired) {
            score = std::max(scores[0][0], scores[0][1])
                  + std::max(scores[1][0], scores[1][1]);
            summed_len = std::max(summed_lens[0][0], summed_lens[0][1])
                       + std::max(summed_lens[1][0], summed_lens[1][1]);
        } else {
            score = std::max(scores[0][0], scores[0][1]);
            summed_len = std::max(summed_lens[0][0], summed_lens[0][1]);
        }
    }
};

struct MateStates {
    std::vector<PartialHit> hits[2];  // per strand
    i64 sums[2] = {0, 0};
    i64 rdlen = 0;
};

struct MissKey {
    i32 unit, mate, strand, offset;
    bool operator==(const MissKey& o) const {
        return unit == o.unit && mate == o.mate && strand == o.strand
            && offset == o.offset;
    }
};
struct MissKeyHash {
    size_t operator()(const MissKey& k) const {
        return ((size_t)k.unit * 1000003u) ^ ((size_t)k.mate << 20)
             ^ ((size_t)k.strand << 22) ^ ((size_t)k.offset << 1);
    }
};

struct Batch {
    Ctx* ctx;
    i64 n_units;
    std::vector<MateStates> pristine;     // n_units*2 (mate slot 1 may be unused)
    std::vector<MateStates> finals;       // filled by the extension fixpoint
    std::vector<i32> n_mates;             // per unit
    std::vector<u8> paired;               // per unit
    std::vector<u8> done_ext;             // per unit
    std::vector<u32> seeds;               // per unit
    std::unordered_map<MissKey, PartialHit, MissKeyHash> cache;
    std::vector<MissKey> last_misses;     // in feed order
    // resolution
    std::vector<u64> req_top;
    std::vector<u64> req_nelt;
    std::vector<u64> unit_vpos;           // per-unit offset into values
    std::vector<i32> values;              // flat, request order
};

// --------------------------------------------------------- small primitives

// classifier.h:898-941
static void choose_strand(const MateStates& ms, i64 min_hitlen,
                          int* start, int* end) {
    i64 score[2] = {0, 0}, maxlen[2] = {0, 0};
    for (int fwi = 0; fwi < 2; fwi++) {
        for (const auto& h : ms.hits[fwi]) {
            if (h.length < (u64)min_hitlen) continue;
            score[fwi] += (i64)(h.length - 15) * (i64)(h.length - 15);
            if ((i64)h.length > maxlen[fwi]) maxlen[fwi] = (i64)h.length;
        }
    }
    int fwi;
    if (score[0] != score[1]) fwi = score[0] > score[1] ? 0 : 1;
    else if (maxlen[0] != maxlen[1]) fwi = maxlen[0] > maxlen[1] ? 0 : 1;
    else { *start = 0; *end = 2; return; }
    *start = fwi; *end = fwi + 1;
}

// compareBWTHits (classifier.h:1058-1086); strict-weak "less"
static bool hit_less(const PartialHit& a, const PartialHit& b) {
    u64 asz = a.size(), bsz = b.size();
    if (a.length >= 22 || b.length >= 22) {
        if (a.length >= 22 && b.length >= 22) {
            if (asz < bsz) return true;
            if (asz > bsz) return false;
        }
        if (b.length < a.length) return true;
        if (b.length > a.length) return false;
    }
    if (b.length * asz < a.length * bsz) return true;
    if (b.length * asz > a.length * bsz) return false;
    if (asz < bsz) return true;
    if (asz > bsz) return false;
    if (b.length < a.length) return true;
    return false;
}

// random_source.h:52-61
struct LCG {
    u32 last;
    explicit LCG(u32 seed) : last(seed) {}
    u32 next_u32() {
        last = 1664525u * last + 1013904223u;
        u32 ret = last >> 16;
        last = 1664525u * last + 1013904223u;
        return ret ^ last;
    }
};

// ------------------------------------------------- extension / dedup / trim

// classifier.h:789-895; returns false if a needed search is uncached
// (appending its key to `misses`)
static bool extend_and_filter(Batch* b, i32 unit, i32 mate,
                              MateStates& ms, i64 min_hitlen, i64 ihits,
                              std::vector<MissKey>* misses) {
    auto& hits_fw = ms.hits[0];
    auto& hits_rc = ms.hits[1];
    i64 rdlen = ms.rdlen;
    bool ok = true;
    auto lookup = [&](i32 strand, i32 off, PartialHit* out) -> bool {
        MissKey k{unit, mate, strand, off};
        auto it = b->cache.find(k);
        if (it == b->cache.end()) {
            misses->push_back(k);
            ok = false;
            return false;
        }
        *out = it->second;
        return true;
    };
    if (ms.sums[0] >= min_hitlen && ms.sums[1] >= min_hitlen) {
        for (auto& hit : hits_fw) {
            u64 length = hit.length;
            i64 l = (i64)hit.bwoff;
            i64 r = (i64)(hit.bwoff + length);
            for (auto& rchit : hits_rc) {
                u64 rclen = rchit.length;
                if (length < (u64)min_hitlen && rclen < (u64)min_hitlen)
                    continue;
                i64 rc_l = rdlen - (i64)rchit.bwoff - (i64)rchit.length;
                i64 rc_r = rc_l + (i64)rclen;
                if (r <= rc_l || rc_r <= l) continue;
                if (l == rc_l && r == rc_r) continue;
                if ((l < rc_l && r > rc_r) || (l > rc_l && r < rc_r)) continue;
                if (l > rc_l) {
                    PartialHit tmp;
                    if (lookup(0, (i32)rc_l, &tmp)) {
                        if (tmp.length == length + (u64)(l - rc_l)) {
                            hit.top = tmp.top; hit.bot = tmp.bot;
                            hit.bwoff = tmp.bwoff; hit.length = tmp.length;
                        }
                    }
                }
                if (r > rc_r) {
                    PartialHit tmp;
                    if (lookup(1, (i32)(rdlen - r), &tmp)) {
                        if (tmp.length == rclen + (u64)(r - rc_r)) {
                            rchit.top = tmp.top; rchit.bot = tmp.bot;
                            rchit.bwoff = tmp.bwoff; rchit.length = tmp.length;
                        }
                    }
                }
                // stale l/r/length kept for the rest of the inner loop
                // (classifier.h:793-846)
            }
        }
        if (!ok) return false;
        // over-mapped identical-span dedup
        for (auto& hit : hits_fw) {
            u64 length = hit.length;
            i64 l = (i64)hit.bwoff;
            i64 r = (i64)(hit.bwoff + length);
            for (auto& rchit : hits_rc) {
                u64 rclen = rchit.length;
                i64 rc_l = rdlen - (i64)rchit.bwoff - (i64)rchit.length;
                i64 rc_r = rc_l + (i64)rclen;
                if (rc_l < l) break;
                if (length != rclen) continue;
                if (l == rc_l && r == rc_r
                        && hit.size() + rchit.size() > (u64)ihits) {
                    hit.reset();
                    rchit.reset();
                    break;
                }
            }
        }
    }
    if (!ok) return false;
    // intra-strand overlap trim (classifier.h:873-895)
    for (int s = 0; s < 2; s++) {
        auto& hits = ms.hits[s];
        if (hits.size() < 2) continue;
        for (size_t i = 0; i + 1 < hits.size(); i++) {
            auto& hit = hits[i];
            for (size_t j = i + 1; j < hits.size(); j++) {
                auto& hit2 = hits[j];
                if (hit.bwoff >= hit2.bwoff) { hit.length = 0; break; }
                if (hit.bwoff + hit.length <= hit2.bwoff) break;
                if (hit.length >= hit2.length) {
                    u64 hit2_end = hit2.bwoff + hit2.length;
                    hit2.bwoff = hit.bwoff + hit.length;
                    hit2.length = hit2_end - hit2.bwoff;  // u64 wrap kept
                } else {
                    hit.length = hit2.bwoff - hit.bwoff;
                }
            }
        }
    }
    return true;
}

// --------------------------------------------------------------- hit map ops

// classifier.h:982-1050
static void add_hit(Ctx* ctx, std::vector<HitCount>& hit_map, int rdi,
                    int fwi, u64 unique_id, u64 tax_id, i64 ts, i64 score,
                    double weight, u64 offset, u64 length) {
    const u64* path = nullptr;
    i64 path_len = 0;
    auto pit = ctx->paths.find(tax_id);
    if (pit != ctx->paths.end()) { path = pit->second.data(); path_len = 10; }
    i64 rank = ctx->class_rank_slot;
    if (rank > 0) {
        i64 r = rank;
        bool found = false;
        for (; r < path_len; r++) {
            if (path[r] != 0) { tax_id = path[r]; rank = r; found = true; break; }
        }
        if (!found && path_len > 0) rank = r;
    }
    for (auto& hc : hit_map) {
        bool same = (rank == 0) ? (unique_id == hc.unique_id)
                                : (tax_id == hc.tax_id);
        if (same) {
            if (hc.timestamp != ts) {
                hc.count += 1;
                hc.scores[rdi][fwi] += score;
                hc.summed_lens[rdi][fwi] += weight;
                hc.timestamp = ts;
                if ((int)hc.positions.size() < MAX_POS)
                    hc.positions.emplace_back((u32)offset, (u32)length);
            }
            return;
        }
    }
    HitCount hc;
    hc.unique_id = unique_id;
    hc.tax_id = tax_id;
    hc.count = 1;
    hc.scores[rdi][fwi] = score;
    hc.summed_lens[rdi][fwi] = weight;
    hc.timestamp = ts;
    hc.positions.emplace_back((u32)offset, (u32)length);
    hc.path = path;
    hc.path_len = path_len;
    hc.rank = rank;
    hit_map.push_back(std::move(hc));
}

// classifier.h:399-515
static bool reduce(Ctx* ctx, std::vector<HitCount>& hit_map) {
    i64 best = 0;
    for (auto& hc : hit_map) best = std::max(best, hc.score);
    size_t i = 0;
    while (i < hit_map.size()) {
        if (hit_map[i].score < best) {
            if (i + 1 < hit_map.size())
                hit_map[i] = std::move(hit_map.back());
            hit_map.pop_back();
        } else {
            i++;
        }
    }
    if (!ctx->tree_traverse)
        return hit_map.size() <= (size_t)ctx->khits;

    const i64 RANK_MAX_U8 = 255;
    i64 rank = 0;
    while (hit_map.size() > (size_t)ctx->khits) {
        std::vector<std::pair<i64, u64>> tax_count;  // (count, parent)
        for (auto& hc : hit_map) {
            while (hc.rank < rank) {
                if (hc.rank + 1 >= hc.path_len) { hc.rank = RANK_MAX_U8; break; }
                hc.rank += 1;
                hc.tax_id = hc.path[hc.rank];
                hc.leaf = false;
            }
            if (hc.rank > rank) continue;
            u64 parent = (rank + 1 < hc.path_len) ? hc.path[rank + 1] : 1;
            if (parent == 0) continue;
            bool found = false;
            for (auto& tc : tax_count) {
                if (tc.second == parent) { tc.first += 1; found = true; break; }
            }
            if (!found) tax_count.emplace_back(1, parent);
        }
        if (tax_count.empty()) {
            if (rank < hit_map[0].path_len) { rank += 1; continue; }
            break;
        }
        std::sort(tax_count.begin(), tax_count.end());
        for (auto it = tax_count.rbegin(); it != tax_count.rend(); ++it) {
            u64 parent = it->second;
            for (auto& hc : hit_map) {
                if (hc.rank != rank) continue;
                u64 cur_parent = (rank + 1 < hc.path_len) ? hc.path[rank + 1] : 1;
                if (parent == cur_parent) {
                    hc.unique_id = OFF_MASK;
                    hc.rank = rank + 1;
                    hc.tax_id = parent;
                    hc.leaf = false;
                }
            }
            bool first = true;
            HitCount* rep = nullptr;
            size_t k = 0;
            while (k < hit_map.size()) {
                auto& hc = hit_map[k];
                if (parent == hc.tax_id) {
                    if (!first) {
                        rep->num_leaves += hc.num_leaves;
                        if (k + 1 < hit_map.size())
                            hit_map[k] = std::move(hit_map.back());
                        hit_map.pop_back();
                        continue;
                    }
                    first = false;
                    rep = &hc;
                }
                k++;
            }
            if (hit_map.size() <= (size_t)ctx->khits) break;
        }
        rank += 1;
        if (rank > hit_map[0].path_len) break;
    }
    return true;
}

// --------------------------------------------------------------- public API

// A batch's per-lane hits unpacked into its pristine mate states:
// lane_hits(li, ms, s) fills mate state ms's strand s from lane li.
template <typename LaneHits>
static Batch* begin_batch(Ctx* ctx, i64 n_lanes, const i32* lane_unit,
                          const i32* lane_mate, const i32* lane_strand,
                          i64 n_units, const i32* unit_n_mates,
                          const i32* mate_len, const u8* unit_paired,
                          const u32* unit_seeds, const LaneHits& lane_hits) {
    Batch* b = new Batch();
    b->ctx = ctx;
    b->n_units = n_units;
    b->pristine.resize(n_units * 2);
    b->n_mates.assign(unit_n_mates, unit_n_mates + n_units);
    b->paired.assign(unit_paired, unit_paired + n_units);
    b->seeds.assign(unit_seeds, unit_seeds + n_units);
    b->done_ext.assign(n_units, 0);
    for (i64 u = 0; u < n_units; u++)
        for (int m = 0; m < 2; m++)
            b->pristine[u * 2 + m].rdlen = mate_len[u * 2 + m];
    // lanes are disjoint (unit, mate, strand) slots, so the unpack
    // threads over lane ranges safely
    auto unpack = [&](i64 lo, i64 hi) {
        for (i64 li = lo; li < hi; li++) {
            i32 u = lane_unit[li], m = lane_mate[li];
            lane_hits(li, b->pristine[(i64)u * 2 + m], lane_strand[li]);
        }
    };
    int nt = (int)std::min<i64>(
        std::max(1u, std::thread::hardware_concurrency()), 8);
    if (n_lanes < 4096) nt = 1;
    if (nt == 1) {
        unpack(0, n_lanes);
    } else {
        std::vector<std::thread> ths;
        i64 chunk = (n_lanes + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            i64 lo = t * chunk, hi = std::min<i64>(n_lanes, lo + chunk);
            if (lo >= hi) break;
            ths.emplace_back(unpack, lo, hi);
        }
        for (auto& th : ths) th.join();
    }
    // finals need no seed copy: the fixpoint always assigns each used
    // (unit, mate) slot from a fresh pristine clone before any reader
    // (resolve_requests / finalize) runs; untouched slots (n_mates==0 or
    // the absent mate) read as empty either way
    b->finals.resize(n_units * 2);
    return b;
}

static PartialHit partial_hit(i64 t, i64 bo, u32 off, u32 len) {
    PartialHit h;
    h.top = t < 0 ? OFF_MASK : (u64)t;
    h.bot = bo < 0 ? OFF_MASK : (u64)bo;
    h.bwoff = off;
    h.length = len;
    return h;
}

extern "C" {

void* ctx_create(const u64* uid_tids, i64 n_uids,
                 const u64* path_tids, const u64* paths10, i64 n_paths,
                 const u64* tree_tids, const u64* tree_parents,
                 const u16* tree_ranks, const u8* tree_leaf, i64 n_tree,
                 const u64* host, i64 n_host, const u64* excl, i64 n_excl,
                 i64 khits, i64 min_hitlen, i64 ihits, i64 class_rank_slot,
                 i64 tree_traverse) {
    Ctx* c = new Ctx();
    c->uid_tid.assign(uid_tids, uid_tids + n_uids);
    for (i64 i = 0; i < n_paths; i++) {
        std::array<u64, 10> p;
        std::memcpy(p.data(), paths10 + i * 10, 10 * sizeof(u64));
        c->paths.emplace(path_tids[i], p);
    }
    for (i64 i = 0; i < n_tree; i++)
        c->tree[tree_tids[i]] = TreeNode{tree_parents[i], tree_ranks[i],
                                         tree_leaf[i]};
    c->host.insert(host, host + n_host);
    c->excl.insert(excl, excl + n_excl);
    c->khits = khits;
    c->min_hitlen = min_hitlen;
    c->ihits = ihits;
    c->class_rank_slot = class_rank_slot;
    c->tree_traverse = tree_traverse != 0;
    return c;
}

void ctx_free(void* p) { delete (Ctx*)p; }

// The padded search outputs: lane li's hits in slots [li * max_hits, ...).
void* batch_begin(void* cp,
                  const i64* h_top, const i64* h_bot, const i32* h_off,
                  const i32* h_len, const i32* nhits, const i32* sums,
                  i64 n_lanes, i64 max_hits,
                  const i32* lane_unit, const i32* lane_mate,
                  const i32* lane_strand,
                  i64 n_units, const i32* unit_n_mates,
                  const i32* mate_len,            /* n_units*2 */
                  const u8* unit_paired, const u32* unit_seeds) {
    return begin_batch(
        (Ctx*)cp, n_lanes, lane_unit, lane_mate, lane_strand, n_units,
        unit_n_mates, mate_len, unit_paired, unit_seeds,
        [&](i64 li, MateStates& ms, i32 s) {
            ms.sums[s] = sums[li];
            i64 k = nhits[li];
            if (k > max_hits) k = max_hits;
            auto& hits = ms.hits[s];
            hits.reserve(k);
            for (i64 j = 0; j < k; j++) {
                i64 base = li * max_hits + j;
                hits.push_back(partial_hit(h_top[base], h_bot[base],
                                           (u32)h_off[base],
                                           (u32)h_len[base]));
            }
        });
}

// The pool form (classify/engine.py HitPool): lane li's min(nhits,
// max_hits) hits are the records [base[li], ...) of {top, bot,
// off << 16 | len}, and tail[li] is nhits << 16 | sums.
void* batch_begin_pool(void* cp, const i32* records, const i32* base,
                       const i32* tail, i64 n_lanes, i64 max_hits,
                       const i32* lane_unit, const i32* lane_mate,
                       const i32* lane_strand,
                       i64 n_units, const i32* unit_n_mates,
                       const i32* mate_len,       /* n_units*2 */
                       const u8* unit_paired, const u32* unit_seeds) {
    return begin_batch(
        (Ctx*)cp, n_lanes, lane_unit, lane_mate, lane_strand, n_units,
        unit_n_mates, mate_len, unit_paired, unit_seeds,
        [&](i64 li, MateStates& ms, i32 s) {
            const u32 t = (u32)tail[li];
            ms.sums[s] = (i32)(t & 0xFFFF);
            i64 k = t >> 16;
            if (k > max_hits) k = max_hits;
            auto& hits = ms.hits[s];
            hits.reserve(k);
            const i32* rec = records + 3 * (i64)base[li];
            for (i64 j = 0; j < k; j++, rec += 3) {
                const u32 ol = (u32)rec[2];
                hits.push_back(partial_hit(rec[0], rec[1], ol >> 16,
                                           ol & 0xFFFF));
            }
        });
}

void batch_free(void* bp) { delete (Batch*)bp; }

// One fixpoint round: retry pending units against the cache; report the
// new misses. Returns the miss count (0 => all units final).
i64 batch_extension_misses(void* bp, i32* out_unit, i32* out_mate,
                           i32* out_strand, i32* out_offset, i64 cap) {
    Batch* b = (Batch*)bp;
    Ctx* ctx = b->ctx;
    std::vector<MissKey> misses;
    std::unordered_set<u64> seen;
    for (i64 u = 0; u < b->n_units; u++) {
        if (b->done_ext[u]) continue;
        bool unit_ok = true;
        for (int m = 0; m < b->n_mates[u]; m++) {
            MateStates ms = b->pristine[u * 2 + m];  // fresh clone
            std::vector<MissKey> local;
            if (extend_and_filter(b, (i32)u, (i32)m, ms, ctx->min_hitlen,
                                  ctx->ihits, &local)) {
                b->finals[u * 2 + m] = std::move(ms);
            } else {
                unit_ok = false;
                for (auto& k : local) {
                    u64 key = ((u64)(u32)k.unit << 34) | ((u64)k.mate << 33)
                            | ((u64)k.strand << 32) | (u64)(u32)k.offset;
                    if (seen.insert(key).second) misses.push_back(k);
                }
            }
        }
        if (unit_ok) b->done_ext[u] = 1;
    }
    i64 n = (i64)misses.size();
    if (n > cap) n = cap;
    for (i64 i = 0; i < n; i++) {
        out_unit[i] = misses[i].unit;
        out_mate[i] = misses[i].mate;
        out_strand[i] = misses[i].strand;
        out_offset[i] = misses[i].offset;
    }
    b->last_misses.assign(misses.begin(), misses.begin() + n);
    return n;
}

void batch_extension_feed(void* bp, i64 n, const i64* tops, const i64* bots,
                          const i32* offs, const i32* lens) {
    Batch* b = (Batch*)bp;
    for (i64 i = 0; i < n; i++) {
        PartialHit h;
        h.top = tops[i] < 0 ? OFF_MASK : (u64)tops[i];
        h.bot = bots[i] < 0 ? OFF_MASK : (u64)bots[i];
        h.bwoff = (u64)(u32)offs[i];
        h.length = (u64)(u32)lens[i];
        b->cache[b->last_misses[i]] = h;
    }
}

// Light pass A: derive the SA-resolution request sequence
// (classifier.h:212-571 resolve_fn call order is value-independent).
i64 batch_resolve_requests(void* bp, u64* out_tops, u64* out_nelts, i64 cap) {
    Batch* b = (Batch*)bp;
    Ctx* ctx = b->ctx;
    b->req_top.clear();
    b->req_nelt.clear();
    b->unit_vpos.assign(b->n_units, 0);
    u64 vtotal = 0;
    for (i64 u = 0; u < b->n_units; u++) {
        b->unit_vpos[u] = vtotal;
        u64 mghs = (u64)ctx->khits;
        for (int m = 0; m < b->n_mates[u]; m++) {
            MateStates& ms = b->finals[u * 2 + m];
            int fw_start, fw_end;
            choose_strand(ms, ctx->min_hitlen, &fw_start, &fw_end);
            for (int fwi = fw_start; fwi < fw_end; fwi++) {
                auto shits = ms.hits[fwi];
                for (auto& h : shits)
                    if (h.length >= (u64)ctx->min_hitlen && h.size() > mghs)
                        mghs = h.size();
                if (mghs > (u64)ctx->khits) mghs += (u64)ctx->khits;
                std::stable_sort(shits.begin(), shits.end(), hit_less);
                u64 genome_hit_cnt = 0;
                for (auto& h : shits) {
                    if (h.length <= (u64)ctx->min_hitlen || h.size() == 0)
                        continue;
                    u64 nelt = std::min(h.size(), mghs);
                    b->req_top.push_back(h.top);
                    b->req_nelt.push_back(nelt);
                    vtotal += nelt;
                    if ((i64)nelt > ctx->ihits) continue;
                    genome_hit_cnt += nelt;
                    if (genome_hit_cnt >= mghs) break;
                }
            }
        }
    }
    i64 n = (i64)b->req_top.size();
    if (n > cap) n = cap;
    for (i64 i = 0; i < n; i++) {
        out_tops[i] = b->req_top[i];
        out_nelts[i] = b->req_nelt[i];
    }
    return (i64)b->req_top.size();
}

void batch_set_resolutions(void* bp, const i32* values, i64 n) {
    Batch* b = (Batch*)bp;
    b->values.assign(values, values + n);
}

// Per-unit reportable record (collected per thread, merged in order).
struct OutRec {
    i32 unit;
    i64 score, max_score, uid_idx;
    u64 tax_id;
    i32 tax_rank;
    double summed_len;
    u8 is_fw, leaf;
    std::vector<std::pair<u32, u32>> pos;
};

// The per-unit classification + selection body; appends to `out`.
static void finalize_unit(Batch* b, Ctx* ctx, i64 u, i64* unit_secbest,
                          std::vector<OutRec>& out) {
    size_t vpos = b->unit_vpos[u];
    {
        std::vector<HitCount> hit_map;
        u64 mghs = (u64)ctx->khits;
        i64 ts = 0;
        bool is_fw = false;
        bool paired = b->paired[u] != 0;
        for (int m = 0; m < b->n_mates[u]; m++) {
            MateStates& ms = b->finals[u * 2 + m];
            int fw_start, fw_end;
            choose_strand(ms, ctx->min_hitlen, &fw_start, &fw_end);
            for (int fwi = fw_start; fwi < fw_end; fwi++) {
                is_fw = (fwi == 0);
                auto shits = ms.hits[fwi];
                for (auto& h : shits)
                    if (h.length >= (u64)ctx->min_hitlen && h.size() > mghs)
                        mghs = h.size();
                if (mghs > (u64)ctx->khits) mghs += (u64)ctx->khits;
                std::stable_sort(shits.begin(), shits.end(), hit_less);
                u64 genome_hit_cnt = 0;
                for (auto& h : shits) {
                    i64 cur_ts = ts;
                    if (h.length <= (u64)ctx->min_hitlen || h.size() == 0) {
                        ts++;
                        continue;
                    }
                    u64 nelt = std::min(h.size(), mghs);
                    const i32* seq_ids = b->values.data() + vpos;
                    vpos += nelt;
                    if ((i64)nelt > ctx->ihits) { ts++; continue; }
                    genome_hit_cnt += nelt;
                    // dedupe by sequence id, first-seen order
                    std::vector<std::pair<u64, u64>> coord_ids;
                    std::unordered_set<i32> seen;
                    for (u64 k = 0; k < nelt; k++) {
                        i32 sid = seq_ids[k];
                        if (!seen.insert(sid).second) continue;
                        u64 tid = (sid >= 0 && (size_t)sid < ctx->uid_tid.size())
                                ? ctx->uid_tid[sid] : 0;
                        coord_ids.emplace_back((u64)(u32)sid, tid);
                    }
                    i64 score = (i64)(h.length - 15) * (i64)(h.length - 15);
                    double weight = (double)h.length;
                    for (auto& ci : coord_ids) {
                        if (ctx->excl.count(ci.second)) continue;
                        add_hit(ctx, hit_map, m, fwi, ci.first, ci.second,
                                cur_ts, score, weight, h.bwoff, h.length);
                    }
                    if (genome_hit_cnt >= mghs) break;
                    ts++;
                }
            }
        }
        for (auto& hc : hit_map) hc.finalize(paired);

        // host-taxid preference (classifier.h:384-394)
        i64 best_score = 0;
        bool only_host = false;
        for (auto& hc : hit_map) {
            if (hc.score > best_score) {
                best_score = hc.score;
                only_host = ctx->host.count(hc.tax_id) > 0;
            } else if (hc.score == best_score) {
                only_host = only_host || ctx->host.count(hc.tax_id) > 0;
            }
        }

        bool unclassified = false;
        if (!only_host && hit_map.size() > (size_t)ctx->khits) {
            if (!reduce(ctx, hit_map)) unclassified = true;
        }
        if (!only_host && hit_map.size() > (size_t)ctx->khits)
            unclassified = true;

        // collect reportable results
        struct Res {
            i64 score; u64 tax_id; i32 tax_rank; i64 uid_idx;
            double summed_len; u8 leaf;
            std::vector<std::pair<u32, u32>> pos;
        };
        std::vector<Res> results;
        if (!unclassified) {
            i64 rdlen = b->pristine[u * 2 + 0].rdlen;
            i64 max_score = rdlen > 15 ? (rdlen - 15) * (rdlen - 15) : 0;
            if (paired) {
                i64 rd2 = b->pristine[u * 2 + 1].rdlen;
                max_score += rd2 > 15 ? (rd2 - 15) * (rd2 - 15) : 0;
            }
            for (auto& hc : hit_map) {
                if (only_host && !ctx->host.count(hc.tax_id)) continue;
                i32 tax_rank = 0;
                u8 leaf = 1;
                auto it = ctx->tree.find(hc.tax_id);
                if (it != ctx->tree.end()) {
                    tax_rank = it->second.rank;
                    leaf = it->second.leaf;
                }
                Res r;
                r.score = hc.score;
                r.tax_id = hc.tax_id;
                r.tax_rank = tax_rank;
                r.uid_idx = hc.unique_id < ctx->uid_tid.size()
                          ? (i64)hc.unique_id : -1;
                r.summed_len = hc.summed_len;
                r.leaf = leaf;
                r.pos = hc.positions;
                results.push_back(std::move(r));
            }
            // selection (aln_sink.h:1860-1927) + secbest
            i64 sz = (i64)results.size();
            if (sz > 0) {
                i64 num = std::min(sz, ctx->khits);
                std::vector<std::pair<i64, i64>> buf;  // (score, idx)
                for (i64 i2 = 0; i2 < sz; i2++)
                    buf.emplace_back(results[i2].score, i2);
                std::sort(buf.begin(), buf.end());
                std::reverse(buf.begin(), buf.end());
                LCG rnd(b->seeds[u]);
                auto shuffle_portion = [&](i64 begin, i64 n2) {
                    if (n2 < 2) return;
                    i64 left = n2;
                    for (i64 i2 = begin; i2 < begin + n2 - 1; i2++) {
                        u32 r2 = rnd.next_u32() % (u32)left;
                        if (r2 > 0) std::swap(buf[i2], buf[i2 + r2]);
                        left--;
                    }
                };
                i64 streak = 0;
                for (i64 i2 = 1; i2 < sz; i2++) {
                    if (buf[i2].first == buf[i2 - 1].first) {
                        if (streak == 0) streak = 1;
                        streak++;
                    } else {
                        if (streak > 1) shuffle_portion(i2 - streak, streak);
                        streak = 0;
                    }
                }
                if (streak > 1) shuffle_portion(sz - streak, streak);
                std::vector<i64> select;
                for (i64 i2 = 0; i2 < num; i2++)
                    select.push_back(buf[i2].second);
                for (i64 i2 = 0; i2 + 1 < (i64)select.size(); i2++) {
                    if (buf[i2].first != buf[i2 + 1].first) {
                        select.resize(i2 + 1);
                        break;
                    }
                }
                // secbest over all results
                bool have_best = false, have_sec = false;
                i64 bestv = 0, secv = 0;
                for (auto& r : results) {
                    if (!have_best || r.score > bestv) {
                        if (have_best) { secv = bestv; have_sec = true; }
                        bestv = r.score; have_best = true;
                    } else if (!have_sec || r.score > secv) {
                        secv = r.score; have_sec = true;
                    }
                }
                unit_secbest[u] = have_sec ? secv : 0;
                for (i64 sel : select) {
                    Res& r = results[sel];
                    OutRec o;
                    o.unit = (i32)u;
                    o.score = r.score;
                    o.max_score = max_score;
                    o.tax_id = r.tax_id;
                    o.tax_rank = r.tax_rank;
                    o.uid_idx = r.uid_idx;
                    o.summed_len = r.summed_len;
                    o.is_fw = is_fw ? 1 : 0;
                    o.leaf = r.leaf;
                    o.pos = r.pos;
                    out.push_back(std::move(o));
                }
                return;
            }
        }
        unit_secbest[u] = 0;  // unclassified / no results
    }
}

// Full classification + per-unit selection, threaded over unit ranges
// (units are independent; values offsets precomputed per unit).
i64 batch_finalize(void* bp,
                   i32* res_unit, i64* res_score, i64* res_max_score,
                   u64* res_tax_id, i32* res_tax_rank, i64* res_uid_idx,
                   double* res_summed_len, u8* res_is_fw, u8* res_is_leaf,
                   i32* res_npos, u32* res_pos /* cap*MAX_POS*2 */,
                   i64* unit_secbest, i64 cap) {
    Batch* b = (Batch*)bp;
    Ctx* ctx = b->ctx;
    int nt = (int)std::min<i64>(
        std::max(1u, std::thread::hardware_concurrency()), 8);
    if (b->n_units < 256) nt = 1;
    std::vector<std::vector<OutRec>> outs(nt);
    i64 chunk = (b->n_units + nt - 1) / nt;
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) {
        ths.emplace_back([&, t]() {
            i64 lo = t * chunk, hi = std::min<i64>(b->n_units, lo + chunk);
            for (i64 u = lo; u < hi; u++)
                finalize_unit(b, ctx, u, unit_secbest, outs[t]);
        });
    }
    for (auto& th : ths) th.join();

    i64 out_n = 0;
    for (auto& v : outs) {
        for (auto& o : v) {
            if (out_n >= cap) return -1;  // caller buffer too small
            res_unit[out_n] = o.unit;
            res_score[out_n] = o.score;
            res_max_score[out_n] = o.max_score;
            res_tax_id[out_n] = o.tax_id;
            res_tax_rank[out_n] = o.tax_rank;
            res_uid_idx[out_n] = o.uid_idx;
            res_summed_len[out_n] = o.summed_len;
            res_is_fw[out_n] = o.is_fw;
            res_is_leaf[out_n] = o.leaf;
            i32 np = (i32)std::min((size_t)MAX_POS, o.pos.size());
            res_npos[out_n] = np;
            for (i32 p2 = 0; p2 < np; p2++) {
                res_pos[(out_n * MAX_POS + p2) * 2] = o.pos[p2].first;
                res_pos[(out_n * MAX_POS + p2) * 2 + 1] = o.pos[p2].second;
            }
            out_n++;
        }
    }
    return out_n;
}

// ------------------------------------------------ native row formatting

// String tables used by batch_finalize_rows: unique-id display names and
// taxonomy-rank display strings (both concatenated blobs + offsets).
void ctx_set_strings(void* cp, const char* uid_blob, const i64* uid_off,
                     i64 n_uids, const char* rank_blob, const i64* rank_off,
                     i64 n_ranks) {
    Ctx* c = (Ctx*)cp;
    c->uid_blob.assign(uid_blob, uid_blob + uid_off[n_uids]);
    c->uid_off.assign(uid_off, uid_off + n_uids + 1);
    c->rank_blob.assign(rank_blob, rank_blob + rank_off[n_ranks]);
    c->rank_off.assign(rank_off, rank_off + n_ranks + 1);
}

// Pre-seed the cur_ids carry-over (when a Python-path read left ids
// pending before the flat path takes over).
void spm_seed_cur(void* cp, const u64* ids, i64 n) {
    Ctx* c = (Ctx*)cp;
    c->spm_cur.assign(ids, ids + n);
}

// Import existing per-taxon count partials so native accumulation
// continues from them (keeps the float fields bit-exact when the emit
// path switches from Python to native mid-stream).
void spm_seed_counts(void* cp, const u64* tids, const i64* n_reads,
                     const i64* sum_score, const double* shl,
                     const double* weighted, const i64* n_unique, i64 n) {
    Ctx* c = (Ctx*)cp;
    for (i64 i = 0; i < n; i++) {
        SpmCounts& sc = c->spm_counts[tids[i]];
        sc.n_reads += n_reads[i];
        sc.sum_score += sum_score[i];
        sc.summed_hit_len += shl[i];
        sc.weighted += weighted[i];
        sc.n_unique += n_unique[i];
    }
}

// sizes[0]=n_count_entries sizes[1]=n_observed sizes[2]=total observed
// key ids, sizes[3]=len(cur_ids)
void spm_sizes(void* cp, i64* sizes) {
    Ctx* c = (Ctx*)cp;
    sizes[0] = (i64)c->spm_counts.size();
    sizes[1] = (i64)c->spm_observed.size();
    i64 tot = 0;
    for (auto& kv : c->spm_observed) tot += (i64)kv.first.size();
    sizes[2] = tot;
    sizes[3] = (i64)c->spm_cur.size();
}

// Drain the accumulated species metrics into flat arrays (sized via
// spm_sizes) and reset the native state.
void spm_export(void* cp, u64* tids, i64* n_reads, i64* sum_score,
                double* shl, double* weighted, i64* n_unique,
                i64* obs_klen, u64* obs_count, u64* obs_ids, u64* cur_ids) {
    Ctx* c = (Ctx*)cp;
    i64 i = 0;
    for (auto& kv : c->spm_counts) {
        tids[i] = kv.first;
        n_reads[i] = kv.second.n_reads;
        sum_score[i] = kv.second.sum_score;
        shl[i] = kv.second.summed_hit_len;
        weighted[i] = kv.second.weighted;
        n_unique[i] = kv.second.n_unique;
        i++;
    }
    i64 e = 0, idp = 0;
    for (auto& kv : c->spm_observed) {
        obs_klen[e] = (i64)kv.first.size();
        obs_count[e] = kv.second;
        for (u64 id : kv.first) obs_ids[idp++] = id;
        e++;
    }
    for (size_t k = 0; k < c->spm_cur.size(); k++) cur_ids[k] = c->spm_cur[k];
    c->spm_counts.clear();
    c->spm_observed.clear();
    c->spm_cur.clear();
}

void spm_reset(void* cp) {
    Ctx* c = (Ctx*)cp;
    c->spm_counts.clear();
    c->spm_observed.clear();
    c->spm_cur.clear();
}

// Per-read tie-break seed hash (pat.h:55-91): XOR-fold of seq codes
// (shift (i&15)*2), qual bytes (shift (i&3)*8) and the read name up to
// the first '/' (shift (i&3)*8), folded in 64-bit then truncated -- a
// seq code shifted past bit 31 drops out exactly as the oracle's
// int64-then-mask does. `base` is the config-seed-derived constant.
void gen_seeds(const u8* seqs, const i64* seq_off,
               const u8* quals, const i64* qual_off,
               const u8* names, const i64* name_off,
               i64 n, u64 base, u32* out) {
    int nth = (int)std::min<u64>(
        std::max(1u, std::thread::hardware_concurrency()), 8);
    i64 chunk = (n + nth - 1) / nth;
    std::vector<std::thread> ths;
    for (int t = 0; t < nth; t++) {
        i64 lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ths.emplace_back([=]() {
            for (i64 r = lo; r < hi; r++) {
                u64 acc = base;
                const u8* s = seqs + seq_off[r];
                i64 sl = seq_off[r + 1] - seq_off[r];
                for (i64 i = 0; i < sl; i++)
                    acc ^= (u64)s[i] << (((u64)i & 15) << 1);
                const u8* q = quals + qual_off[r];
                i64 ql = qual_off[r + 1] - qual_off[r];
                for (i64 i = 0; i < ql; i++)
                    acc ^= (u64)q[i] << (((u64)i & 3) << 3);
                const u8* nm = names + name_off[r];
                i64 nl = name_off[r + 1] - name_off[r];
                for (i64 i = 0; i < nl && nm[i] != '/'; i++)
                    acc ^= (u64)nm[i] << (((u64)i & 3) << 3);
                out[r] = (u32)acc;
            }
        });
    }
    for (auto& th : ths) th.join();
}

static inline char* put_u64(char* p, u64 v) {
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + (v % 10)); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

static inline char* put_i64(char* p, i64 v) {
    if (v < 0) { *p++ = '-'; return put_u64(p, (u64)(-v)); }
    return put_u64(p, (u64)v);
}

// taxIDs wider than 32 bits print as lo.hi (aln_sink.h:2236-2250)
static inline char* put_tid(char* p, u64 tid) {
    u64 lo = tid & 0xFFFFFFFFULL, hi = tid >> 32;
    p = put_u64(p, lo);
    if (hi > 0) { *p++ = '.'; p = put_u64(p, hi); }
    return p;
}

// Classification + selection + DEFAULT-COLUMN row formatting in one call
// (the hot path of _emit_rows_preselected + ResultFormatter fast paths).
// Rows land '\n'-separated in out; per-row species-metric updates go into
// the ctx spm state (drain with spm_export). Returns the total row count,
// or -1 when out_cap / cap_rows is too small.
//
// names/name_off: concatenated raw read names per unit (n_units+1 offs);
// qlen: the reported queryLength per unit (paired rows count filtered
// mates too, so it cannot be derived from the dispatched lanes).
i64 batch_finalize_rows(void* bp, const char* names, const i64* name_off,
                        const i32* qlen, char* out, i64 out_cap,
                        i64* unit_secbest, i32* unit_nres, i64* out_bytes) {
    Batch* b = (Batch*)bp;
    Ctx* ctx = b->ctx;
    int nt = (int)std::min<i64>(
        std::max(1u, std::thread::hardware_concurrency()), 8);
    if (b->n_units < 256) nt = 1;
    std::vector<std::vector<OutRec>> outs(nt);
    i64 chunk = (b->n_units + nt - 1) / nt;
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) {
        ths.emplace_back([&, t]() {
            i64 lo = t * chunk, hi = std::min<i64>(b->n_units, lo + chunk);
            for (i64 u = lo; u < hi; u++)
                finalize_unit(b, ctx, u, unit_secbest, outs[t]);
        });
    }
    for (auto& th : ths) th.join();

    // merged recs are unit-ascending (thread chunks are unit ranges and
    // finalize_unit appends selected results in order)
    char* p = out;
    char* end = out + out_cap;
    i64 total_rows = 0;
    size_t ti = 0, ri = 0;  // thread bucket, index within
    auto next_rec = [&]() -> OutRec* {
        while (ti < outs.size()) {
            if (ri < outs[ti].size()) return &outs[ti][ri];
            ti++; ri = 0;
        }
        return nullptr;
    };
    for (i64 u = 0; u < b->n_units; u++) {
        // stripped read id: drop a trailing /1,/2,/3 then stop at
        // whitespace (aln_sink.h:2202-2217 / pipeline.format_read_id)
        const char* nm = names + name_off[u];
        i64 nl = name_off[u + 1] - name_off[u];
        if (nl >= 2 && nm[nl - 2] == '/' &&
            (nm[nl - 1] == '1' || nm[nl - 1] == '2' || nm[nl - 1] == '3'))
            nl -= 2;
        i64 ne = 0;
        while (ne < nl) {
            char ch = nm[ne];
            if (ch == ' ' || ch == '\t' || ch == '\r' || ch == '\n' ||
                ch == '\v' || ch == '\f')
                break;
            ne++;
        }
        // count this unit's selected results
        size_t cti = ti, cri = ri;
        i64 nres = 0;
        while (cti < outs.size()) {
            if (cri < outs[cti].size()) {
                if (outs[cti][cri].unit != (i32)u) break;
                nres++; cri++;
            } else { cti++; cri = 0; }
        }
        unit_nres[u] = (i32)nres;
        if (nres == 0) {
            // rid\tunclassified\t0\t0\t0\t0\t{qlen}\t1
            if (end - p < ne + 64) return -1;
            std::memcpy(p, nm, ne); p += ne;
            std::memcpy(p, "\tunclassified\t0\t0\t0\t0\t", 22); p += 22;
            p = put_i64(p, qlen[u]);
            *p++ = '\t'; *p++ = '1'; *p++ = '\n';
            total_rows++;
            spm_add(ctx, 0, 0, 0, 0.0, 1);
            continue;
        }
        for (i64 k = 0; k < nres; k++) {
            OutRec* o = next_rec();
            ri++;
            // seqID: uid name when the taxon is a leaf, else the rank
            // string (ResultFormatter fast path)
            const char* sid;
            i64 sidn;
            bool use_uid = o->leaf && o->uid_idx >= 0 &&
                           (size_t)(o->uid_idx + 1) < ctx->uid_off.size();
            if (use_uid) {
                sid = ctx->uid_blob.data() + ctx->uid_off[o->uid_idx];
                sidn = ctx->uid_off[o->uid_idx + 1] - ctx->uid_off[o->uid_idx];
            } else {
                i64 r = o->tax_rank;
                if (r < 0 || r + 1 >= (i64)ctx->rank_off.size()) r = 0;
                sid = ctx->rank_blob.data() + ctx->rank_off[r];
                sidn = ctx->rank_off[r + 1] - ctx->rank_off[r];
            }
            if (end - p < ne + sidn + 160) return -1;
            std::memcpy(p, nm, ne); p += ne;
            *p++ = '\t';
            std::memcpy(p, sid, sidn); p += sidn;
            *p++ = '\t';
            p = put_tid(p, o->tax_id);
            *p++ = '\t';
            p = put_i64(p, o->score);
            *p++ = '\t';
            p = put_i64(p, unit_secbest[u]);
            *p++ = '\t';
            p = put_i64(p, (i64)o->summed_len);
            *p++ = '\t';
            p = put_i64(p, qlen[u]);
            *p++ = '\t';
            p = put_i64(p, nres);
            *p++ = '\n';
            total_rows++;
            spm_add(ctx, o->tax_id, o->score, o->max_score, o->summed_len,
                    nres);
        }
    }
    *out_bytes = p - out;
    return total_rows;
}

}  // extern "C"
