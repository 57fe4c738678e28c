"""Batched FM backward-search engine: K1 and its host wrapper.

Every lane is one (read, strand) pair; the greedy partial-hit scan of
each lane (hi_aligner.h partialSearch under the classifier driver
policy, classifier.h) runs to its end. On a CUDA device the scan is the
hand-written kernel csrc/search.cu, one thread per lane; on the CPU it
is `search_plain`, a lockstep PyTorch loop over all lanes that applies
the same per-lane transition, step by step. Both give the JAX package's
search outputs (classify/engine.py search_loop): per lane the hits in
emission order as [h_top, h_bot, h_off, h_len] (an empty hit has
top == bot == -1, unused slots hold (-1, -1, 0, 0)), the hit count and
the summed length of hits of at least min_hitlen.

K5, the presolve, predicts per mate the SA rows the classifier will ask
for, from the search's first-pass hit buffers, and compacts them into
PRESOLVE_ROWS_PER_MATE slots per mate; K3 (ops/fm_torch.resolve_rows)
resolves them on the same stream. On a CUDA device these are the
kernels csrc/presolve.cu and csrc/resolve.cu; on the CPU the plain
versions. Both give the JAX package's batched_search_presolve outputs.

The host wrapper (BatchSearchEngine) keeps the interface the pipeline
and native/engine.py call: search_async / search_fetch / search_collect,
search, search_first_hits, and the stats / dev_lock / lane_bucket_lo /
lmax_lo attributes.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from .. import _cuda
from ..ops.fm_torch import (RESOLVE_MAX_STEPS, DeviceFMIndex, resolve_rows,
                            resolve_rows_plain)
from ..ops.rank import bwt_at_plain, rank_plain, word_counts

FTAB_CHARS = 10
PRESOLVE_ROWS_PER_MATE = 4   # flat presolve slots per mate
PRESOLVE_MATES_PER_BLOCK = 32  # csrc/fm_common.cuh kPickMates
PRESOLVE_MAX_RK = 128          # kPickMaxRk: presolve_rk's largest


def _bucket(n: int, lo: int = 256) -> int:
    """Round up to a power of two (>= lo): batches of similar size share
    one lane count."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _bucket_len(n: int, lo: int = 32) -> int:
    """Read-length bucket: multiples of 32 up to 512, then powers of two."""
    m = max(n, lo)
    if m <= 512:
        return (m + 31) // 32 * 32
    return _bucket(m, lo=512)


def unpack_reads(packed: torch.Tensor) -> torch.Tensor:
    """[L, row_bytes] uint8, two base codes per byte (low nibble first)
    -> [L, 2 * row_bytes] int64 codes."""
    lo = (packed & 15).to(torch.int64)
    hi = (packed >> 4).to(torch.int64)
    return torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)


def ftab_entry_plain(rows: torch.Tensor, fi: torch.Tensor, wide: bool):
    """(top, bot) int64 of packed ftab entries fi (pack_ftab_rows)."""
    from ..ops.rank import u32
    fi = fi.to(torch.int64)
    if wide:
        data = rows[fi >> 3]
        q = (fi & 7) * 4
        w = [u32(data.gather(1, (q + k)[:, None])[:, 0]) for k in range(4)]
        return w[0] | (w[1] << 32), w[2] | (w[3] << 32)
    data = rows[fi >> 4]
    p = (fi & 15) * 2
    return (u32(data.gather(1, p[:, None])[:, 0]),
            u32(data.gather(1, (p + 1)[:, None])[:, 0]))


def _windows(codes: torch.Tensor):
    """Per position p of each lane: the 10- and 12-char ftab window
    integers at p (char at p+j in bits 2j, N clipped to 3), the offset
    of the first N among the next 10 chars (10 if none), and whether the
    next 12 chars hold an N."""
    L, P = codes.shape
    # int32 arithmetic (a 12-char window is 24 bits), int64 results
    i32 = dict(dtype=torch.int32, device=codes.device)
    full = torch.cat([codes.to(torch.int32), torch.zeros((L, 12), **i32)],
                     dim=1)
    cl = full.clamp(max=3)
    isn = full > 3
    fi12 = torch.zeros((L, P), **i32)
    first_n = torch.full((L, P), FTAB_CHARS, **i32)
    for j in range(11, -1, -1):
        fi12 |= cl[:, j: j + P] << (2 * j)
        if j < FTAB_CHARS:
            first_n.masked_fill_(isn[:, j: j + P], j)
    n12 = isn[:, 0:P].clone()
    for j in range(1, 12):
        n12 |= isn[:, j: j + P]
    fi12 = fi12.to(torch.int64)
    return fi12 & 0xFFFFF, fi12, first_n.to(torch.int64), n12


def _note(stats: dict, **parts: torch.Tensor) -> None:
    for k, v in parts.items():
        stats.setdefault(k, []).append(v)


class TableReads:
    """The search's table reads on one index, in plain PyTorch: the rank
    and BWT char of global rows, the depth-10 and depth-12 ftab entries.
    int64 results. parallel/sharded.py has the same reads over BWT-range
    shards."""

    def __init__(self, fm: DeviceFMIndex):
        self.fm = fm
        self.zoff = int(fm.zoff)
        self.fchr = fm.fchr.to(torch.int64)
        self.row_dtype = fm.row_dtype
        self.deep = fm.ftab12_rows is not None
        self.counts = word_counts(fm.blocks)

    def rank(self, rows: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
        return rank_plain(self.fm.blocks, self.zoff, rows, chars, self.counts)

    def bwt(self, rows: torch.Tensor) -> torch.Tensor:
        return bwt_at_plain(self.fm.blocks, rows)

    def ftab(self, fi: torch.Tensor):
        return ftab_entry_plain(self.fm.ftab_rows, fi, self.fm.wide)

    def ftab12(self, fi: torch.Tensor):
        return ftab_entry_plain(self.fm.ftab12_rows, fi, self.fm.wide)


def search_plain(fm: DeviceFMIndex, reads: torch.Tensor,
                 lengths: torch.Tensor, start: torch.Tensor, mh: int,
                 min_hitlen: int, increment: int, first_hit_only: bool,
                 deep: bool, stats: dict = None):
    """Plain PyTorch K1: a lockstep loop over all lanes, each step one
    per-lane transition (a search start, or a one-char extension) for
    every lane not yet done. Returns the 6 output tensors.

    stats (optional dict) receives the lookups the kernel makes for this
    run's lanes, as lists of tensors: `rank_rows`/`rank_chars` of every
    LF rank, `bwt_rows` of every BWT char test of a one-row range, and
    `ftab`/`ftab12` entry indexes of every start lookup; and `steps`,
    one int64 [L] tensor, each lane's count of transitions (the JAX
    search_loop's count_steps)."""
    return search_steps(TableReads(fm), reads, lengths, start, mh,
                        min_hitlen, increment, first_hit_only, deep, stats)


def search_steps(tables, reads: torch.Tensor, lengths: torch.Tensor,
                 start: torch.Tensor, mh: int, min_hitlen: int,
                 increment: int, first_hit_only: bool, deep: bool,
                 stats: dict = None):
    """search_plain's lockstep loop over the table reads of `tables` (a
    TableReads, or its sharded counterpart)."""
    dev = reads.device
    codes = unpack_reads(reads)
    L, P = codes.shape
    fi10, fi12, first_n, n12 = _windows(codes)
    deep = bool(deep and tables.deep)
    zoff = tables.zoff
    f = tables.fchr
    i64 = dict(dtype=torch.int64, device=dev)
    n_all = lengths.to(torch.int64)
    cur = start.to(torch.int64).clone()
    done = n_all <= cur
    ext = torch.zeros(L, dtype=torch.bool, device=dev)
    no12 = torch.zeros_like(ext)
    off = torch.zeros(L, **i64)
    dep = torch.zeros(L, **i64)
    top = torch.zeros(L, **i64)
    bot = torch.zeros(L, **i64)
    nhits = torch.zeros(L, **i64)
    sums = torch.zeros(L, **i64)
    h_top = torch.full((L, mh), -1, **i64)
    h_bot = torch.full((L, mh), -1, **i64)
    h_off = torch.zeros((L, mh), **i64)
    h_len = torch.zeros((L, mh), **i64)
    steps = torch.zeros(L, **i64)
    while True:
        a = torch.nonzero(~done)[:, 0]
        if a.numel() == 0:
            break
        steps[a] += 1
        n, cu, ex, nz = n_all[a], cur[a], ext[a], no12[a]
        dp, tp, bt, ofs = dep[a], top[a], bot[a], off[a]
        st = ~ex
        left = n - cu
        pc = cu.clamp(0, P - 1)
        w10, w12, fn = fi10[a, pc], fi12[a, pc], first_n[a, pc]
        # ---- start: deep 12-char prime, else the 10-char ftab window ----
        use12 = st & (left >= 12) & ~n12[a, pc] & ~nz if deep \
            else torch.zeros_like(st)
        plain = st & ~use12
        case_a = plain & (left < FTAB_CHARS)
        case_b = plain & ~case_a & (fn < FTAB_CHARS)
        case_c = plain & ~case_a & ~case_b
        ft, fb = tables.ftab(w10)
        go_c = case_c & (fb > ft)
        go12 = torch.zeros_like(st)
        empty12 = torch.zeros_like(st)
        if deep:
            ft12, fb12 = tables.ftab12(w12)
            go12 = use12 & (fb12 > ft12)
            empty12 = use12 & ~go12
            ft = torch.where(go12, ft12, ft)
            fb = torch.where(go12, fb12, fb)
        go = go_c | go12
        start_emit = case_a | case_b | (case_c & ~go_c)
        start_len = torch.where(case_a, left, torch.where(
            case_b, fn + 1, torch.full_like(left, FTAB_CHARS)))
        # ---- extend: one char; top and bot rank from their own blocks ----
        stepping = ex & (dp < n)
        ch = codes[a, dp.clamp(0, P - 1)]
        single = (bt - tp) == 1
        need = stepping & (ch <= 3)
        multi = need & ~single
        t2 = tp.clone()
        b2 = bt.clone()
        idx = torch.nonzero(need)[:, 0]
        t2[idx] = f[ch[idx]] + tables.rank(tp[idx], ch[idx])
        idx_m = torch.nonzero(multi)[:, 0]
        b2[idx_m] = f[ch[idx_m]] + tables.rank(bt[idx_m], ch[idx_m])
        b2 = torch.where(single, t2 + 1, b2)
        bwtc = torch.full_like(ch, -1)
        idx_s = torch.nonzero(need & single)[:, 0]
        bwtc[idx_s] = tables.bwt(tp[idx_s])
        fail = stepping & (
            (ch > 3)
            | (single & ((bwtc != ch) | (tp == zoff)))
            | (~single & (b2 <= t2)))
        adv = stepping & ~fail
        ext_emit = (ex & (dp >= n)) | fail
        if stats is not None:
            # the kernel tests BWT[top] only off the '$' row, and ranks a
            # one-row range only when that test passes
            tested = need & single & (tp != zoff)
            ranked = multi | (tested & (bwtc == ch))
            _note(stats, ftab=w10[case_c], bwt_rows=tp[tested],
                  rank_rows=torch.cat([tp[ranked], bt[multi]]),
                  rank_chars=torch.cat([ch[ranked], ch[multi]]))
            if deep:
                _note(stats, ftab12=w12[use12])
        # ---- emit ----
        emit = start_emit | ext_emit
        e_top = torch.where(ext_emit, tp, -1)
        e_bot = torch.where(ext_emit, bt, -1)
        e_off = torch.where(ext_emit, ofs, cu)
        e_len = torch.where(ext_emit, dp - ofs, start_len)
        e_cur = e_off + e_len
        le = a[emit]
        slot = nhits[le].clamp(max=mh - 1)
        h_top[le, slot] = e_top[emit]
        h_bot[le, slot] = e_bot[emit]
        h_off[le, slot] = e_off[emit]
        h_len[le, slot] = e_len[emit]
        nhits[a] += emit.to(torch.int64)
        sums[a] += torch.where(emit & (e_len >= min_hitlen), e_len, 0)
        # ---- driver policy ----
        nxt = torch.where(e_len > increment, e_cur + 1, e_cur)
        fin = (e_cur >= n) | (nxt + min_hitlen >= n)
        if first_hit_only:
            fin = torch.ones_like(fin)
        done[a] = emit & fin
        cur[a] = torch.where(emit, nxt, cu)
        ext[a] = torch.where(emit, False, go | ex)
        off[a] = torch.where(go, cu, ofs)
        dep[a] = torch.where(go12, cu + 12, torch.where(
            go_c, cu + FTAB_CHARS, torch.where(adv, dp + 1, dp)))
        top[a] = torch.where(go, ft, torch.where(adv, t2, tp))
        bot[a] = torch.where(go, fb, torch.where(adv, b2, bt))
        no12[a] = torch.where(empty12, True, torch.where(emit | go, False,
                                                         nz))
    if stats is not None:
        _note(stats, steps=steps)
    idt = tables.row_dtype
    i32 = torch.int32
    return [h_top.to(idt), h_bot.to(idt), h_off.to(i32), h_len.to(i32),
            nhits.to(i32), sums.to(i32)]


def search_lanes(fm: DeviceFMIndex, reads: torch.Tensor,
                 lengths: torch.Tensor, start: torch.Tensor, mh: int,
                 min_hitlen: int, increment: int, first_hit_only: bool,
                 deep: bool, stats: dict = None):
    """K1 over all lanes: the CUDA kernel for tensors on a CUDA device
    (csrc/search.cu: a tile of threads a lane, lanes taken from a work
    counter), the plain version for tensors on the CPU. reads: uint8
    [L, row_bytes] reversed codes, two per byte; lengths/start: int32
    [L]. Returns [h_top, h_bot, h_off, h_len, nhits, sums] on the
    inputs' device."""
    if not reads.is_cuda:
        return search_plain(fm, reads, lengths, start, mh, min_hitlen,
                            increment, first_hit_only, deep, stats=stats)
    _cuda.require_cuda(fm.blocks, fm.ftab_rows, fm.fchr, reads, lengths,
                       start, fm.ftab12_rows)
    L = reads.shape[0]
    if reads.dtype != torch.uint8 or lengths.dtype != torch.int32 \
            or start.dtype != torch.int32 or reads.dim() != 2 \
            or lengths.shape != (L,) or start.shape != (L,):
        raise ValueError("reads must be uint8 [L, row_bytes], lengths and "
                         "start int32 [L]")
    if L >= _cuda.MAX_ITEMS:
        raise ValueError(f"{L} lanes: the search takes fewer than "
                         f"{_cuda.MAX_ITEMS} a call")
    deep = bool(deep and fm.ftab12_rows is not None)
    _cuda.require_aligned(fm.blocks, fm.ftab_rows,
                          fm.ftab12_rows if deep else None)
    dev = reads.device
    idt = fm.row_dtype
    outs = [torch.empty((L, mh), dtype=idt, device=dev),
            torch.empty((L, mh), dtype=idt, device=dev),
            torch.empty((L, mh), dtype=torch.int32, device=dev),
            torch.empty((L, mh), dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev),
            torch.empty(L, dtype=torch.int32, device=dev)]
    lib = _cuda.lib("search")
    fn = lib.fm_search_wide if fm.wide else lib.fm_search_narrow
    rc = fn(fm.blocks.data_ptr(), fm.fchr.data_ptr(), int(fm.zoff),
            fm.ftab_rows.data_ptr(),
            fm.ftab12_rows.data_ptr() if deep else None,
            reads.data_ptr(), reads.shape[1], lengths.data_ptr(),
            start.data_ptr(), *[o.data_ptr() for o in outs], L, mh,
            min_hitlen, increment, int(first_hit_only), int(deep),
            _cuda.work_counter(dev).data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "search kernel")
    _cuda.LAUNCHES["search"] += 1
    return outs


# ---- K5: the presolve ----

def presolve_rk(khits: int) -> int:
    """Row slots per mate for the pick (the JAX engine's rule)."""
    return 16 if khits <= 5 else min(128, 4 * khits)


def presolve_pick_rows_plain(h_top: torch.Tensor, h_bot: torch.Tensor,
                             h_len: torch.Tensor, khits: int, ihits: int,
                             min_hitlen: int, rk: int):
    """Plain PyTorch pick (the JAX package's classify/engine.py
    _presolve_pick_rows): per mate m, lanes 2m and 2m+1 (its fw and rc
    strands), the SA rows the classifier is predicted to resolve
    (classifier.h:429-479): the strand choice, the max_genome_hit_size
    budget, the resolution gate, hits in the stable order of (size asc,
    len desc) with fw before rc, the cumulative cap. Returns (rows [M, rk]
    in the row dtype, unused slots 0; nrows int32 [M])."""
    L, mh = h_top.shape
    M = L // 2
    t = h_top.reshape(M, 2, mh).to(torch.int64)
    b = h_bot.reshape(M, 2, mh).to(torch.int64)
    ln = h_len.reshape(M, 2, mh).to(torch.int64)
    size = torch.where(t >= 0, b - t, 0)
    scoring = (ln >= min_hitlen) & (size != 0)
    sc = torch.where(scoring, (ln - 15) * (ln - 15), 0).sum(dim=2)
    mx = torch.where(scoring, ln, 0).amax(dim=2)
    s0, s1 = sc[:, 0], sc[:, 1]
    fw = (s0 > s1) | ((s0 == s1) & (mx[:, 0] > mx[:, 1]))
    rc = (s1 > s0) | ((s0 == s1) & (mx[:, 1] > mx[:, 0]))
    both = ~fw & ~rc
    use = torch.stack([fw | both, rc | both], dim=1)
    maxsz = torch.where(scoring & use[:, :, None], size, 0).amax(dim=(1, 2))
    mghs = torch.where(maxsz > khits, maxsz + use.sum(dim=1) * khits, khits)
    nelt = torch.minimum(size, mghs[:, None, None])
    gate = (ln > min_hitlen) & (size != 0) & use[:, :, None] & (nelt <= ihits)
    key = torch.where(gate, size.clamp(max=1 << 18) * 4096 - ln,
                      torch.iinfo(torch.int64).max).reshape(M, 2 * mh)
    _, order = torch.sort(key, dim=1, stable=True)
    tops = t.reshape(M, 2 * mh).gather(1, order)
    nelt_s = torch.where(gate, nelt, 0).reshape(M, 2 * mh).gather(1, order)
    prev = nelt_s.cumsum(dim=1) - nelt_s
    nelt_t = torch.where((nelt_s > 0) & (prev < mghs[:, None]), nelt_s, 0)
    start = (nelt_t.cumsum(dim=1) - nelt_t)[:, None, :]
    slots = torch.arange(rk, device=t.device)[None, :, None]
    in_range = (slots >= start) & (slots < start + nelt_t[:, None, :])
    rows = torch.where(in_range, tops[:, None, :] + (slots - start),
                       0).sum(dim=2)
    nrows = nelt_t.sum(dim=1).clamp(max=rk).to(torch.int32)
    return rows.to(h_top.dtype), nrows


def presolve_compact_plain(rows: torch.Tensor,
                           nrows: torch.Tensor) -> torch.Tensor:
    """The per-mate row lists compacted into PRESOLVE_ROWS_PER_MATE * M
    flat slots (batched_search_presolve's cumsum + searchsorted +
    gather): mate after mate, nrows[m] rows each; the slots past the last
    row hold 0, and rows past the last slot are dropped."""
    M, rk = rows.shape
    n = torch.arange(PRESOLVE_ROWS_PER_MATE * M, device=rows.device)
    cnt = nrows.to(torch.int64)
    doffs = torch.cumsum(cnt, 0) - cnt
    mate = torch.searchsorted(doffs, n, right=True) - 1
    slot = n - doffs[mate]
    src = mate * rk + slot.clamp(0, rk - 1)
    return torch.where(slot < cnt[mate], rows.reshape(-1)[src], 0)


def presolve_rows_plain(h_top, h_bot, h_len, khits: int, ihits: int,
                        min_hitlen: int, rk: int) -> torch.Tensor:
    """Plain PyTorch K5: the pick, then the compaction."""
    return presolve_compact_plain(*presolve_pick_rows_plain(
        h_top, h_bot, h_len, khits, ihits, min_hitlen, rk))


def presolve_rows(h_top: torch.Tensor, h_bot: torch.Tensor,
                  h_len: torch.Tensor, khits: int, ihits: int,
                  min_hitlen: int, rk: int) -> torch.Tensor:
    """K5 over a batch's first-pass hit buffers [L, mh] (L even) -> the
    flat presolve rows [PRESOLVE_ROWS_PER_MATE * L / 2] in the row dtype:
    one CUDA kernel launch for CUDA tensors (csrc/presolve.cu: a warp a
    mate, its rows scattered straight to their flat slots), the plain
    version for CPU tensors."""
    args = (khits, ihits, min_hitlen, rk)
    if not h_top.is_cuda:
        return presolve_rows_plain(h_top, h_bot, h_len, *args)
    _cuda.require_cuda(h_top, h_bot, h_len)
    L, mh = h_top.shape
    if L % 2 or h_top.dtype not in (torch.int32, torch.int64) \
            or h_bot.dtype != h_top.dtype or h_len.dtype != torch.int32 \
            or h_bot.shape != (L, mh) or h_len.shape != (L, mh):
        raise ValueError("hit buffers must be [L, mh] with L even: h_top "
                         "and h_bot in the row dtype, h_len int32")
    if not 1 <= rk <= PRESOLVE_MAX_RK:
        raise ValueError(f"rk={rk}: the presolve stages 1 to "
                         f"{PRESOLVE_MAX_RK} rows a mate")
    M = L // 2
    if M >= _cuda.MAX_ITEMS:
        raise ValueError(f"{M} mates: the presolve takes fewer than "
                         f"{_cuda.MAX_ITEMS} a call")
    dev = h_top.device
    idt = h_top.dtype
    flat = torch.empty(PRESOLVE_ROWS_PER_MATE * M, dtype=idt, device=dev)
    if M == 0:
        return flat
    # the blocks' ticket counter and look-back flags, zeroed
    state = torch.zeros(1 + -(-M // PRESOLVE_MATES_PER_BLOCK),
                        dtype=torch.int64, device=dev)
    lib = _cuda.lib("presolve")
    fn = lib.fm_presolve_wide if idt == torch.int64 \
        else lib.fm_presolve_narrow
    rc = fn(h_top.data_ptr(), h_bot.data_ptr(), h_len.data_ptr(), M, mh,
            *args, flat.data_ptr(), flat.numel(), state.data_ptr(),
            _cuda.stream_ptr(dev))
    _cuda.check(rc, "presolve kernel")
    _cuda.LAUNCHES["presolve"] += 1
    return flat


def presolve_plain(fm: DeviceFMIndex, h_top, h_bot, h_len, khits: int,
                   ihits: int, min_hitlen: int, rk: int,
                   max_steps: int = RESOLVE_MAX_STEPS):
    """Plain PyTorch presolve: (flat rows, their int32 values), the
    compaction and the walk of batched_search_presolve."""
    flat = presolve_rows_plain(h_top, h_bot, h_len, khits, ihits,
                               min_hitlen, rk)
    return flat, resolve_rows_plain(fm, flat, max_steps)


def presolve_lanes(fm: DeviceFMIndex, h_top, h_bot, h_len, khits: int,
                   ihits: int, min_hitlen: int, rk: int,
                   max_steps: int = RESOLVE_MAX_STEPS):
    """The presolve of one dispatch: K5's flat rows, then K3 on them, on
    the current stream (CUDA tensors), or the plain versions (CPU
    tensors). Returns (flat rows, int32 values)."""
    flat = presolve_rows(h_top, h_bot, h_len, khits, ihits, min_hitlen, rk)
    return flat, resolve_rows(fm, flat, max_steps)


class SearchHandle:
    """One dispatched search: the device outputs and their pinned host
    copies in flight (CUDA), or the finished arrays (CPU). With a
    presolve, the flat rows and their values travel behind the same
    event. `reads` and `lengths` are the host tensors the launch uploads
    (page-locked on a CUDA engine), kept until the handle goes;
    `rseqp` and `lengths` are their numpy views."""

    def __init__(self, reads, lengths, mh, lmax, nlanes, presolve=None):
        self.host_in = (reads, lengths)
        self.rseqp = reads.numpy()
        self.lengths = lengths.numpy()
        self.mh = mh
        self.lmax = lmax
        self.nlanes = nlanes
        self.presolve = presolve  # (khits, ihits, rk), or None
        self.device_out = None   # device tensors kept alive until fetched
        self.host_out = None     # pinned host tensors (CUDA) / CPU tensors
        self.event = None
        self.arrays = None       # the 6 numpy arrays, once fetched
        self.prefetch = None     # (flat rows, values) numpy, once fetched

    @property
    def fetched(self) -> bool:
        return self.arrays is not None


class BatchSearchEngine:
    """Host wrapper: pack reads -> device search -> per-lane hit arrays.

    Lane counts and read lengths are bucketed (padding lanes have length
    0 and finish at once). The hit buffer starts small (16 slots, the
    common case); lanes that emit more are re-run with a larger one.
    """

    FIRST_MAX_HITS = 16
    FIRST_HITS_CHUNK = 4096

    def __init__(self, fm: DeviceFMIndex, min_hitlen: int = 22):
        if fm.ftab_chars != FTAB_CHARS:
            raise ValueError("the search primes a 10-char ftab window; "
                             f"this index has ftab_chars={fm.ftab_chars}")
        self.fm = fm
        self.device = fm.device
        self.min_hitlen = min_hitlen
        self.increment = 10 if 2 * min_hitlen <= 33 else 2 * min_hitlen - 33
        self.lane_bucket_lo = 256
        self.lmax_lo = 32
        self.overflow_bucket_lo = 32   # lane bucket of the overflow re-run
        self.stats = {"upload_bytes": 0, "staged_upload_bytes": 0,
                      "download_bytes": 0, "ext_searches": 0,
                      "ext_lanes": 0}
        # the main thread and the tail worker both add to the counters
        self._stats_lock = threading.Lock()
        # every launch on the engine's stream holds this lock: the main
        # thread's searches, and (without a host resolver) the tail
        # worker's first-hit searches and device resolves
        self.dev_lock = threading.RLock()
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # a launch's host inputs are page-locked on a CUDA engine
        self._pin = self.device.type == "cuda"
        self._zeros = None   # int32 zeros on the card: every start 0

    def add_stats(self, **deltas: int) -> None:
        """Add to the --met counters in `stats`, under their own lock: the
        main thread and the tail worker both count, outside dev_lock."""
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    # ---- lane packing ----

    def pack(self, seqs: List[np.ndarray], lmax: int,
             nlanes: int) -> Tuple[np.ndarray, np.ndarray]:
        """Reversed, padded lane matrix as int8 codes."""
        fc = self.fm.ftab_chars
        rseq = np.zeros((nlanes, lmax + fc), dtype=np.int8)
        lengths = np.zeros(nlanes, dtype=np.int32)
        if seqs:
            lens = np.fromiter((len(x) for x in seqs), np.int32, len(seqs))
            lengths[: len(seqs)] = lens
            total = int(lens.sum())
            if total:
                allseq = np.concatenate(seqs)
                rows = np.repeat(np.arange(len(seqs), dtype=np.int64), lens)
                starts = np.cumsum(lens) - lens
                col = np.arange(total, dtype=np.int64) - starts[rows]
                rseq[rows, lens[rows] - 1 - col] = allseq
        return rseq, lengths

    @staticmethod
    def transport(rseq: np.ndarray, out: np.ndarray = None) -> np.ndarray:
        """2 base codes per byte (codes are 0-4, 4 bits each), written
        into `out` (uint8 [lanes, row_bytes]) when given."""
        if rseq.shape[1] % 2:
            rseq = np.concatenate(
                [rseq, np.zeros((rseq.shape[0], 1), rseq.dtype)], axis=1)
        return np.bitwise_or(rseq[:, 0::2].astype(np.uint8) & 15,
                             rseq[:, 1::2].astype(np.uint8) << 4, out=out)

    def _host_lanes(self, nlanes: int, row_bytes: int):
        """Empty host tensors for one launch's lanes (uint8 [nlanes,
        row_bytes]) and lengths (int32 [nlanes], zeroed). On a CUDA engine
        each is a fresh page-locked block from PyTorch's host cache: the
        copy to the card needs no staging copy by the driver, and the
        cache hands the block out again only once the copies queued from
        it have run, so every launch, on any thread, has its own."""
        return (torch.empty((nlanes, row_bytes), dtype=torch.uint8,
                            pin_memory=self._pin),
                torch.zeros(nlanes, dtype=torch.int32, pin_memory=self._pin))

    def _pack_lanes(self, seqs: List[np.ndarray], lmax: int, nlanes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pack_transport's lanes and lengths, written in place into the
        host tensors a launch uploads (_host_lanes)."""
        row_bytes = (lmax + self.fm.ftab_chars + 1) // 2
        reads, lengths = self._host_lanes(nlanes, row_bytes)
        if seqs:
            from ..native.pack import pack_reads
            lens = np.fromiter((len(x) for x in seqs), np.int32, len(seqs))
            lengths.numpy()[: len(seqs)] = lens
            if pack_reads(seqs, lens, nlanes, row_bytes,
                          out=reads.numpy()) is not None:
                return reads, lengths
        self.transport(self.pack(seqs, lmax, nlanes)[0], out=reads.numpy())
        return reads, lengths

    def pack_transport(self, seqs: List[np.ndarray], lmax: int,
                       nlanes: int) -> Tuple[np.ndarray, np.ndarray]:
        """The 2-codes-per-byte lane matrix the kernel reads and the lane
        lengths, built by the native packer (native/pack.cpp); numpy is
        the fallback. On a CUDA engine both view page-locked memory."""
        reads, lengths = self._pack_lanes(seqs, lmax, nlanes)
        return reads.numpy(), lengths.numpy()

    # ---- dispatch ----

    def _deep(self, lmax: int) -> bool:
        # the JAX engine primes 12 chars only on its packed-word path
        # (lane width lmax + 10 <= 2048); same rule, same outputs
        return self.fm.deep and lmax + self.fm.ftab_chars <= 2048

    def _zero_start(self, n: int) -> torch.Tensor:
        """int32 [n] zeros on the card, on the current stream: a view of
        one array the engine keeps, made by the first launch (the warm-up
        batch) and again only for a launch of more lanes than it holds."""
        if self._zeros is None or self._zeros.shape[0] < n:
            self._zeros = torch.zeros(n, dtype=torch.int32,
                                      device=self.device)
        return self._zeros[:n]

    def _inputs(self, handle: SearchHandle, start):
        """The launch's (lanes, lengths, start) tensors, counted in stats.
        start is None (every lane from offset 0) or an int32 [nlanes]
        host tensor (page-locked on a CUDA engine). On a CPU engine the
        host tensors themselves. On a CUDA engine each is copied to the
        card on the current stream from its host tensor itself, so
        PyTorch's host cache records the copy on the block; start None is
        the card's zero array (_zero_start), so nothing is uploaded or
        filled for it. staged_upload_bytes counts the lanes and lengths
        that came from page-locked memory (upload_bytes: all of them)."""
        reads, lens = handle.host_in
        nbytes = reads.nbytes + lens.nbytes
        if not self._pin:
            self.add_stats(upload_bytes=nbytes)
            if start is None:
                start = torch.zeros(handle.nlanes, dtype=torch.int32)
            return reads, lens, start
        self.add_stats(upload_bytes=nbytes, staged_upload_bytes=sum(
            t.nbytes for t in handle.host_in if t.is_pinned()))
        dev = self.device
        return (reads.to(dev, non_blocking=True),
                lens.to(dev, non_blocking=True),
                self._zero_start(handle.nlanes) if start is None
                else start.to(dev, non_blocking=True))

    def _launch(self, handle: SearchHandle, start, first_hit_only: bool
                ) -> SearchHandle:
        """Launch the handle's search; start as in _inputs."""
        fm = self.fm
        args = (handle.mh, self.min_hitlen, self.increment, first_hit_only,
                self._deep(handle.lmax))

        def presolve(out):
            # from the first-pass buffers, as the JAX dispatch does: a
            # lane past mh hits has overwritten its last slot there
            if handle.presolve is None:
                return []
            khits, ihits, rk = handle.presolve
            return list(presolve_lanes(fm, out[0], out[1], out[3], khits,
                                       ihits, self.min_hitlen, rk))

        if self._stream is None:
            out = search_lanes(fm, *self._inputs(handle, start), *args)
            handle.host_out = out + presolve(out)
            return handle
        with self.dev_lock, torch.cuda.stream(self._stream):
            reads, lens, st = self._inputs(handle, start)
            out = search_lanes(fm, reads, lens, st, *args)
            out = out + presolve(out)
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in out]
            for h, o in zip(host, out):
                h.copy_(o, non_blocking=True)
            handle.event = torch.cuda.Event()
            handle.event.record(self._stream)
            handle.device_out = (reads, lens, st, out)
            handle.host_out = host
        return handle

    def _wait(self, handle: SearchHandle) -> List[np.ndarray]:
        if handle.event is not None:
            handle.event.synchronize()
            handle.device_out = None
        out = [t.numpy() for t in handle.host_out]
        self.add_stats(download_bytes=sum(a.nbytes for a in out))
        return out

    def _run(self, reads, lengths, start, max_hits, first_hit_only,
             lmax) -> List[np.ndarray]:
        h = SearchHandle(reads, lengths, max_hits, lmax, reads.shape[0])
        return self._wait(self._launch(h, start, first_hit_only))

    def search_async(self, seqs: List[np.ndarray], presolve: bool = False,
                     khits: int = 5, ihits: int = 200) -> SearchHandle:
        """Pack and launch the search of all lanes on the engine's stream,
        with the device->host copy of the outputs queued behind it;
        returns at once with a handle for search_fetch/search_collect.

        With presolve=True the same dispatch also resolves, speculatively,
        the SA rows the assignment pass is predicted to ask for (K5, then
        K3); search_collect then returns them as the (rows, values)
        prefetch. Lanes (2m, 2m+1) must be one mate's two strands."""
        L = len(seqs)
        maxlen = max((len(s) for s in seqs), default=1)
        lmax = _bucket_len(maxlen, lo=self.lmax_lo)
        nlanes = _bucket(L, lo=self.lane_bucket_lo)
        reads, lengths = self._pack_lanes(seqs, lmax, nlanes)
        mh = min(self.FIRST_MAX_HITS, lmax)
        h = SearchHandle(reads, lengths, mh, lmax, nlanes, presolve=(
            khits, ihits, presolve_rk(khits)) if presolve else None)
        return self._launch(h, None, False)

    def search_fetch(self, handle: SearchHandle) -> SearchHandle:
        """Wait for the handle's outputs and re-run overflowing lanes: the
        pipeline calls it on the main thread, so the tail worker gets
        host arrays. Idempotent."""
        if not handle.fetched:
            out = self._wait(handle)
            if handle.presolve is not None:
                handle.prefetch = (out[6], out[7])
            handle.arrays = self._handle_overflow(
                out[:6], handle.rseqp, handle.lengths, handle.mh,
                handle.lmax, handle.nlanes)
        return handle

    def search_collect(self, handle: SearchHandle, L: int):
        """([h_top, h_bot, h_off, h_len, nhits, sums] of the first L lanes,
        prefetch): prefetch is (rows, values) sorted by row (a stable
        sort) when the dispatch presolved, else None."""
        handle = self.search_fetch(handle)
        prefetch = None
        if handle.prefetch is not None:
            rows, tidx = handle.prefetch
            order = np.argsort(rows, kind="stable")
            prefetch = (rows[order], tidx[order])
        return [a[:L] for a in handle.arrays], prefetch

    def search(self, seqs: List[np.ndarray]) -> List[np.ndarray]:
        """Full scan of each sequence; returns the per-lane hit arrays."""
        h = self.search_fetch(self.search_async(seqs))
        return [a[: len(seqs)] for a in h.arrays]

    def _handle_overflow(self, out, rseqp, lengths, mh, lmax, nlanes):
        over = np.nonzero(out[4] > mh)[0]
        if over.shape[0]:
            # rare: a lane emitted more hits than the small buffer holds.
            # Re-run only those lanes, sized to the actual max hit count.
            out = self._rerun_overflow(
                out, over, _bucket(over.shape[0],
                                   lo=self.overflow_bucket_lo),
                min(_bucket(int(out[4].max()), lo=2 * mh), lmax), rseqp,
                lengths, lmax, nlanes)
        return out

    def _rerun_overflow(self, out, over, nover, mh2, rseqp, lengths, lmax,
                        nlanes):
        """The lanes `over` re-run in a bucket of nover lanes with mh2 hit
        slots; every array widened to mh2 (other lanes' new slots 0)."""
        reads2, lengths2 = self._host_lanes(nover, rseqp.shape[1])
        rseq2 = reads2.numpy()
        rseq2[: over.shape[0]] = rseqp[over]
        rseq2[over.shape[0]:] = 0
        lengths2.numpy()[: over.shape[0]] = lengths[over]
        full = self._run(reads2, lengths2, None, mh2, False, lmax)
        wide = [np.zeros((nlanes, mh2), a.dtype) if a.ndim == 2 else a
                for a in out]
        for k in range(4):
            w = out[k].shape[1]
            wide[k][:, :w] = out[k]
            wide[k][over] = full[k][: over.shape[0]]
        wide[4] = out[4].copy()
        wide[4][over] = full[4][: over.shape[0]]
        wide[5] = out[5].copy()
        wide[5][over] = full[5][: over.shape[0]]
        return wide

    def search_first_hits(self, seqs: List[np.ndarray], offsets: np.ndarray):
        """One partialSearch per lane from the given offsets (the
        extension pass), in fixed-size lane chunks."""
        L = len(seqs)
        lmax = _bucket_len(max((len(s) for s in seqs), default=1), lo=32)
        chunk = self.FIRST_HITS_CHUNK
        self.add_stats(ext_searches=(L + chunk - 1) // chunk, ext_lanes=L)
        outs = []
        for c0 in range(0, L, chunk):
            part = seqs[c0: c0 + chunk]
            reads, lengths = self._pack_lanes(part, lmax, chunk)
            start = torch.zeros(chunk, dtype=torch.int32,
                                pin_memory=self._pin)
            start.numpy()[: len(part)] = offsets[c0: c0 + chunk].astype(
                np.int32)
            out = self._run(reads, lengths, start, 1, True, lmax)
            outs.append([a[: len(part)] for a in out])
        if len(outs) == 1:
            return outs[0]
        return [np.concatenate([o[k] for o in outs]) for k in range(6)]
