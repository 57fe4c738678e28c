"""The CUDA kernels' per-lane arithmetic (csrc/fm_common.cuh), compiled
for the host with g++ (csrc/cpu_twin.cpp), against the port's plain
PyTorch versions: rank, the depth-12 ftab (K4's tile scan of a level-1
range), the SA resolve walk and its exits, the presolve (K5's warp pick
and scatter, the warp emulated serially), and K6's search and walk over
BWT-range shards
(the same lane loops over the shard reader that csrc/sharded.cu launches)
here, the search in test_torch_engine.py.
Nothing else on a machine without nvcc compiles the code the card runs.
Integers throughout: exact equality."""

import ctypes as C
import os
import subprocess

import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_gpu import (FTAB12_FILL, PRESOLVE_CASES,  # noqa: F401
                            ftab12_case_inputs, level1_cases, presolve_case,
                            random_hits)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "centrifuge_tpu_torch", "csrc")

_P, _I64, _I32 = C.c_void_p, C.c_int64, C.c_int32
_SIGS = {
    "rank": [_P, _P, _I64, _P, _P, _P, _I64, _I32, _P, _P],
    "search": [_P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P,
               _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32],
    "ftab12": [_P, _P, _I64, _P, _P, _P, _P, _P, _I32],
    "level1": [_P, _P, _I64, _P, _P, _P, _P, _I64, _I32],
    "resolve": [_P, _P, _I64, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _I32,
                _P, _P, _I64, _I32],
    "presolve": [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _I64,
                 _P],
    "shard_search": [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                     _I32, _I32, _I32],
    "shard_resolve": [_P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _I64],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one torch
    thread per worker keeps the plain versions from oversubscribing
    them. Test modules of the port import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_twin(out_dir: str):
    """Compile cpu_twin.cpp (which includes fm_common.cuh) with g++ and
    load it; argtypes are set for every twin_* entry."""
    so = os.path.join(out_dir, "cpu_twin.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", CSRC, os.path.join(CSRC, "cpu_twin.cpp"), "-o",
                    so], check=True, capture_output=True)
    lib = C.CDLL(so)
    for kind in ("narrow", "wide"):
        for name, sig in _SIGS.items():
            fn = getattr(lib, f"twin_{name}_{kind}")
            fn.argtypes = sig
            # the search, walk and K6 twin loops return the longest
            # lane's count of table reads, the rank, level1 and ftab12 0;
            # -1 for a group other than 1, 2, 4 or 8
            fn.restype = None if name == "presolve" else _I64
    return lib


def ptr(t):
    return None if t is None else t.data_ptr()


def twin_search(lib, fm, reads, lengths, start, mh, min_hitlen, increment,
                first_hit_only, deep, reads_out=None, group=1):
    """The search kernel's lane function over all lanes, on the host,
    run by the one-thread group of `group` parts (the card's tile
    size); same arguments and outputs as engine.search_lanes.
    reads_out, a list, receives the longest lane's count of table
    reads."""
    L = reads.shape[0]
    idt = fm.row_dtype
    outs = [torch.empty((L, mh), dtype=idt), torch.empty((L, mh), dtype=idt),
            torch.empty((L, mh), dtype=torch.int32),
            torch.empty((L, mh), dtype=torch.int32),
            torch.empty(L, dtype=torch.int32),
            torch.empty(L, dtype=torch.int32)]
    deep = bool(deep and fm.ftab12_rows is not None)
    fn = lib.twin_search_wide if fm.wide else lib.twin_search_narrow
    most = fn(ptr(fm.blocks), ptr(fm.fchr), fm.zoff, ptr(fm.ftab_rows),
              ptr(fm.ftab12_rows) if deep else None, ptr(reads),
              reads.shape[1], ptr(lengths), ptr(start),
              *[ptr(o) for o in outs], L, mh, min_hitlen, increment,
              int(first_hit_only), int(deep), group)
    assert most >= 0
    if reads_out is not None:
        reads_out.append(most)
    return outs


def twin_resolve(lib, fm, rows, max_steps, walk=True, group=1):
    """The K3 lane function (walk=True) or its exits alone over rows, on
    the host, run by the one-thread group of `group` parts; same
    outputs as ops/fm_torch.resolve_rows / try_offset_plain."""
    out = torch.empty(rows.shape, dtype=torch.int32)
    fn = lib.twin_resolve_wide if fm.wide else lib.twin_resolve_narrow
    most = fn(ptr(fm.blocks), ptr(fm.fchr), fm.zoff, ptr(fm.offs),
              fm.offs.numel(), ptr(fm.boundary_rows), ptr(fm.boundary_refs),
              fm.boundary_rows.numel(), fm.offrate, int(fm.npat <= 0xFFFF),
              max_steps, int(walk), ptr(rows), ptr(out), rows.numel(), group)
    assert most >= 0
    return out


def twin_presolve(lib, h_top, h_bot, h_len, khits, ihits, min_hitlen, rk,
                  fill=-7):
    """K5 on the host as its kernel runs it (blocks of 32 mates, a warp a
    mate emulated serially, the scan and the scatter, the zero tail):
    (flat rows [4 M], nrows [M]); the same flat rows as
    classify/engine.presolve_rows_plain. The slots start as `fill`, so a
    slot left unwritten shows, and M * rk more slots past the 4 M must
    keep it: nothing is written past the flat rows."""
    L, mh = h_top.shape
    M = L // 2
    n = 4 * M
    flat = torch.full((n + M * rk,), fill, dtype=h_top.dtype)
    nrows = torch.full((M,), fill, dtype=torch.int32)
    fn = lib.twin_presolve_wide if h_top.dtype == torch.int64 \
        else lib.twin_presolve_narrow
    fn(ptr(h_top), ptr(h_bot), ptr(h_len), M, mh, khits, ihits, min_hitlen,
       rk, ptr(flat), n, ptr(nrows))
    assert bool((flat[n:] == fill).all()), "written past the flat rows"
    return flat[:n], nrows


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    return build_twin(str(tmp_path_factory.mktemp("twin")))


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(fixture_path("synth", "synth"))


def _edge_rows(bwt_len: int, zoff: int, rng) -> np.ndarray:
    """Random rows plus the traps: rows at word and block boundaries
    (a full-word mask must not shift by 32), the '$' row and its
    neighbours, and the last row."""
    edges = [0, 1, 15, 16, 17, 255, 256, 257, 496, 511, 512, 513, 1024,
             zoff - 1, zoff, zoff + 1, bwt_len - 1, bwt_len]
    edges += list(range(16 * 7, 16 * 9)) + [(bwt_len // 512) * 512]
    return np.concatenate([np.array(edges), rng.integers(0, bwt_len + 1,
                                                         2048)])


# K0's tile sizes in the card's sweep; the G = 1 cases keep the ids the
# test had when K0 was one thread a query
RANK_GROUPS = [(w, g) for g in (1, 2, 4, 8) for w in (False, True)]
RANK_IDS = [("wide" if w else "narrow") + ("" if g == 1 else f"_g{g}")
            for w, g in RANK_GROUPS]


@pytest.mark.parametrize("wide,group", RANK_GROUPS, ids=RANK_IDS)
def test_twin_rank_matches_plain(twin, port_index, wide, group):
    """K0's query (fm_common.cuh scan_rank, as csrc/rank.cu's tile of G
    threads runs it, its G chunk parts summed as the tile sums them)
    against the plain rank, with and without fchr: every char at every
    edge row (word and block edges, the '$' row and its neighbours, the
    BWT's length), then random (row, char) pairs."""
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import lf, rank_plain
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    rng = np.random.default_rng(5)
    rows_np = _edge_rows(port_index.bwt_len, fm.zoff, rng)
    n_edge = rows_np.shape[0] - 2048
    rows = torch.from_numpy(rows_np.astype(np.int64 if wide else np.int32))
    chars = torch.from_numpy(rng.integers(0, 4, rows.shape[0]).astype(
        np.int32))
    rows = torch.cat([rows[:n_edge].repeat_interleave(4), rows])
    chars = torch.cat([torch.arange(4, dtype=torch.int32).repeat(n_edge),
                       chars])
    fn = twin.twin_rank_wide if wide else twin.twin_rank_narrow
    codes = torch.empty(rows.shape, dtype=torch.int32)
    pair = torch.empty_like(rows)
    for use_fchr in (False, True):
        got = torch.empty_like(rows)
        assert fn(ptr(fm.blocks), ptr(fm.fchr) if use_fchr else None,
                  fm.zoff, ptr(rows), ptr(chars), ptr(got), rows.shape[0],
                  group, ptr(codes), ptr(pair)) == 0
        want = rank_plain(fm.blocks, fm.zoff, rows, chars)
        if use_fchr:
            want = fm.fchr.to(torch.int64)[chars.to(torch.int64)] + want
            assert torch.equal(lf(fm.blocks, fm.fchr, fm.zoff, rows, chars),
                               want.to(rows.dtype))
        assert torch.equal(got, want.to(rows.dtype))


def twin_level1(lib, fm, t0, b0, group):
    """K0's level 1 (fm_common.cuh scan_ends over each range) on the
    host, run by the one-thread group of `group` parts: (t1, b1)."""
    n = t0.numel()
    t1 = torch.full((4 * n,), -9, dtype=t0.dtype)
    b1 = torch.full_like(t1, -9)
    fn = lib.twin_level1_wide if fm.wide else lib.twin_level1_narrow
    assert fn(ptr(fm.blocks), ptr(fm.fchr), fm.zoff, ptr(t0), ptr(b0),
              ptr(t1), ptr(b1), n, group) == 0
    return t1, b1


@pytest.fixture(scope="module")
def synth_level1(port_index):
    """wide -> (fm, t0, b0, the plain level 1 of the synth index's 2^20
    depth-10 ranges), computed once a module."""
    from centrifuge_tpu_torch.ops.fm_torch import N10, DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import level1_plain
    out = {}
    for wide in (False, True):
        fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                                 deep_ftab=False)
        t0 = fm.ftab_top[:N10].contiguous()
        b0 = fm.ftab_bot[:N10].contiguous()
        out[wide] = (fm, t0, b0,
                     level1_plain(fm.blocks, fm.fchr, fm.zoff, t0, b0))
    return out


@pytest.mark.parametrize("wide,group", RANK_GROUPS, ids=RANK_IDS)
def test_twin_level1_matches_plain(twin, synth_level1, wide, group):
    """K0's level-1 entry, its G chunk parts summed as a tile sums them:
    over the synth index's 2^20 depth-10 ranges (empty parents
    included) and over chosen ranges (test_torch_gpu.py level1_cases),
    t1/b1 equal the plain level 1, which holds LF of both ends where
    the range is non-empty and 0 where it is empty."""
    from centrifuge_tpu_torch.ops.rank import level1_plain
    fm, t0, b0, want = synth_level1[wide]
    assert bool((b0 <= t0).any()) and bool((b0 > t0).any())
    got = twin_level1(twin, fm, t0, b0, group)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    t0, b0 = level1_cases(fm, 70 + group)
    got = twin_level1(twin, fm, t0, b0, group)
    want = level1_plain(fm.blocks, fm.fchr, fm.zoff, t0, b0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    empty = (b0 <= t0).repeat(4)
    assert bool(empty.any()) and not bool((want[0][empty] != 0).any())


# the one-thread group at the card's tile sizes (and K6's G = 1); the
# G = 1 cases keep the ids the tests had before the tile groups
GROUP_CASES = [(False, 1), (True, 1), (False, 4), (True, 4), (False, 8),
               (True, 8)]
GROUP_IDS = ["narrow", "wide", "narrow_g4", "wide_g4", "narrow_g8",
             "wide_g8"]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_twin_row_scan_matches_plain(twin, port_index, wide, group):
    """The row scan of K1, K3 and K6 (fm_common.cuh scan_rank and
    rank_pair) with its G chunk parts summed as a tile sums them: at
    every `within` 0..511 of the block holding the '$' row and of the
    first block, and up to the BWT's length in the last, for every char, the rank equals the plain
    rank and the code the plain BWT, and the pair scan gives both ranks,
    over two rows of one block (read once) and of two blocks; and the
    rank of the code at the row itself (char -1, K3's step)."""
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import bwt_at_plain, rank_plain
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    n = port_index.bwt_len
    base = np.concatenate([(fm.zoff >> 9 << 9) + np.arange(512),
                           np.arange(512),
                           (n >> 9 << 9) + np.arange((n & 511) + 1)])
    assert fm.zoff in base and base.shape[0] % 2 == 0
    rows_np = np.repeat(base, 4)
    chars_np = np.tile(np.arange(4), base.shape[0])
    # pairs (2m, 2m + 1): the same row with chars 2m, 2m+1 and, shuffled,
    # rows of two blocks
    rng = np.random.default_rng(12)
    perm = rng.permutation(base.shape[0])
    rows_np = np.concatenate([rows_np, base[perm]])
    chars_np = np.concatenate([chars_np, rng.integers(0, 4, base.shape[0])])
    rows = torch.from_numpy(rows_np.astype(np.int64 if wide else np.int32))
    chars = torch.from_numpy(chars_np.astype(np.int32))
    got = torch.empty_like(rows)
    pair = torch.empty_like(rows)
    codes = torch.empty(rows.shape, dtype=torch.int32)
    fn = twin.twin_rank_wide if wide else twin.twin_rank_narrow
    assert fn(ptr(fm.blocks), None, fm.zoff, ptr(rows), ptr(chars), ptr(got),
              rows.numel(), group, ptr(codes), ptr(pair)) == 0
    assert torch.equal(got, rank_plain(fm.blocks, fm.zoff, rows, chars
                                       ).to(rows.dtype))
    assert torch.equal(codes.to(torch.int64), bwt_at_plain(fm.blocks, rows))
    pair_chars = chars.view(-1, 2)[:, :1].expand(-1, 2).reshape(-1)
    assert torch.equal(pair, rank_plain(fm.blocks, fm.zoff, rows, pair_chars
                                        ).to(rows.dtype))
    assert int(codes[rows_np == fm.zoff][0]) == 0
    # char -1: the rank of the code at each row, as K3's walk asks it
    # (every code counted, the one at the row picked after)
    any_c = torch.full_like(chars, -1)
    assert fn(ptr(fm.blocks), None, fm.zoff, ptr(rows), ptr(any_c), ptr(got),
              rows.numel(), group, ptr(codes), ptr(pair)) == 0
    at = bwt_at_plain(fm.blocks, rows)
    assert torch.equal(codes.to(torch.int64), at)
    assert torch.equal(got, rank_plain(fm.blocks, fm.zoff, rows,
                                       at.to(torch.int32)).to(rows.dtype))


# K4's tile size on the card (csrc/ftab12.cu kTile)
FTAB12_TILE = 4


def twin_ftab12(lib, fm, t0, b0, t1, b1, out, group=1):
    """K4's 2^22 level-1 ranges (fm_common.cuh ftab12_range) on the host,
    run by the one-thread group of `group` parts, written into `out` in
    place."""
    fn = lib.twin_ftab12_wide if fm.wide else lib.twin_ftab12_narrow
    assert fn(ptr(fm.blocks), ptr(fm.fchr), fm.zoff, ptr(t0), ptr(b0),
              ptr(t1), ptr(b1), ptr(out), group) == 0


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_twin_ftab12_matches_plain(twin, port_index, wide):
    """Every level-1 range of the synth index through K4's tile scan at
    the card's tile size: the whole packed table equals the plain
    build's (which holds empty parents and empty level-1 ranges)."""
    from centrifuge_tpu_torch.ops.fm_torch import (N10, DeviceFMIndex,
                                                   ftab12_level1)
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=True)
    t0, b0 = fm.ftab_top[:N10].contiguous(), fm.ftab_bot[:N10].contiguous()
    # level 1 exactly as build_ftab12 feeds the kernel: LF of both range
    # ends for every (e10, c10), empty parents included
    t1, b1 = ftab12_level1(fm.blocks, fm.fchr, fm.zoff, t0, b0)
    assert bool((b0 <= t0).any()) and bool(((b1 <= t1) & (
        b0 > t0).repeat(4)).any())
    out = torch.zeros_like(fm.ftab12_rows)
    twin_ftab12(twin, fm, t0, b0, t1, b1, out, group=FTAB12_TILE)
    assert torch.equal(out, fm.ftab12_rows)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_twin_ftab12_tile_scan_cases(twin, port_index, wide, group):
    """K4's tile scan of chosen level-1 ranges (test_torch_gpu.py
    ftab12_cases: ends in one row and two, the '$' row, the guards), its
    G chunk parts summed as a tile sums them and its four stores split
    over the G threads: each range's four entries equal the plain LF of
    both ends (or (0, 0) under the guards), every other range's are (0,
    0), and columns 32-35 (narrow) and 32-39 (wide) of every row keep
    their words."""
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    t0, b0, t1, b1, want, live = ftab12_case_inputs(fm, 60 + group)
    out = torch.full_like(want, FTAB12_FILL)
    twin_ftab12(twin, fm, t0, b0, t1, b1, out, group)
    assert torch.equal(out, want)
    # the guards store (0, 0) for some of the cases, not all
    assert bool(live.any()) and not bool(live.all())


@pytest.mark.parametrize("wide,group", GROUP_CASES, ids=GROUP_IDS)
def test_twin_resolve_matches_plain(twin, port_index, wide, group):
    """resolve_row and try_offset against the plain walk and exits, on
    the edge rows and every boundary row, run by the one-thread group of
    `group` parts: at the full step budget and at max_steps 1, 2 (8 LF
    steps: the bound rounds up to the 8-step unroll) and 9 (16), the
    first two of which leave rows unresolved."""
    from centrifuge_tpu_torch.ops.fm_torch import (DeviceFMIndex,
                                                   resolve_rows_plain,
                                                   try_offset_plain)
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    rng = np.random.default_rng(6)
    rows_np = np.concatenate([_edge_rows(port_index.bwt_len, fm.zoff, rng),
                              fm.boundary_rows.numpy()])
    rows = torch.from_numpy(rows_np[rows_np < port_index.bwt_len].astype(
        np.int64 if wide else np.int32))
    got = twin_resolve(twin, fm, rows, 0, walk=False, group=group)
    assert torch.equal(got, try_offset_plain(fm, rows))
    assert (got >= 0).any() and (got < 0).any()
    for steps in (4096, 1, 2, 9):
        want = resolve_rows_plain(fm, rows, max_steps=steps)
        assert torch.equal(twin_resolve(twin, fm, rows, steps, group=group),
                           want)
        if steps != 9:
            assert bool((want < 0).any()) == (steps < 9)


@pytest.mark.parametrize("khits", [5, 16])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_twin_pick_matches_plain(twin, wide, khits):
    """K5 (the warp pick, the block scan and the scatter) on random hit
    buffers of 512 mates: the flat rows equal the plain pick and
    compaction's, and each mate's count the plain pick's."""
    from centrifuge_tpu_torch.classify.engine import (
        presolve_pick_rows_plain, presolve_rk, presolve_rows_plain)
    hits = random_hits(512, 16, wide, seed=khits)
    args = (khits, max(khits, 5) * 40, 22, presolve_rk(khits))
    _, nrows = presolve_pick_rows_plain(*hits, *args)
    flat, t_n = twin_presolve(twin, *hits, *args)
    assert torch.equal(flat, presolve_rows_plain(*hits, *args))
    assert torch.equal(t_n, nrows)
    assert int(nrows.min()) < int(nrows.max())


@pytest.mark.parametrize("case", PRESOLVE_CASES)
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_twin_presolve_cases(twin, wide, case):
    """K5's warp pick and fused scan-and-scatter, the warp emulated
    serially and the writes made tail first and then from the last mate
    to the first (so a slot written twice shows), against the plain pick
    and compaction: the flat rows, each mate's count, no slot left
    unwritten and none written past the flat rows."""
    from centrifuge_tpu_torch.classify.engine import (
        presolve_pick_rows_plain, presolve_rows_plain)
    hits, khits, rk = presolve_case(case, wide)
    args = (khits, max(khits, 5) * 40, 22, rk)
    _, nrows = presolve_pick_rows_plain(*hits, *args)
    flat, t_n = twin_presolve(twin, *hits, *args)
    assert torch.equal(t_n, nrows)
    assert torch.equal(flat, presolve_rows_plain(*hits, *args))
    total = int(nrows.sum())
    if case == "ties":      # fw 50, rc 700, fw 100; rc 900 past mghs
        assert flat[:7].tolist() == [50, 51, 700, 701, 100, 101, 102]
    if case == "mghs":
        assert nrows.tolist() == [6, 2, 0, 0]
    if case == "clip":
        assert nrows.tolist()[:3] == [64, 0, 3] and total < flat.numel()
    if case == "past_n":    # rows dropped, no zero tail
        assert total > flat.numel() and bool((flat != 0).all())
    if case in ("ties", "mghs", "clip"):     # a zero tail
        assert bool((flat[total:] == 0).all()) and total < flat.numel()


def twin_shard_search(lib, index, reads, lengths, start, mh, min_hitlen,
                      increment, first_hit_only):
    """K6's search lane loop over the shards of a one-row CPU MeshIndex
    (from the descriptor csrc/sharded.cu takes), on the host: (the 6
    outputs of sharded_search, the longest lane's count of table
    reads)."""
    from centrifuge_tpu_torch.parallel.sharded import shard_descriptor
    L = reads.shape[0]
    outs = [torch.empty((L, mh), dtype=index.row_dtype),
            torch.empty((L, mh), dtype=index.row_dtype),
            torch.empty((L, mh), dtype=torch.int32),
            torch.empty((L, mh), dtype=torch.int32),
            torch.empty(L, dtype=torch.int32),
            torch.empty(L, dtype=torch.int32)]
    desc = shard_descriptor(index, index.rows[0])
    fn = lib.twin_shard_search_wide if index.wide \
        else lib.twin_shard_search_narrow
    most = fn(desc.ctypes.data, ptr(reads), reads.shape[1], ptr(lengths),
              ptr(start), *[ptr(o) for o in outs], L, mh, min_hitlen,
              increment, int(first_hit_only))
    return outs, most


def twin_shard_resolve(lib, index, rows, max_steps):
    """K6's walk lane loop over the shards of a one-row CPU MeshIndex, on
    the host: (int32 values, the longest walk's rounds of table
    reads)."""
    from centrifuge_tpu_torch.parallel.sharded import shard_descriptor
    row = index.rows[0]
    out = torch.empty(rows.shape, dtype=torch.int32)
    desc = shard_descriptor(index, row)
    fn = lib.twin_shard_resolve_wide if index.wide \
        else lib.twin_shard_resolve_narrow
    most = fn(desc.ctypes.data, ptr(row.brows), ptr(row.brefs),
              row.brows.numel(), index.offrate, int(index.npat <= 0xFFFF),
              max_steps, ptr(rows), ptr(out), rows.numel())
    return out, most


def sharded_arrays(idx, n_fm, wide):
    """ShardedFMArrays.build, or, for an fm axis that does not divide the
    ftab (3), the one-shard arrays with each table padded by hand to a
    multiple of n_fm: ragged shards whose last holds padding, and keys
    past the padded tables that no shard owns."""
    import dataclasses

    from centrifuge_tpu_torch.parallel.sharded import (ShardedFMArrays,
                                                       _pad_to)
    if (1 << (2 * idx.ftab_chars)) % n_fm == 0:
        return ShardedFMArrays.build(idx, n_fm, wide=wide)
    one = ShardedFMArrays.build(idx, 1, wide=wide)
    return dataclasses.replace(
        one, n_fm=n_fm, blocks=_pad_to(one.blocks, n_fm),
        ftab_tb=_pad_to(one.ftab_tb, n_fm), offs=_pad_to(one.offs, n_fm))


@pytest.mark.parametrize("n_fm,wide", [(2, False), (4, True), (3, False)],
                         ids=["fm2_narrow", "fm4_wide", "fm3_ragged"])
def test_twin_sharded_matches_plain(twin, port_index, n_fm, wide):
    """K6's lane loops (search_lane, resolve_row over the shard reader),
    run on the host over n_fm shards, against the plain sharded search
    (full scans at min_hitlen 16 and 22, first hits from offsets) and
    walk (full budget and cut to 4 LF steps), and the search against the
    one-device loop without the depth-12 prime on the same index (same
    outputs, same count of table reads); each lane's count of table
    reads stays within the lockstep loop's step bound. The ragged fm=3
    shards add rows past the padded block and sample tables, which no
    shard owns."""
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex, walk_budget
    from centrifuge_tpu_torch.parallel.sharded import (
        MeshIndex, make_mesh, sharded_resolve_plain, sharded_search_plain)
    sh = sharded_arrays(port_index, n_fm, wide)
    index = MeshIndex(sh, make_mesh(1, n_fm, ["cpu"] * n_fm))
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    seqs = []
    for r in read_batch([fixture_path("synth", "reads_n.fq")], limit=128):
        seqs += [r.seq, r.revcomp()]
    rseqp, lengths = BatchSearchEngine(index).pack_transport(seqs, 160,
                                                             len(seqs))
    reads, lens = torch.from_numpy(rseqp), torch.from_numpy(lengths)
    zero = torch.zeros(len(seqs), dtype=torch.int32)
    offs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 90, len(seqs)).astype(np.int32))
    for mhl, start, mh, first in ((16, zero, 16, False),
                                  (22, zero, 16, False),
                                  (22, offs, 1, True)):
        args = (reads, lens, start, mh, mhl,
                10 if 2 * mhl <= 33 else 2 * mhl - 33, first)
        want = sharded_search_plain(index, *args)
        got, most = twin_shard_search(twin, index, *args)
        one_most = []
        one = twin_search(twin, fm, *args, False, reads_out=one_most)
        for g, w, o in zip(got, want, one):
            assert torch.equal(g, w) and torch.equal(g, o)
        assert 0 < most < 4 * reads.shape[1]
        assert most == one_most[0]
    rng = np.random.default_rng(6)
    rows_np = np.concatenate([_edge_rows(port_index.bwt_len, sh.zoff, rng),
                              sh.boundary_rows])
    rows_np = rows_np[rows_np < port_index.bwt_len]
    if n_fm == 3:
        # past the padded block table (its block no shard owns), and a
        # sampled row whose sample index is past the padded sample table
        past = [512 * sh.blocks.shape[0], 512 * sh.blocks.shape[0] + 7,
                sh.offs.shape[0] << sh.offrate]
        rows_np = np.concatenate([rows_np, past])
    rows = torch.from_numpy(rows_np.astype(np.int64 if wide else np.int32))
    for max_steps in (4096, 1):
        want = sharded_resolve_plain(index, rows, max_steps)
        got, most = twin_shard_resolve(twin, index, rows, max_steps)
        assert torch.equal(got, want)
        assert bool((want < 0).any()) == (max_steps == 1)
        assert most <= walk_budget(max_steps, 4) + 1
