"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: each test decides inside the `cuda` fixture whether
a card is present and skips without one. The module needs neither jax
nor tests/conftest.py (which imports jax), so on a machine with an H100,
nvcc and no jax:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SYNTH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "synth")


# ---- inputs shared with the CPU twin tests (tests/test_torch_twin.py) ----

def random_hits(M, mh, wide, seed):
    """Hit buffers [2M, mh] with repeated sizes and lengths (ties of the
    pick's sort key), empty and unused slots, one-row ranges, sizes past
    2^18 and past ihits."""
    rng = np.random.default_rng(seed)
    L = 2 * M
    top = rng.integers(0, 1 << 20, (L, mh))
    size = rng.choice([0, 1, 1, 2, 3, 7, 40, 199, 250, 1 << 19], (L, mh))
    ln = rng.choice([0, 10, 22, 23, 23, 30, 40, 60], (L, mh))
    empty = rng.random((L, mh)) < 0.2
    top[empty] = -1
    bot = np.where(empty, -1, top + size)
    dt = np.int64 if wide else np.int32
    return (torch.from_numpy(top.astype(dt)),
            torch.from_numpy(bot.astype(dt)),
            torch.from_numpy(ln.astype(np.int32)))


def ftab12_cases(fm, n, rng):
    """Level-1 ranges (i1, parent non-empty, lt, lb) that each guard of
    K4 decides: ends in one block row (read once) and in two; the '$'
    row strictly inside, at the top end and just below the bottom end;
    ends at a row's first and last base and at the BWT's end; an empty
    depth-10 parent under a non-empty range; empty and inverted level-1
    ranges; random ranges. Distinct depth-10 parents."""
    z = fm.zoff
    k = (z >> 9) - 3
    cases = [(True, 512 * k + 3, 512 * k + 200),       # one row
             (True, 100, 5000),                          # two rows
             (True, z - 5, z + 3), (True, z - 700, z + 900),  # '$' inside
             (True, z, z + 1), (True, z - 1, z),         # '$' at an end
             (True, 512 * k, 512 * k + 511), (True, 512 * k - 1, n),
             (False, 10, 900), (False, z - 5, z + 3),    # empty parent
             (True, 700, 700), (True, 900, 800)]         # empty level 1
    lo = rng.integers(0, n, 400)
    hi = np.minimum(lo + rng.integers(1, 3000, 400), n)
    cases += [(True, int(a), int(b)) for a, b in zip(lo, hi)]
    e10 = rng.choice(1 << 20, len(cases), replace=False)
    c10 = rng.integers(0, 4, len(cases))
    return [(int(e | c << 20), p, min(max(lt, 0), n), min(max(lb, 0), n))
            for (p, lt, lb), e, c in zip(cases, e10, c10)]


FTAB12_FILL = -3   # the packed table's words before K4 writes it


def ftab12_case_inputs(fm, seed):
    """K4's inputs for ftab12_cases on fm's index: (t0, b0 [2^20]; t1,
    b1 [2^22], every other range empty; the packed table expected when
    it starts filled with FTAB12_FILL: each case's four entries the
    plain LF of both ends, or (0, 0) under the guards, every other entry
    (0, 0), columns 32 and up keeping the fill; which cases extend)."""
    n = fm.bwt_len
    from centrifuge_tpu_torch.ops.fm_torch import N10
    from centrifuge_tpu_torch.ops.rank import lf
    rdt = fm.row_dtype
    cases = ftab12_cases(fm, n, np.random.default_rng(seed))
    t0 = torch.zeros(N10, dtype=rdt)
    b0 = torch.zeros(N10, dtype=rdt)
    t1 = torch.zeros(4 * N10, dtype=rdt)
    b1 = torch.zeros(4 * N10, dtype=rdt)
    items = np.array([c[0] for c in cases], dtype=np.int64)
    for i1, parent, lt, lb in cases:
        b0[i1 & (N10 - 1)] = 7 if parent else 3
        t0[i1 & (N10 - 1)] = 3
        t1[i1], b1[i1] = lt, lb
    per = 8 if fm.wide else 16
    want = torch.full(((1 << 24) // per, fm.blocks.shape[1]), FTAB12_FILL,
                      dtype=torch.int32)
    want[:, :32] = 0
    it = torch.from_numpy(items)
    lt = t1[it].to(torch.int64)
    lb = b1[it].to(torch.int64)
    live = (b0[it & (N10 - 1)] > t0[it & (N10 - 1)]) & (lb > lt)
    blocks, fchr = fm.blocks.cpu(), fm.fchr.cpu()
    lo32 = np.uint64(0xFFFFFFFF)
    for c11 in range(4):
        ch = torch.full((len(cases),), c11, dtype=torch.int32)
        top = torch.where(live, lf(blocks, fchr, fm.zoff, lt.to(rdt), ch
                                   ).to(torch.int64), 0)
        bot = torch.where(live, lf(blocks, fchr, fm.zoff, lb.to(rdt), ch
                                   ).to(torch.int64), 0)
        t, b = top.numpy().astype(np.uint64), bot.numpy().astype(np.uint64)
        words = np.stack([t & lo32, t >> np.uint64(32), b & lo32,
                          b >> np.uint64(32)] if fm.wide
                         else [t & lo32, b & lo32],
                         axis=1).astype(np.uint32).view(np.int32)
        idx = it | (c11 << 22)
        rows, col = idx // per, (idx % per) * (32 // per)
        for j in range(32 // per):
            want[rows, col + j] = torch.from_numpy(words[:, j].copy())
    return t0, b0, t1, b1, want, live


def level1_cases(fm, seed):
    """Depth-10 ranges (t0, b0) in the row dtype for K0's level 1, from
    ftab12_cases' ends: in one block row and in two, the '$' row inside
    and at either end, ends at a row's first and last base (within 0 and
    511) and at the BWT's end, empty and inverted ranges, random ranges;
    412 of them, so a warp's last chunk is part empty."""
    cases = ftab12_cases(fm, fm.bwt_len, np.random.default_rng(seed))
    dt = np.int64 if fm.wide else np.int32
    return (torch.from_numpy(np.array([c[2] for c in cases], dt)),
            torch.from_numpy(np.array([c[3] for c in cases], dt)))


def mate_hits(mates, mh, wide):
    """Hit buffers [2M, mh] from per-mate lists of (strand, slot, top,
    size, len); every other slot empty (-1, -1, 0)."""
    L = 2 * len(mates)
    top = np.full((L, mh), -1, np.int64)
    bot = np.full((L, mh), -1, np.int64)
    ln = np.zeros((L, mh), np.int32)
    for m, hits in enumerate(mates):
        for strand, slot, t, size, length in hits:
            top[2 * m + strand, slot] = t
            bot[2 * m + strand, slot] = t + size
            ln[2 * m + strand, slot] = length
    dt = np.int64 if wide else np.int32
    return (torch.from_numpy(top.astype(dt)),
            torch.from_numpy(bot.astype(dt)), torch.from_numpy(ln))


def presolve_case(name, wide):
    """(hits, khits, rk) of a K5 case. `ties`: equal keys on both strands
    of equal score, fw first; `mghs`: a third hit past the
    max_genome_hit_size budget; `clip`: a hit of more rows than rk
    before a mate with rows; `past_n`: more rows than the 4 M flat
    slots, so rows drop and no zero tail is left; random hits with M not
    a multiple of the block's 32 mates, and M = 1, at mh 16, 4 and 1."""
    if name == "ties":
        mates = [[(0, 0, 100, 3, 30), (1, 2, 900, 3, 30), (0, 1, 50, 2, 40),
                  (1, 0, 700, 2, 40)], [], [], []]
        return mate_hits(mates, 4, wide), 5, 16
    if name == "mghs":
        mates = [[(0, 0, 100, 3, 30), (0, 1, 200, 3, 29), (0, 2, 300, 3, 28)],
                 [(1, 3, 400, 2, 50)], [], []]
        return mate_hits(mates, 4, wide), 5, 16
    if name == "clip":
        mates = [[(0, 0, 1000, 150, 60)], [], [(0, 0, 5000, 3, 30)]] \
            + [[]] * 37
        return mate_hits(mates, 16, wide), 16, 64
    if name == "past_n":
        mates = [[(0, s, 1000 * (s + 1) + 10 * m, 7, 30 + s) for s in range(3)]
                 for m in range(40)]
        return mate_hits(mates, 4, wide), 16, 64
    M, mh = {"mh16_m45": (45, 16), "mh4_m77": (77, 4), "mh1_m64": (64, 1),
             "mh16_m1": (1, 16)}[name]
    return random_hits(M, mh, wide, seed=M), 16, 64


PRESOLVE_CASES = ["ties", "mghs", "clip", "past_n", "mh16_m45", "mh4_m77",
                  "mh1_m64", "mh16_m1"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(os.path.join(SYNTH, "synth"))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_kernels_match_plain(cuda, port_index, wide):
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes,
                                                      search_plain)
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import (N10, DeviceFMIndex,
                                                   ftab12_plain)
    from centrifuge_tpu_torch.ops.rank import rank, rank_plain
    _cuda.reset_launches()
    fm = DeviceFMIndex.build(port_index, device=cuda, wide=wide,
                             deep_ftab=True)
    assert _cuda.LAUNCHES["ftab12"] == 1 and _cuda.LAUNCHES["rank"] == 1
    plain = torch.zeros_like(fm.ftab12_rows)
    ftab12_plain(fm.blocks, fm.fchr, fm.zoff, fm.ftab_top[:N10],
                 fm.ftab_bot[:N10], plain)
    assert torch.equal(plain, fm.ftab12_rows)

    g = np.random.default_rng(2)
    rows = torch.from_numpy(g.integers(0, port_index.bwt_len + 1, 65536)
                            .astype(np.int64 if wide else np.int32)).to(cuda)
    chars = torch.from_numpy(g.integers(0, 4, 65536).astype(np.int32)
                             ).to(cuda)
    assert torch.equal(rank(fm.blocks, fm.zoff, rows, chars),
                       rank_plain(fm.blocks, fm.zoff, rows, chars
                                  ).to(rows.dtype))

    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")]):
        seqs += [r.seq, r.revcomp()]
    eng = BatchSearchEngine(fm, 22)
    # every lane, then ragged counts of lanes that leave the persistent
    # grid's last block part empty (1 and 2 lanes: one block), at both
    # min_hitlens, overflowing lanes (mh 4) and first hits from offsets
    g = np.random.default_rng(3)
    cases = [(len(seqs), 16, 22, False), (1, 16, 22, False),
             (2, 1, 22, True), (127, 4, 16, False), (4097, 16, 16, False),
             (4097, 1, 22, True)]
    _cuda.reset_launches()
    for L, mh, mhl, first in cases:
        lanes = [seqs[i % len(seqs)] for i in range(L)]
        rseqp, lengths = eng.pack_transport(lanes, 160, L)
        start = g.integers(0, 90, L).astype(np.int32) if first \
            else np.zeros(L, np.int32)
        args = (fm, torch.from_numpy(rseqp).to(cuda),
                torch.from_numpy(lengths).to(cuda),
                torch.from_numpy(start).to(cuda), mh, mhl,
                10 if 2 * mhl <= 33 else 2 * mhl - 33, first, True)
        got = search_lanes(*args)
        for k, p in zip(got, search_plain(*args)):
            assert torch.equal(k, p)
        if mh == 4:
            assert int(got[4].max()) > mh   # lanes past mh hits
        cfg = _cuda.persistent_config("search", wide, L)
        assert cfg["tile"] > 1
        assert cfg["grid"] == min(cfg["resident_blocks"], -(-L * cfg["tile"]
                                                            // cfg["threads"]))
    assert _cuda.LAUNCHES["search"] == len(cases)
    assert _cuda.persistent_config("search", wide, 2)["grid"] == 1


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_ftab12_kernel_cases_match_plain(cuda, port_index, wide):
    """K4's launch on the chosen level-1 ranges of ftab12_cases (ends in
    one row and two, the '$' row inside and at an end, empty parents,
    empty level-1 ranges): the table equals the plain LF's, every other
    entry (0, 0), columns 32 and up untouched; one launch, no K0; the
    launch shape a tile of more than one thread a range on a persistent
    grid."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.ops.fm_torch import (N10, DeviceFMIndex,
                                                   ftab12_level2)
    fm = DeviceFMIndex.build(port_index, device=cuda, wide=wide,
                             deep_ftab=False)
    t0, b0, t1, b1, want, live = ftab12_case_inputs(fm, 61)
    out = torch.full_like(want, FTAB12_FILL).to(cuda)
    _cuda.reset_launches()
    ftab12_level2(fm.blocks, fm.fchr, fm.zoff, t0.to(cuda), b0.to(cuda),
                  t1.to(cuda), b1.to(cuda), out)
    assert _cuda.LAUNCHES["ftab12"] == 1 and _cuda.LAUNCHES["rank"] == 0
    assert torch.equal(out.cpu(), want)
    assert bool(live.any()) and not bool(live.all())
    cfg = _cuda.persistent_config("ftab12", wide, 4 * N10)
    assert cfg["tile"] > 1
    assert cfg["grid"] == min(cfg["resident_blocks"],
                              -(-4 * N10 * cfg["tile"] // cfg["threads"]))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_presolve_kernel_cases_match_plain(cuda, wide):
    """K5's one launch (a warp a mate, the block scan, the look-back over
    blocks, the scatter and the zero tail) on the cases of
    presolve_case (ties across strands, the mghs cut, the clip to rk,
    more rows than slots, mh 16, 4 and 1, M not a multiple of 32, M = 1)
    and on 32,768 and 100,000 mates of random hits (more blocks than the
    card keeps resident): the flat rows equal the plain pick and
    compaction's; one launch a call."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import (presolve_rows,
                                                      presolve_rows_plain)
    cases = [presolve_case(c, wide) for c in PRESOLVE_CASES]
    cases += [(random_hits(32768, 16, wide, 9), 5, 16),
              (random_hits(100_000, 16, wide, 10), 16, 64)]
    _cuda.reset_launches()
    for hits, khits, rk in cases:
        args = (khits, max(khits, 5) * 40, 22, rk)
        got = presolve_rows(*(h.to(cuda) for h in hits), *args)
        assert torch.equal(got.cpu(), presolve_rows_plain(*hits, *args))
    assert _cuda.LAUNCHES["presolve"] == len(cases)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_rank_kernels_match_plain(cuda, port_index, wide):
    """K0's two entries against their plain versions on the synth index:
    the generic kernel (a tile a query) on every char at the edge rows
    and on 65,536 random pairs, rank and LF; the level-1 entry (a tile a
    depth-10 range) on the index's 2^20 ranges, equal there also to the
    generic kernel's LF of the same pairs under the empty-parent guard,
    and on level1_cases. Each call is one launch."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.ops.fm_torch import N10, DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import (level1, level1_plain, lf,
                                               rank, rank_plain)
    fm = DeviceFMIndex.build(port_index, device=cuda, wide=wide,
                             deep_ftab=False)
    blocks, fchr, z = fm.blocks.cpu(), fm.fchr.cpu(), fm.zoff
    n = port_index.bwt_len
    edges = [0, 1, 15, 16, 17, 63, 64, 255, 256, 511, 512, 513, z - 1, z,
             z + 1, n - 1, n]
    g = np.random.default_rng(8)
    dt = np.int64 if wide else np.int32
    rows = torch.from_numpy(np.concatenate(
        [np.repeat(edges, 4), g.integers(0, n + 1, 65536)]).astype(dt))
    chars = torch.from_numpy(np.concatenate(
        [np.tile(np.arange(4), len(edges)),
         g.integers(0, 4, 65536)]).astype(np.int32))
    _cuda.reset_launches()
    got = rank(fm.blocks, z, rows.to(cuda), chars.to(cuda))
    assert torch.equal(got.cpu(), rank_plain(blocks, z, rows, chars
                                             ).to(rows.dtype))
    got = lf(fm.blocks, fm.fchr, z, rows.to(cuda), chars.to(cuda))
    assert torch.equal(got.cpu(), lf(blocks, fchr, z, rows, chars))
    t0, b0 = fm.ftab_top[:N10].contiguous(), fm.ftab_bot[:N10].contiguous()
    got = level1(fm.blocks, fm.fchr, z, t0, b0)
    want = level1_plain(blocks, fchr, z, t0.cpu(), b0.cpu())
    for k, w in zip(got, want):
        assert torch.equal(k.cpu(), w)
    pairs = torch.cat([t0.repeat(4), b0.repeat(4)])
    codes = torch.arange(4, dtype=torch.int32, device=cuda
                         ).repeat_interleave(N10).repeat(2)
    assert torch.equal(torch.cat(got), torch.where(
        (b0 > t0).repeat(8), lf(fm.blocks, fm.fchr, z, pairs, codes), 0))
    ct0, cb0 = level1_cases(fm, 9)
    got = level1(fm.blocks, fm.fchr, z, ct0.to(cuda), cb0.to(cuda))
    want = level1_plain(blocks, fchr, z, ct0, cb0)
    for k, w in zip(got, want):
        assert torch.equal(k.cpu(), w)
    assert _cuda.LAUNCHES["rank"] == 5


def shifted(t):
    """The same rows, 4 bytes off the table's 16-byte alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def test_rank_wrappers_refuse_bad_inputs(cuda, port_index):
    """K0's entries read the block table in 16-byte chunks: a misaligned
    table raises, as do rows, chars, fchr or ranges of the wrong type or
    shape; nothing is launched."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.ops.fm_torch import N10, DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import level1, rank
    fm = DeviceFMIndex.build(port_index, device=cuda, deep_ftab=False)
    rows = torch.arange(64, dtype=torch.int32, device=cuda)
    chars = torch.zeros(64, dtype=torch.int32, device=cuda)
    t0, b0 = fm.ftab_top[:N10].contiguous(), fm.ftab_bot[:N10].contiguous()
    _cuda.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        rank(shifted(fm.blocks), fm.zoff, rows, chars)
    with pytest.raises(ValueError, match="16-byte aligned"):
        level1(shifted(fm.blocks), fm.fchr, fm.zoff, t0, b0)
    for bad in ((rows.to(torch.int64), chars), (rows, chars.to(torch.int64)),
                (rows, chars[:32])):
        with pytest.raises(ValueError):
            rank(fm.blocks, fm.zoff, *bad)
    with pytest.raises(ValueError):
        rank(fm.blocks, fm.zoff, rows, chars, fchr=fm.fchr.to(torch.int64))
    for bad in ((t0, b0.to(torch.int64)), (t0.view(2, -1), b0.view(2, -1)),
                (t0, b0[:64])):
        with pytest.raises(ValueError):
            level1(fm.blocks, fm.fchr, fm.zoff, *bad)
    assert _cuda.LAUNCHES["rank"] == 0


def test_misaligned_tables_raise(cuda, port_index):
    """K1, K3 and K4 read the block and ftab tables in 16-byte chunks (K4
    stores whole entries): a table that is a sliced view off that
    alignment raises before any launch, and the kernel never reads it."""
    import dataclasses

    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import search_lanes
    from centrifuge_tpu_torch.ops.fm_torch import (N10, DeviceFMIndex,
                                                   ftab12_level2,
                                                   resolve_rows)
    fm = DeviceFMIndex.build(port_index, device=cuda, deep_ftab=True)
    L = 8
    args = (torch.zeros((L, 80), dtype=torch.uint8, device=cuda),
            torch.full((L,), 100, dtype=torch.int32, device=cuda),
            torch.zeros(L, dtype=torch.int32, device=cuda), 16, 22, 11,
            False, True)
    rows = torch.arange(8, dtype=torch.int32, device=cuda)
    _cuda.reset_launches()
    for name in ("blocks", "ftab_rows", "ftab12_rows"):
        bad = dataclasses.replace(fm, **{name: shifted(getattr(fm, name))})
        with pytest.raises(ValueError, match="16-byte aligned"):
            search_lanes(bad, *args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        resolve_rows(dataclasses.replace(fm, blocks=shifted(fm.blocks)),
                     rows)
    # K4 reads the block table in 16-byte chunks and stores whole entries
    lvl = [torch.zeros(n, dtype=fm.row_dtype, device=cuda)
           for n in (N10, N10, 4 * N10, 4 * N10)]
    for bad_blocks, bad_out in ((True, False), (False, True)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ftab12_level2(shifted(fm.blocks) if bad_blocks else fm.blocks,
                          fm.fchr, fm.zoff, *lvl,
                          shifted(fm.ftab12_rows) if bad_out
                          else fm.ftab12_rows.clone())
    assert _cuda.LAUNCHES["search"] == 0 and _cuda.LAUNCHES["resolve"] == 0
    assert _cuda.LAUNCHES["ftab12"] == 0


def test_wrapper_refuses_mixed_devices(cuda, port_index):
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.ops.rank import rank
    fm = DeviceFMIndex.build(port_index, device=cuda, deep_ftab=False)
    rows = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rank(fm.blocks, fm.zoff, rows, torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_resolve_and_presolve_match_plain(cuda, port_index, wide):
    """K3 on the edge rows and 65,536 random rows (full step budget and
    max_steps=1), K5 + K3 on the first-pass hits of the synth lanes
    (khits 5 and 16), and make_resolver's numpy round trip."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      presolve_lanes,
                                                      presolve_plain,
                                                      presolve_rk,
                                                      search_lanes)
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import (DeviceFMIndex,
                                                   make_resolver,
                                                   resolve_rows,
                                                   resolve_rows_plain)
    fm = DeviceFMIndex.build(port_index, device=cuda, wide=wide,
                             deep_ftab=False)
    g = np.random.default_rng(4)
    rows_np = np.concatenate([
        [0, port_index.zoff, port_index.bwt_len - 1],
        port_index.boundary_rows.astype(np.int64),
        g.integers(0, port_index.bwt_len, 65536)]).astype(
            np.int64 if wide else np.int32)
    rows = torch.from_numpy(rows_np).to(cuda)
    _cuda.reset_launches()
    for steps in (4096, 1):
        want = resolve_rows_plain(fm, rows, steps)
        assert torch.equal(resolve_rows(fm, rows, steps), want)
        assert bool((want < 0).any()) == (steps == 1)
    # ragged row counts through the persistent grid and its counter: one
    # row, a part-filled grid, and one row past a full 131,072
    for n in (1, 1000, 131073):
        more = torch.from_numpy(g.integers(0, port_index.bwt_len, n).astype(
            np.int64 if wide else np.int32)).to(cuda)
        for steps in (4096, 1):
            assert torch.equal(resolve_rows(fm, more, steps),
                               resolve_rows_plain(fm, more, steps))
        cfg = _cuda.persistent_config("resolve", wide, n)
        assert cfg["tile"] > 1
        assert cfg["grid"] == min(cfg["resident_blocks"], -(-n * cfg["tile"]
                                                            // cfg["threads"]))
    assert _cuda.LAUNCHES["resolve"] == 8
    np.testing.assert_array_equal(make_resolver(fm)(rows_np),
                                  resolve_rows_plain(fm, rows).cpu().numpy())

    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")]):
        seqs += [r.seq, r.revcomp()]
    eng = BatchSearchEngine(fm, 22)
    rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
    hits = search_lanes(fm, torch.from_numpy(rseqp).to(cuda),
                        torch.from_numpy(lengths).to(cuda),
                        torch.zeros(len(seqs), dtype=torch.int32,
                                    device=cuda), 16, 22, eng.increment,
                        False, False)
    for khits in (5, 16):
        args = (fm, hits[0], hits[1], hits[3], khits, max(khits, 5) * 40,
                22, presolve_rk(khits))
        for k, p in zip(presolve_lanes(*args), presolve_plain(*args)):
            assert torch.equal(k, p)
    assert _cuda.LAUNCHES["presolve"] == 2


def test_presolve_dispatch_matches_cpu_engine(cuda, port_index):
    """search_async(presolve=True) + search_collect on the card against
    the same engine on the CPU: the 6 arrays and the prefetch."""
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")], limit=200):
        seqs += [r.seq, r.revcomp()]
    outs = []
    for dev in (cuda, "cpu"):
        eng = BatchSearchEngine(DeviceFMIndex.build(port_index, device=dev,
                                                    deep_ftab=False))
        outs.append(eng.search_collect(eng.search_async(seqs, presolve=True),
                                       len(seqs)))
    (got, gpre), (want, wpre) = outs
    for g, w in zip(got + list(gpre), want + list(wpre)):
        np.testing.assert_array_equal(g, w)


def test_threads_share_the_card(cuda, port_index):
    """The device-resolve tail's pattern under contention: 12 threads
    (more than the host's cores), each in turn dispatching a presolve
    search and collecting it, or resolving rows under engine.dev_lock and
    searching first hits, with a short switch interval; every result
    equals the one made alone."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import (DeviceFMIndex,
                                                   make_resolver)
    fm = DeviceFMIndex.build(port_index, device=cuda, deep_ftab=False)
    eng = BatchSearchEngine(fm)
    resolve = make_resolver(fm)
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads.fq")], limit=128):
        seqs += [r.seq, r.revcomp()]
    g = np.random.default_rng(8)
    rows = g.integers(0, port_index.bwt_len, 4096).astype(np.int32)
    offs = np.array([g.integers(0, len(s)) for s in seqs], np.int32)

    def searched():
        out, pre = eng.search_collect(eng.search_async(seqs, presolve=True),
                                      len(seqs))
        return out + list(pre)

    def resolved():
        with eng.dev_lock:
            values = resolve(rows)
        return [values] + eng.search_first_hits(seqs, offs)

    want = {0: searched(), 1: resolved()}

    def work(i):
        for k in range(6):
            kind = (i + k) % 2
            got = searched() if kind == 0 else resolved()
            for a, b in zip(got, want[kind]):
                np.testing.assert_array_equal(a, b)
        return True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=12) as ex:
            futs = [ex.submit(work, i) for i in range(12)]
            assert all(f.result(timeout=300) for f in futs)
    finally:
        sys.setswitchinterval(old)


def test_staged_uploads_match_plain(cuda, port_index):
    """Every upload from page-locked memory, on the synth index, against
    the same engine on the CPU (search_plain): four presolve dispatches,
    each a different pack, launched before any is fetched and collected
    in reverse (a block handed out again while a copy from it is in
    flight would show), each with an overflow re-run (FIRST_MAX_HITS 4),
    then first hits from nonzero offsets. Every uploaded byte counted as
    staged; the card's zero start made once and kept."""
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")], limit=500):
        seqs += [r.seq, r.revcomp()]
    batches = [seqs[97 * k:] + seqs[:97 * k] for k in range(4)]
    g = np.random.default_rng(11)
    offs = np.array([g.integers(1, len(s)) for s in seqs], np.int32)
    outs = []
    for dev in (cuda, "cpu"):
        eng = BatchSearchEngine(DeviceFMIndex.build(port_index, device=dev,
                                                    deep_ftab=True))
        eng.FIRST_MAX_HITS = 4
        handles = [eng.search_async(b, presolve=True) for b in batches]
        got = {}
        for k in reversed(range(4)):
            out, pre = eng.search_collect(handles[k], len(seqs))
            assert int(out[4].max()) > 4    # the re-run path ran
            got[k] = out + list(pre)
        outs.append([a for k in range(4) for a in got[k]]
                    + eng.search_first_hits(seqs, offs))
        st = eng.stats
        if dev == cuda:
            assert all(torch.from_numpy(a).is_pinned() for h in handles
                       for a in (h.rseqp, h.lengths))
            zeros = eng._zeros
            eng.search(seqs[:300])
            assert eng._zeros is zeros and not bool(zeros.any())
            assert st["staged_upload_bytes"] == st["upload_bytes"] > 0
        else:
            assert st["staged_upload_bytes"] == 0 < st["upload_bytes"]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dp,n_fm,wide", [(1, 2, False), (2, 2, True),
                                          (1, 4, False), (1, 4, True)])
def test_sharded_kernels_match_plain(cuda, port_index, dp, n_fm, wide):
    """K6 with every shard on one card (a mesh that repeats cuda:0): the
    search on the synth lanes (min_hitlen 16 and 22, and first-hit mode
    from offsets) and the resolve walk on the edge rows and 65,536 random
    rows (full budget and max_steps=1), each against its plain version on
    the same card, and the search against K1 on the unsharded index.
    Each call launches each kernel once per dp row."""
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes)
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.parallel.sharded import (
        MeshIndex, ShardedFMArrays, make_mesh, sharded_resolve,
        sharded_resolve_plain, sharded_search, sharded_search_plain)
    index = MeshIndex(ShardedFMArrays.build(port_index, n_fm, wide=wide),
                      make_mesh(dp, n_fm, [cuda] * (dp * n_fm)))
    fm = DeviceFMIndex.build(port_index, device=cuda, wide=wide,
                             deep_ftab=False)
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")]):
        seqs += [r.seq, r.revcomp()]
    eng = BatchSearchEngine(fm, 22)
    rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
    reads = torch.from_numpy(rseqp).to(cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    zero = torch.zeros(len(seqs), dtype=torch.int32, device=cuda)
    offs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 90, len(seqs)).astype(np.int32)).to(cuda)
    _cuda.reset_launches()
    for mhl, st, mh, first in ((16, zero, 16, False), (22, zero, 16, False),
                               (22, offs, 1, True)):
        inc = 10 if 2 * mhl <= 33 else 2 * mhl - 33
        args = (reads, lens, st, mh, mhl, inc, first)
        got = sharded_search(index, *args)
        for k, p, s in zip(got, sharded_search_plain(index, *args),
                           search_lanes(fm, *args, False)):
            assert torch.equal(k, p) and torch.equal(k, s)
    assert _cuda.LAUNCHES["sharded_search"] == 3 * dp
    g = np.random.default_rng(4)
    rows = torch.from_numpy(np.concatenate([
        [0, port_index.zoff, port_index.bwt_len - 1],
        port_index.boundary_rows.astype(np.int64),
        g.integers(0, port_index.bwt_len, 65536)])[:65536 + 24].astype(
            np.int64 if wide else np.int32)).to(cuda)
    for steps in (4096, 1):
        want = sharded_resolve_plain(index, rows, steps)
        assert torch.equal(sharded_resolve(index, rows, steps), want)
        assert bool((want < 0).any()) == (steps == 1)
    assert _cuda.LAUNCHES["sharded_resolve"] == 2 * dp


def test_sharded_engine_matches_cpu_mesh(cuda, port_index):
    """ShardedSearchEngine on a (2, 2) mesh of cuda:0 against the same
    engine on a CPU mesh: search, first hits and the resolver."""
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.parallel.sharded import (
        MeshIndex, ShardedFMArrays, ShardedSearchEngine, make_mesh,
        make_sharded_resolver)
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")], limit=200):
        seqs += [r.seq, r.revcomp()]
    g = np.random.default_rng(9)
    offs = np.array([g.integers(0, len(s)) for s in seqs], np.int32)
    rows = g.integers(0, port_index.bwt_len, 1000).astype(np.int32)
    sh = ShardedFMArrays.build(port_index, 2)
    outs = []
    for dev in (cuda, "cpu"):
        index = MeshIndex(sh, make_mesh(2, 2, [dev] * 4))
        eng = ShardedSearchEngine(index)
        got, pre = eng.search_collect(eng.search_async(seqs, presolve=True),
                                      len(seqs))
        assert pre is None
        outs.append(got + eng.search_first_hits(seqs, offs)
                    + [make_sharded_resolver(index)(rows)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_sharded_across_cards(cuda, port_index):
    """K6 with its shards, and its dp rows, on different cards (each
    row's kernel reads the other cards' shards through peer mappings):
    the search and the walk against
    their plain versions, and the mesh engine and resolver against the
    same engine on a CPU mesh. Skips on a machine with one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.parallel.sharded import (
        MeshIndex, ShardedFMArrays, ShardedSearchEngine, make_mesh,
        make_sharded_resolver, sharded_resolve, sharded_resolve_plain,
        sharded_search, sharded_search_plain)
    cards = [torch.device("cuda", i) for i in range(n)]
    seqs = []
    for r in read_batch([os.path.join(SYNTH, "reads_n.fq")], limit=256):
        seqs += [r.seq, r.revcomp()]
    g = np.random.default_rng(5)
    rows_np = g.integers(0, port_index.bwt_len, 4096)
    shapes = [(1, min(n, 4)), (n, 1)] + ([(2, 2)] if n >= 4 else [])
    for (dp, nf), wide in zip(shapes, (False, True, True)):
        mesh = make_mesh(dp, nf, cards)
        sh = ShardedFMArrays.build(port_index, nf, wide=wide)
        index = MeshIndex(sh, mesh)
        eng = ShardedSearchEngine(index)
        rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
        args = (torch.from_numpy(rseqp).to(cuda),
                torch.from_numpy(lengths).to(cuda),
                torch.zeros(len(seqs), dtype=torch.int32, device=cuda), 16,
                22, eng.increment, False)
        for k, p in zip(sharded_search(index, *args),
                        sharded_search_plain(index, *args)):
            assert torch.equal(k, p)
        rows = torch.from_numpy(rows_np.astype(
            np.int64 if wide else np.int32)).to(cuda)
        for steps in (4096, 1):
            assert torch.equal(sharded_resolve(index, rows, steps),
                               sharded_resolve_plain(index, rows, steps))
        outs = []
        for ix in (index, MeshIndex(sh, make_mesh(dp, nf,
                                                  ["cpu"] * (dp * nf)))):
            e = ShardedSearchEngine(ix)
            got, _ = e.search_collect(e.search_async(seqs), len(seqs))
            outs.append(got + [make_sharded_resolver(ix)(rows_np.astype(
                np.int64 if wide else np.int32))])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


def test_mesh_without_peer_access_raises(cuda, port_index, monkeypatch):
    """A dp row over two cards without peer access is refused when its
    mesh index is placed, naming both cards, before any table is placed:
    K6 reads the other card's shard in place and has no copy path.
    can_device_access_peer is patched, so this runs on one card."""
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       make_mesh)
    asked = []

    def no_peer(a, b):
        asked.append((a, b))
        return False

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", no_peer)
    other = torch.device("cuda", cuda.index + 1)
    mesh = make_mesh(1, 2, [cuda, other])
    with pytest.raises(RuntimeError, match=f"cuda:{cuda.index} has no peer "
                       f"access to cuda:{other.index}"):
        MeshIndex(ShardedFMArrays.build(port_index, 2), mesh)
    assert asked == [(cuda.index, other.index)]


@pytest.mark.parametrize("host_resolve", [True, False],
                         ids=["host_resolve", "device_resolve"])
def test_prof_times_the_card(cuda, port_index, host_resolve):
    """evaluation/prof.py on the card (two batches of synth reads): the
    search launch alone timed by CUDA events, and the device's idle share
    over a threaded stream, by the profiler or by events, in [0, 1]."""
    from centrifuge_tpu_torch.evaluation import prof
    from centrifuge_tpu_torch.io.fastx import read_batch
    reads = read_batch([os.path.join(SYNTH, "reads.fq")])
    art = prof.profile(port_index, [reads[:1024], reads[1024:2048]],
                       host_resolve=host_resolve, device=cuda, runs=1,
                       steps=False, log=lambda s: None)
    assert art["device"] == str(cuda) and art["nvidia_smi"]
    assert art["device_compute_ms"] > 0
    assert art["device_search_fetch_ms"] > 0
    assert (art["device_presolve_ms"] is None) == host_resolve
    share = art["device_idle_share"]
    assert 0 <= share["value"] <= 1
    assert 0 <= share["events"]["value"] <= 1
    assert share["events"]["dispatches"] >= 2


# cases of chip_smoke.PARITY_CASES that change the lanes K1 and K5 see
# (k 1 and 20, min-hitlen 16, paired k 1, N-laden reads, pairs whose mate
# 1 fails the N filter): a quick check of the parity phase
GPU_PARITY = ("k1", "k20", "minhit16", "paired_k1", "nceil", "nfail_paired")


@pytest.fixture(scope="module")
def parity_shared():
    return {}


@pytest.mark.parametrize("route", ["a", "b"])
@pytest.mark.parametrize("name", GPU_PARITY)
def test_parity_cases_on_the_card(cuda, parity_shared, name, route,
                                  tmp_path):
    """chip_smoke.run_parity_case on the card: the classify CLI's outputs
    byte-equal to the reference goldens on route a (host walk: K1) and
    route b (device resolve: K1, K5, K3)."""
    import chip_smoke
    from centrifuge_tpu_torch import _cuda
    case = next(c for c in chip_smoke.PARITY_CASES if c.name == name)
    _cuda.reset_launches()
    fault = chip_smoke.run_parity_case(chip_smoke.load_port(), case, route,
                                       parity_shared, cuda, str(tmp_path))
    assert fault is None, fault
    assert _cuda.LAUNCHES["search"] > 0
    for k in ("presolve", "resolve"):
        assert (_cuda.LAUNCHES[k] > 0) == (route == "b"), k


def test_graft_entry_on_the_card(cuda):
    """graft_entry.entry(): one K1 launch, equal to the entry's plain
    version on the CPU."""
    from centrifuge_tpu_torch import _cuda, graft_entry
    fn, args = graft_entry.entry()
    assert all(a.is_cuda for a in args if isinstance(a, torch.Tensor))
    _cuda.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["search"] == 1
    cfn, cargs = graft_entry.entry(device="cpu")
    want = cfn(*cargs)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def test_graft_dryrun_on_a_mesh_of_the_card(cuda):
    """graft_entry.dryrun_multichip on a (2, 2) mesh of cuda:0: K6's
    search and no single-device search."""
    from centrifuge_tpu_torch import _cuda, graft_entry
    _cuda.reset_launches()
    graft_entry.dryrun_multichip(4, devices=["cuda:0"] * 4)
    assert _cuda.LAUNCHES["sharded_search"] > 0
    assert _cuda.LAUNCHES["search"] == 0


def test_bench_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """centrifuge_tpu_torch.bench at a reduced size (2,048 reads a batch,
    one trial), its simulations in tmp_path: parity held, the native host
    paths live, K1 launched and timed alone, and no other kernel."""
    import json
    import tempfile
    from centrifuge_tpu_torch import bench
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = bench.main(["--batch", "2048", "--trials", "1"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0
    assert line["parity_ok"] and line["native_ok"]
    assert line["device"] == "cuda" and line["card"]
    assert line["device_batch_lanes"] == 4096
    assert line["device_search_ms_per_batch"] > 0
    assert line["value"] > 0 and line["paired_pairs_per_sec"] > 0
    assert line["launches"]["search"] > 0
    assert not any(v for k, v in line["launches"].items() if k != "search")
