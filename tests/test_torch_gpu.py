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


def test_misaligned_tables_raise(cuda, port_index):
    """K1 and K3 read the block and ftab tables in 16-byte chunks: a
    table that is a sliced view off that alignment raises before any
    launch, and the kernel never reads it."""
    import dataclasses

    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify.engine import search_lanes
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex, resolve_rows
    fm = DeviceFMIndex.build(port_index, device=cuda, deep_ftab=True)

    def shifted(t):   # the same rows, 4 bytes off the table's alignment
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

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
    assert _cuda.LAUNCHES["search"] == 0 and _cuda.LAUNCHES["resolve"] == 0


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
