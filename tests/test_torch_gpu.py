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
    rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
    args = (fm, torch.from_numpy(rseqp).to(cuda),
            torch.from_numpy(lengths).to(cuda),
            torch.zeros(len(seqs), dtype=torch.int32, device=cuda), 16, 22,
            eng.increment, False, True)
    for k, p in zip(search_lanes(*args), search_plain(*args)):
        assert torch.equal(k, p)


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
    assert _cuda.LAUNCHES["resolve"] == 2
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
