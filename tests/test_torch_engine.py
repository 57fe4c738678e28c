"""K1, the greedy FM search: the port's plain version and the host build
of its CUDA lane function against the JAX package's search, lane for
lane, on 256 synth reads (both strands), narrow and forced wide,
min_hitlen 16 and 22, with and without the depth-12 prime.

The JAX side is the JAX package's own `search_loop` (the function the
CUDA kernel replaces) over its `direct_kernels`, jitted here with
unroll=1: the loop body is a per-lane transition that is a no-op on done
lanes, so the unroll factor changes only the compile time (about 1 s
here against about 30 s for the engine's unroll of 8), not an output.
Integer outputs: exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import (build_twin, one_torch_thread,  # noqa: F401
                             twin_search)

N_READS = 128      # per input file; 2 files x 2 strands = 512 lanes
JAX_MAX_HITS = 32  # no lane of these reads emits more: no re-run shape


@functools.partial(jax.jit, static_argnames=(
    "min_hitlen", "increment", "max_hits", "first_hit_only", "nblk",
    "nblk12"))
def _jax_search(ufm, fchr, ftab_tb, zoff, rseq, lengths, start, min_hitlen,
                increment, max_hits, first_hit_only, nblk, nblk12):
    from centrifuge_tpu.classify.engine import direct_kernels, search_loop
    kern = direct_kernels(ufm, fchr, ftab_tb, zoff, nblk, nblk12)
    return search_loop(kern, rseq, lengths, start, min_hitlen, increment,
                       max_hits, first_hit_only, unroll=1)


@pytest.fixture(scope="module")
def lanes():
    from centrifuge_tpu_torch.io.fastx import read_batch
    seqs = []
    for f in ("reads.fq", "reads_n.fq"):
        for r in read_batch([fixture_path("synth", f)], limit=N_READS):
            seqs += [r.seq, r.revcomp()]
    return seqs


@pytest.fixture(scope="module")
def indexes(synth_index):
    """(JAX DeviceFMIndex, the port's index carried across from it) per
    (wide, deep); test_torch_fm.py holds the carried-across index equal
    to the port's own build."""
    from centrifuge_tpu.ops.fm_jax import DeviceFMIndex as JaxFM
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    out = {}
    for wide in (False, True):
        for deep in (False, True):
            j = JaxFM.build(synth_index, wide=wide, deep_ftab=deep,
                            keep_host_blocks=True)
            d = {k: np.asarray(getattr(j, k)) for k in (
                "ufm", "fchr", "ftab_top", "ftab_bot", "offs",
                "boundary_rows", "boundary_refs")}
            meta = dict(nblk=j.nblk, nblk12=j.nblk12, zoff=j.zoff,
                        bwt_len=j.bwt_len, ftab_chars=j.ftab_chars,
                        offrate=j.offrate, npat=j.npat, wide=j.wide)
            out[wide, deep] = (j, DeviceFMIndex.from_jax_arrays(
                d, meta, device="cpu"))
    return out


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    return build_twin(str(tmp_path_factory.mktemp("twin_engine")))


def _jax_outputs(jfm, seqs, min_hitlen):
    from centrifuge_tpu.classify.engine import BatchSearchEngine
    eng = BatchSearchEngine(jfm, min_hitlen)
    lmax = 160
    rseq, lengths = eng.pack(seqs, lmax, len(seqs))
    out = _jax_search(
        jfm.ufm, jfm.fchr, jfm.ftab_tb, jnp.asarray(jfm.zoff, jfm.row_dtype),
        jnp.asarray(rseq.astype(np.int32)), jnp.asarray(lengths),
        jnp.zeros(len(seqs), jnp.int32), min_hitlen=min_hitlen,
        increment=eng.increment, max_hits=JAX_MAX_HITS,
        first_hit_only=False, nblk=jfm.nblk, nblk12=jfm.nblk12 or None)
    return [np.asarray(a) for a in out]


def _assert_same_hits(got, want):
    """Equal hit counts and sums, and equal hits in each lane's first
    nhits slots (slots past a lane's hits are not part of the result)."""
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[5], want[5])
    width = got[0].shape[1]
    assert want[0].shape[1] >= width
    used = np.arange(width)[None, :] < got[4][:, None]
    for k in range(4):
        np.testing.assert_array_equal(got[k][used],
                                      want[k][:, :width][used])


@pytest.mark.parametrize("min_hitlen", [16, 22])
@pytest.mark.parametrize("deep", [False, True], ids=["plain", "deep"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_search_matches_jax(indexes, lanes, twin, wide, deep, min_hitlen):
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes)
    jfm, fm = indexes[wide, deep]
    assert fm.deep == deep
    want = _jax_outputs(jfm, lanes, min_hitlen)
    assert want[4].max() <= JAX_MAX_HITS

    # the port's engine end to end (packing, buckets, the re-run of lanes
    # that overflow its first 16 slots)
    eng = BatchSearchEngine(fm, min_hitlen)
    got = eng.search(lanes)
    assert got[0].dtype == (np.int64 if wide else np.int32)
    assert [a.dtype for a in got[2:]] == [np.int32] * 4
    assert got[4].max() > eng.FIRST_MAX_HITS   # the re-run path ran
    assert got[0].shape[1] == JAX_MAX_HITS
    _assert_same_hits(got, want)

    # the plain version and the kernel's lane function on identical
    # packed lanes, all 16 slots (a lane past 16 hits overwrites its
    # last), run by the one-thread group of 1 (K6's), 4 and 8 parts (the
    # card's tile sizes): the same outputs and count of table reads
    rseqp, lengths = eng.pack_transport(lanes, 160, len(lanes))
    args = (fm, torch.from_numpy(rseqp), torch.from_numpy(lengths),
            torch.zeros(len(lanes), dtype=torch.int32), 16, min_hitlen,
            eng.increment, False, deep)
    plain = search_lanes(*args)
    assert int(plain[4].max()) > 16
    most = []
    for group in (1, 4, 8):
        for p, t in zip(plain, twin_search(twin, *args, reads_out=most,
                                           group=group)):
            assert torch.equal(p, t)
    assert most[0] == most[1] == most[2]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_first_hits_match_host_walk(indexes, lanes, twin, wide):
    """search_first_hits (one partialSearch per lane from an offset)
    against the native host walk the pipeline uses for extensions."""
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes)
    from centrifuge_tpu_torch.native.fmwalk import HostResolver
    _, fm = indexes[wide, True]
    rng = np.random.default_rng(9)
    # offsets inside each read, as the extension pass asks for them
    offs = np.array([rng.integers(0, len(s)) for s in lanes], np.int32)
    eng = BatchSearchEngine(fm, 22)
    got = eng.search_first_hits(lanes, offs)
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    hr = HostResolver(fm.host_blocks, load_cf_index(
        fixture_path("synth", "synth")), fm.wide)
    want = hr.first_hits(lanes, offs)
    for k in range(4):
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64))
    np.testing.assert_array_equal(got[4], want[4])

    rseqp, lengths = eng.pack_transport(lanes, 160, len(lanes))
    args = (fm, torch.from_numpy(rseqp), torch.from_numpy(lengths),
            torch.from_numpy(offs), 1, 22, eng.increment, True, True)
    want = search_lanes(*args)
    for group in (1, 4, 8):
        for p, t in zip(want, twin_search(twin, *args, group=group)):
            assert torch.equal(p, t)


def _sectors_brute(fm, st):
    """(bytes, int ops, popcounts) of recorded lookups, one address at a
    time: the first and last byte of every word a lookup reads, and the
    sample each `offs` lookup reads."""
    width = fm.blocks.shape[1] * 4
    word0 = (8 if fm.wide else 4) * 4
    cat = {k: torch.cat(v).tolist() for k, v in st.items()}
    secs, int_ops, popc = set(), 0, 0
    for r, c in zip(cat.get("rank_rows", []), cat.get("rank_chars", [])):
        base = (r >> 9) * width
        nw = ((r & 511) + 15) // 16
        addrs = [base + 4 * c] + ([base + 16 + 4 * c] if fm.wide else [])
        addrs += [base + word0 + 4 * k + b for k in range(nw) for b in (0, 3)]
        secs |= {("blocks", a // 32) for a in addrs}
        int_ops += 10 + 4 * ((r & 511) >> 4) + (7 if r & 15 else 0)
        popc += nw
    for r in cat.get("bwt_rows", []):
        secs.add(("blocks", ((r >> 9) * width + word0
                             + 4 * ((r & 511) >> 4)) // 32))
        int_ops += 5
    per, entry = (8, 16) if fm.wide else (16, 8)
    for key in ("ftab", "ftab12"):
        for fi in cat.get(key, []):
            secs.add((key, ((fi // per) * width + (fi % per) * entry) // 32))
    for si in cat.get("offs", []):
        secs.add(("offs", 4 * si // 32))
    return 32 * len(secs), int_ops, popc


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_chip_smoke_bound_counts_each_sector_once(indexes, lanes, wide):
    """The lookups the plain search records, and chip_smoke's count of
    the sectors and operations they need, against a count made address
    by address; recording leaves the outputs as they were."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_plain)
    fm = indexes[wide, True][1]
    seqs = lanes[:64]
    eng = BatchSearchEngine(fm, 22)
    rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
    args = (fm, torch.from_numpy(rseqp), torch.from_numpy(lengths),
            torch.zeros(len(seqs), dtype=torch.int32), 16, 22,
            eng.increment, False, True)
    st = {}
    for a, b in zip(search_plain(*args, stats=st), search_plain(*args)):
        assert torch.equal(a, b)
    assert {"rank_rows", "bwt_rows", "ftab", "ftab12"} <= set(st)
    smoke = object.__new__(chip_smoke.Smoke)
    smoke.torch = torch
    assert smoke.traffic(fm, st) == _sectors_brute(fm, st)
