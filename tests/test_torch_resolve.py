"""K3 (the SA resolve walk) and K5 (the in-dispatch presolve) of the port
against the JAX package, on the synth index carried across from JAX,
narrow and forced wide: the exits and the walk (also cut short by a
small max_steps), the per-mate pick, the whole presolve dispatch, and
the pipeline with host_resolve=False. The host build of the kernels'
lane functions (csrc/cpu_twin.cpp) is held against the plain versions
on the same inputs. Inputs are made with numpy from seeds; integers
throughout, so every comparison is exact.

The JAX presolve dispatch is traced once, with its search loop at
unroll=1: the loop body is a per-lane transition that is a no-op on done
lanes, so the unroll changes the compile time, not an output."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import (build_twin, one_torch_thread,  # noqa: F401
                             random_hits, twin_pick, twin_resolve)

SYNTH = fixture_path("synth")
N_DISPATCH_READS = 64   # reads_n.fq: read 63's rc lane emits 17 hits


@pytest.fixture(scope="module")
def indexes(synth_index):
    """(JAX DeviceFMIndex, the port's index carried across from it) per
    width."""
    from centrifuge_tpu.ops.fm_jax import DeviceFMIndex as JaxFM
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    out = {}
    for wide in (False, True):
        j = JaxFM.build(synth_index, wide=wide, keep_host_blocks=True)
        d = {k: np.asarray(getattr(j, k)) for k in (
            "ufm", "fchr", "ftab_top", "ftab_bot", "offs", "boundary_rows",
            "boundary_refs")}
        meta = dict(nblk=j.nblk, nblk12=j.nblk12, zoff=j.zoff,
                    bwt_len=j.bwt_len, ftab_chars=j.ftab_chars,
                    offrate=j.offrate, npat=j.npat, wide=j.wide)
        out[wide] = (j, DeviceFMIndex.from_jax_arrays(d, meta, device="cpu"))
    return out


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    return build_twin(str(tmp_path_factory.mktemp("twin_resolve")))


@pytest.fixture(scope="module")
def jax_unroll1():
    from centrifuge_tpu.classify import engine as jax_engine
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "search_loop", functools.partial(
            jax_engine.search_loop, unroll=1))
        yield


def _rows(fm, n, seed):
    """The edge rows (0, the '$' row, the last row, each boundary row,
    then their neighbours), then n random rows."""
    rng = np.random.default_rng(seed)
    br = fm.boundary_rows.numpy().astype(np.int64)
    edges = np.concatenate([[0, fm.zoff, fm.bwt_len - 1], br, br - 1,
                            br + 1])
    rows = np.concatenate([edges, rng.integers(0, fm.bwt_len, n)])
    return rows.astype(np.int64 if fm.wide else np.int32)


def _jax_resolve_args(j):
    args = (j.blocks, j.fchr, j.offs, j.boundary_rows, j.boundary_refs,
            jnp.asarray(j.zoff, j.row_dtype))
    kw = dict(sample_mask=(1 << j.offrate) - 1, offrate=j.offrate,
              has_bounds=j.boundary_rows.shape[0] > 0,
              narrow=j.npat <= 0xFFFF)
    return args, kw


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_resolve_matches_jax(indexes, twin, wide):
    """make_resolver and the plain walk against the JAX resolver on 8192
    random rows and the edge rows; then the walk cut short, which leaves
    rows at -1: the JAX walk tests its step count once per 8 unrolled
    steps, so max_steps 1 and 2 both stop after 8 LF steps and 9 after
    16."""
    from centrifuge_tpu.ops.fm_jax import _resolve_rows
    from centrifuge_tpu.ops.fm_jax import make_resolver as jax_resolver
    from centrifuge_tpu_torch.ops.fm_torch import (make_resolver,
                                                   resolve_rows_plain)
    j, fm = indexes[wide]
    rows = _rows(fm, 8192, seed=7)
    want = np.asarray(jax_resolver(j)(jnp.asarray(rows)))
    assert (want >= 0).all()
    res = make_resolver(fm)
    assert res.wide == wide
    got = res(rows)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(rows)
    assert torch.equal(twin_resolve(twin, fm, t, 4096), torch.from_numpy(got))

    args, kw = _jax_resolve_args(j)
    cut = {}
    for steps in (1, 2, 9):
        want1 = np.asarray(_resolve_rows(*args, jnp.asarray(rows),
                                         max_steps=steps, **kw))
        assert (want1 == -1).any() and (want1 >= 0).any()
        got1 = resolve_rows_plain(fm, t, max_steps=steps)
        np.testing.assert_array_equal(got1.numpy(), want1)
        assert torch.equal(twin_resolve(twin, fm, t, steps), got1)
        cut[steps] = int((want1 < 0).sum())
    assert cut[1] == cut[2] > cut[9]


@pytest.mark.parametrize("npat", [24, 0x10000], ids=["narrow_refs",
                                                     "wide_refs"])
def test_try_offset_exits_match_jax(indexes, twin, npat):
    """The exits alone, on the edge rows: '$' over everything, samples
    over boundaries, boundary refs masked to 16 bits only when npat <=
    0xFFFF (refs given high bits here so the mask shows)."""
    from centrifuge_tpu.ops.fm_jax import _try_offset
    from centrifuge_tpu_torch.ops.fm_torch import try_offset_plain
    j, fm = indexes[False]
    refs = (fm.boundary_refs + (torch.arange(fm.boundary_refs.numel())
                                << 16)).to(torch.int32)
    fm = dataclasses.replace(fm, npat=npat, boundary_refs=refs)
    rows = _rows(fm, 512, seed=3)
    want = np.asarray(jax.jit(functools.partial(
        _try_offset, sample_mask=(1 << fm.offrate) - 1, offrate=fm.offrate,
        has_bounds=True, narrow=npat <= 0xFFFF))(
        j.blocks, j.offs, j.boundary_rows, jnp.asarray(refs.numpy()),
        jnp.asarray(fm.zoff, jnp.int32), jnp.asarray(rows)))
    t = torch.from_numpy(rows)
    got = try_offset_plain(fm, t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(twin_resolve(twin, fm, t, 0, walk=False), got)
    # the '$' row is also a boundary row of this index and wins
    assert int(got[1]) == 0 and fm.zoff in fm.boundary_rows.tolist()
    unsampled = (fm.boundary_rows.numpy() & ((1 << fm.offrate) - 1)) != 0
    assert (got.numpy()[3: 3 + unsampled.shape[0]][unsampled] > 0xFFFF
            ).any() == (npat > 0xFFFF)


@pytest.fixture(scope="module")
def first_pass_hits(indexes):
    """Per width, the first-pass hit buffers (16 slots) of 64 reads of
    reads.fq and 64 of reads_n.fq, both strands: 256 lanes."""
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes)
    from centrifuge_tpu_torch.io.fastx import read_batch
    seqs = []
    for f in ("reads.fq", "reads_n.fq"):
        for r in read_batch([os.path.join(SYNTH, f)], limit=64):
            seqs += [r.seq, r.revcomp()]
    out = {}
    for wide, (_, fm) in indexes.items():
        eng = BatchSearchEngine(fm, 22)
        rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
        out[wide] = search_lanes(fm, torch.from_numpy(rseqp),
                                 torch.from_numpy(lengths),
                                 torch.zeros(len(seqs), dtype=torch.int32),
                                 16, 22, eng.increment, False, False)
    return out


@pytest.mark.parametrize("khits", [5, 16])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_pick_matches_jax(first_pass_hits, twin, wide, khits):
    """The per-mate pick against the JAX _presolve_pick_rows, jitted
    alone, on the first-pass hits of synth lanes (reads_n.fq has a lane
    past 16 hits) and on random hit buffers of the same shape; the
    compaction against the JAX dispatch's."""
    from centrifuge_tpu.classify.engine import _presolve_pick_rows
    from centrifuge_tpu_torch.classify.engine import (
        presolve_compact_plain, presolve_pick_rows_plain, presolve_rk)
    out = first_pass_hits[wide]
    assert int(out[4].max()) > 16
    rk, ihits = presolve_rk(khits), max(khits, 5) * 40
    idt = jnp.int64 if wide else jnp.int32
    pick = jax.jit(functools.partial(
        _presolve_pick_rows, khits=khits, ihits=ihits, min_hitlen=22, rk=rk,
        idt=idt))
    for h_top, h_bot, h_len in ((out[0], out[1], out[3]),
                                random_hits(128, 16, wide, seed=khits)):
        want_rows, want_n = pick(jnp.asarray(h_top.numpy()),
                                 jnp.asarray(h_bot.numpy()),
                                 jnp.asarray(h_len.numpy()))
        rows, nrows = presolve_pick_rows_plain(h_top, h_bot, h_len, khits,
                                               ihits, 22, rk)
        assert rows.dtype == h_top.dtype and nrows.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
        np.testing.assert_array_equal(nrows.numpy(), np.asarray(want_n))
        assert int(nrows.max()) > 1
        t_rows, t_n = twin_pick(twin, h_top, h_bot, h_len, khits, ihits, 22,
                                rk)
        assert torch.equal(t_rows, rows) and torch.equal(t_n, nrows)
        # the dispatch's compaction: cumsum, searchsorted, gather
        M = rows.shape[0]
        doffs = jnp.cumsum(want_n) - want_n
        jj = jnp.arange(4 * M)
        mate = jnp.searchsorted(doffs, jj, side="right") - 1
        slot = jj - doffs[mate]
        src = mate * rk + jnp.clip(slot, 0, rk - 1)
        want_flat = jnp.where(slot < want_n[mate],
                              want_rows.reshape(-1)[src], 0)
        np.testing.assert_array_equal(
            presolve_compact_plain(rows, nrows).numpy(),
            np.asarray(want_flat))


@pytest.fixture(scope="module")
def dispatch_reads():
    from centrifuge_tpu_torch.io.fastx import read_batch
    return read_batch([os.path.join(SYNTH, "reads_n.fq")],
                      limit=N_DISPATCH_READS)


def test_dispatch_matches_jax(indexes, jax_unroll1, dispatch_reads):
    """search_async(presolve=True) + search_collect of the port against
    the JAX engine's on 64 synth reads x 2 strands: the 6 per-lane arrays
    (after the re-run of the lane past 16 hits) and the sorted (rows,
    values) prefetch, which comes from the first-pass buffers."""
    from centrifuge_tpu.classify.engine import \
        BatchSearchEngine as JaxEngine
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    j, fm = indexes[False]
    seqs = []
    for r in dispatch_reads:
        seqs += [r.seq, r.revcomp()]
    jeng = JaxEngine(j)
    want, want_pre = jeng.search_collect(
        jeng.search_async(seqs, presolve=True), len(seqs))
    eng = BatchSearchEngine(fm)
    got, pre = eng.search_collect(eng.search_async(seqs, presolve=True),
                                  len(seqs))
    assert int(got[4].max()) > eng.FIRST_MAX_HITS
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want_pre is not None and pre[0].shape == want_pre[0].shape
    assert pre[0].dtype == np.int32 and pre[1].dtype == np.int32
    np.testing.assert_array_equal(pre[0], want_pre[0])
    np.testing.assert_array_equal(pre[1], want_pre[1])
    assert (pre[1] >= 0).all() and (pre[0] > 0).sum() > len(seqs) // 4


def _stream_rows(pipe, recs, paired=False):
    from centrifuge_tpu_torch.classify.pipeline import DEFAULT_COLUMNS
    assert pipe.cfg.columns == DEFAULT_COLUMNS
    batches = [recs[i: i + 1024] for i in range(0, len(recs), 1024)]
    rows = [pipe.formatter.header()]
    stream = pipe.classify_stream_paired if paired \
        else pipe.classify_stream_unpaired
    for chunk in stream(batches):
        rows += chunk
    return "\n".join(rows) + "\n"


def _golden(name):
    with open(os.path.join(SYNTH, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(os.path.join(SYNTH, "synth"))


@pytest.fixture(scope="module")
def host_rows(port_index):
    """The first 1024 reads of reads.fq and the host-resolve pipeline's
    rows for them."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_batch
    recs = read_batch([os.path.join(SYNTH, "reads.fq")], limit=1024)
    host = GPUClassificationPipeline(port_index, device="cpu")
    assert not host.presolve and host.resolver.needs_bucket is False
    return recs, _stream_rows(host, recs)


def test_device_resolve_pipeline_goldens(port_index, host_rows, tmp_path):
    """GPUClassificationPipeline(host_resolve=False) on the CPU: unpaired
    rows and report, and paired rows, equal to the goldens, and the
    first 1024 reads' rows equal to the host-resolve pipeline's, also
    with the presolve off, so every row goes through the tail's device
    resolver."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    from centrifuge_tpu_torch.io.fastx import read_batch, read_fastx
    from centrifuge_tpu_torch.report.writers import write_report
    recs = read_batch([os.path.join(SYNTH, "reads.fq")])
    cfg = PipelineConfig(host_resolve=False)
    pipe = GPUClassificationPipeline(port_index, cfg, device="cpu")
    assert pipe.presolve and pipe.dfm.host_blocks is None
    assert not hasattr(pipe.resolver, "bwops")
    assert _stream_rows(pipe, recs) == _golden("golden_output.tsv")
    rep = tmp_path / "report.tsv"
    write_report(str(rep), port_index, pipe.spm, abundance_analysis=True)
    assert rep.read_text() == _golden("golden_report.tsv")
    m = pipe.metrics
    assert m.resolve_rows > 0 and m.wl_bwops == 0

    pairs = list(zip(read_fastx(os.path.join(SYNTH, "reads_1.fq")),
                     read_fastx(os.path.join(SYNTH, "reads_2.fq"))))
    pipe = GPUClassificationPipeline(port_index, cfg, device="cpu")
    assert _stream_rows(pipe, pairs, paired=True) == _golden(
        "golden_paired.tsv")

    sub, want = host_rows
    for presolve in (True, False):
        pipe = GPUClassificationPipeline(port_index, cfg, device="cpu",
                                         dfm=pipe.dfm)
        pipe.presolve = presolve
        assert _stream_rows(pipe, sub) == want
    m = pipe.metrics
    assert m.resolve_miss_rows == m.resolve_rows > 0


def test_device_resolve_metrics_match_jax(synth_index, port_index,
                                          jax_unroll1, dispatch_reads):
    """Rows and --met counters of both packages' pipelines with
    host_resolve=False on the dispatch reads (one batch): wl_bwops stays 0
    (the device resolver has no walk counter), the resolve counts agree."""
    from centrifuge_tpu.classify.pipeline import \
        PipelineConfig as JaxConfig
    from centrifuge_tpu.classify.tpu_pipeline import \
        TPUClassificationPipeline
    from centrifuge_tpu.io.fastx import read_batch as jax_read_batch
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    from centrifuge_tpu_torch.utils.metrics import _row_values
    jp = TPUClassificationPipeline(synth_index, JaxConfig(host_resolve=False))
    assert jp.presolve
    want = jp.classify_batch_unpaired(jax_read_batch(
        [os.path.join(SYNTH, "reads_n.fq")], limit=N_DISPATCH_READS))
    gp = GPUClassificationPipeline(port_index,
                                   PipelineConfig(host_resolve=False),
                                   device="cpu")
    got = gp.classify_batch_unpaired(dispatch_reads)
    assert got == want
    # all but the clock (0), peak RSS (14) and the index bytes (16)
    keep = [k for k in range(30) if k not in (0, 14, 16)]
    gv, jv = _row_values(gp.metrics), _row_values(jp.metrics)
    assert [gv[k] for k in keep] == [jv[k] for k in keep]
    assert gv[10] == 0 and gv[28] > 0
    assert (gp.metrics.resolve_miss_rows, gp.metrics.wl_resolves) == (
        jp.metrics.resolve_miss_rows, jp.metrics.wl_resolves)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_chip_smoke_bound_counts_resolve_lookups(indexes, wide):
    """The lookups the plain walk records (BWT tests, ranks, sample
    reads), and chip_smoke's count of the sectors and operations they
    need, against a count made address by address; recording leaves the
    values as they were."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from centrifuge_tpu_torch.ops.fm_torch import resolve_rows_plain
    from test_torch_engine import _sectors_brute
    fm = indexes[wide][1]
    rows = torch.from_numpy(_rows(fm, 256, seed=2))
    st = {}
    assert torch.equal(resolve_rows_plain(fm, rows, stats=st),
                       resolve_rows_plain(fm, rows))
    assert {"bwt_rows", "rank_rows", "rank_chars", "offs"} <= set(st)
    smoke = object.__new__(chip_smoke.Smoke)
    smoke.torch = torch
    assert smoke.traffic(fm, st) == _sectors_brute(fm, st)


def test_host_resolver_failure_keeps_device_resolve(port_index, host_rows,
                                                    monkeypatch):
    """host_resolve=True but the native host walk cannot load: a loud
    fallback, and the pipeline keeps the device resolver and presolve
    (as tpu_pipeline.py:99-114 does), with the host walk's rows."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.native import fmwalk
    from centrifuge_tpu_torch.utils import fallback

    def refuse(*a, **k):
        raise RuntimeError("native fmwalk unavailable")

    monkeypatch.setattr(fmwalk, "HostResolver", refuse)
    monkeypatch.setattr(fallback, "_WARNED", {})
    pipe = GPUClassificationPipeline(port_index, device="cpu")
    assert pipe.presolve and not hasattr(pipe.resolver, "needs_bucket")
    assert "fmwalk.cpp (HostResolver)" in fallback.fallbacks()
    recs, want = host_rows
    assert _stream_rows(pipe, recs) == want
