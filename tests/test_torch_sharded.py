"""K6 (the search and the resolve walk over BWT-range shards) and the mesh
pipeline of the port, on CPU meshes (the plain versions), against the
JAX package's parallel/sharded.py, the port's single-device search and
the reference goldens. Integers throughout: exact equality.

The JAX side compiles twice per resolver budget and once for the search:
its sharded search loop is traced with unroll=1 (a per-lane no-op on done
lanes, so the unroll changes the compile time, not an output)."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

SYNTH = fixture_path("synth")


def _golden(name):
    with open(os.path.join(SYNTH, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(os.path.join(SYNTH, "synth"))


def _cpu_index(idx, dp, n_fm, wide):
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       make_mesh)
    return MeshIndex(ShardedFMArrays.build(idx, n_fm, wide=wide),
                     make_mesh(dp, n_fm, ["cpu"] * (dp * n_fm)))


def _lanes(name, limit=None):
    from centrifuge_tpu_torch.io.fastx import read_batch
    seqs = []
    for r in read_batch([os.path.join(SYNTH, name)], limit=limit):
        seqs += [r.seq, r.revcomp()]
    return seqs


@pytest.mark.parametrize("n_fm,wide", [(2, False), (4, True)],
                         ids=["fm2_narrow", "fm4_wide"])
def test_from_jax_matches_jax_build(synth_index, port_index, n_fm, wide):
    """ShardedFMArrays.build and from_jax against the JAX build, table by
    table (no compile), and each shard of a mesh index against its slice:
    blocks by row >> 9, ftab by entry, samples by row >> offrate."""
    from centrifuge_tpu.parallel.sharded import ShardedFMArrays as JaxSh
    from centrifuge_tpu_torch.parallel.sharded import ShardedFMArrays
    jsh = JaxSh.build(synth_index, n_fm, wide=wide)
    got = ShardedFMArrays.from_jax(
        {k: getattr(jsh, k) for k in ShardedFMArrays.JAX_FIELDS})
    own = ShardedFMArrays.build(port_index, n_fm, wide=wide)
    for sh in (got, own):
        for k in ("blocks", "fchr", "ftab_tb", "offs", "boundary_rows",
                  "boundary_refs"):
            a, b = getattr(sh, k), np.asarray(getattr(jsh, k))
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b)
        for k in ("zoff", "bwt_len", "offrate", "npat", "n_fm", "wide",
                  "ftab_chars", "nblk_per", "nftab_per", "noffs_per"):
            assert getattr(sh, k) == getattr(jsh, k), k
    assert own.fchr.dtype == (np.int64 if wide else np.int32)
    index = _cpu_index(port_index, 1, n_fm, wide)
    for f, s in enumerate(index.rows[0].shards):
        b = f * own.nblk_per
        np.testing.assert_array_equal(
            s.blocks.numpy().view(np.uint32),
            own.blocks[b: b + own.nblk_per])
        np.testing.assert_array_equal(
            s.offs.numpy(), own.offs[f * own.noffs_per:
                                     (f + 1) * own.noffs_per])
        assert s.ftab_tb.shape == (4 ** 10 // n_fm, 2)
    with pytest.raises(ValueError):
        ShardedFMArrays.build(port_index, 3)


def test_mesh_repeats_devices():
    """A mesh is a grid of devices that may repeat; all cpu or all cuda."""
    from centrifuge_tpu_torch.parallel.sharded import Mesh, make_mesh
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "fm": 2} and not mesh.on_cuda
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        Mesh([["cpu", "meta"]])


def test_shard_descriptor_words(port_index):
    """Each dp row's descriptor of its shards for K6 (the words
    csrc/fm_common.cuh shard_set reads): the counts, zoff, the lead's
    fchr, then per shard its three tables' addresses and first keys."""
    from centrifuge_tpu_torch.parallel.sharded import shard_descriptor
    index = _cpu_index(port_index, 2, 2, False)
    for row in index.rows:
        d = shard_descriptor(index, row).tolist()
        assert d[:6] == [2, index.nblk_per, index.nftab_per,
                         index.noffs_per, index.zoff, row.fchr.data_ptr()]
        for f, s in enumerate(row.shards):
            assert d[6 + 6 * f: 12 + 6 * f] == [
                s.blocks.data_ptr(), s.ftab_tb.data_ptr(), s.offs.data_ptr(),
                f * index.nblk_per, f * index.nftab_per, f * index.noffs_per]
        assert len(d) == 6 + 6 * 2


@pytest.mark.parametrize("case", ["no_peer_access", "too_many_shards"])
def test_cuda_mesh_refused_before_placing(port_index, monkeypatch, case):
    """What MeshIndex refuses on a CUDA mesh before it places any table
    (torch.cuda is patched, so this runs without a card): a dp row over
    two cards without peer access, named in the error (K6 reads the other
    card's shard in place; nothing falls back to copies), and more fm
    shards than K6's kernel parameter describes."""
    from centrifuge_tpu_torch.parallel.sharded import (MAX_SHARDS, MeshIndex,
                                                       ShardedFMArrays,
                                                       make_mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    if case == "no_peer_access":
        sh = ShardedFMArrays.build(port_index, 2)
        mesh = make_mesh(1, 2, ["cuda:0", "cuda:1"])
        with pytest.raises(RuntimeError,
                           match="cuda:0 has no peer access to cuda:1"):
            MeshIndex(sh, mesh)
    else:
        n_fm = 2 * MAX_SHARDS
        sh = ShardedFMArrays.build(port_index, n_fm)
        with pytest.raises(ValueError, match=f"at most {MAX_SHARDS}"):
            MeshIndex(sh, make_mesh(1, n_fm, ["cuda:0"] * n_fm))


@pytest.mark.parametrize("dp,n_fm,wide", [(2, 2, False), (1, 4, True),
                                          (2, 1, False)])
def test_plain_search_matches_single_device(port_index, dp, n_fm, wide):
    """The plain K6 search against the port's single-device search
    (search_lanes on the unsharded index, no depth-12 prime) on the synth
    lanes with Ns and one lane past 16 hits, all 6 outputs, min_hitlen 16
    and 22, full scans and first hits from offsets."""
    from centrifuge_tpu_torch.classify.engine import (BatchSearchEngine,
                                                      search_lanes)
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.parallel.sharded import (sharded_search,
                                                       sharded_search_plain)
    index = _cpu_index(port_index, dp, n_fm, wide)
    fm = DeviceFMIndex.build(port_index, device="cpu", wide=wide,
                             deep_ftab=False)
    seqs = _lanes("reads_n.fq", 128)
    rseqp, lengths = BatchSearchEngine(fm).pack_transport(seqs, 160,
                                                          len(seqs))
    reads, lens = torch.from_numpy(rseqp), torch.from_numpy(lengths)
    zero = torch.zeros(len(seqs), dtype=torch.int32)
    offs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 90, len(seqs)).astype(np.int32))
    for mhl, start, mh, first in ((16, zero, 16, False),
                                  (22, zero, 16, False),
                                  (22, offs, 1, True)):
        inc = 10 if 2 * mhl <= 33 else 2 * mhl - 33
        args = (reads, lens, start, mh, mhl, inc, first)
        got = sharded_search_plain(index, *args)
        want = search_lanes(fm, *args, False)
        # rows in the row dtype (int64 when wide), off/len/counts int32
        assert [g.dtype for g in got] == [fm.row_dtype] * 2 + [
            torch.int32] * 4
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if mhl == 16:
            assert int(got[4].max()) > mh
            # the wrapper runs the plain version for CPU tensors
            for g, k in zip(got, sharded_search(index, *args)):
                assert torch.equal(k, g)


def test_engine_matches_jax_sharded_engine(synth_index, port_index):
    """One JAX ShardedSearchEngine search at (dp, fm) = (2, 2), narrow, on
    24 reads x 2 strands, against the port's engine on the same arrays
    carried across (as tests/test_parallel.py:36-59 holds the JAX engine
    to its single-chip engine)."""
    from centrifuge_tpu.parallel import sharded as jax_sharded
    from centrifuge_tpu.classify import engine as jax_engine
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       ShardedSearchEngine,
                                                       make_mesh)
    jsh = jax_sharded.ShardedFMArrays.build(synth_index, 2, wide=False)
    fields = {k: getattr(jsh, k) for k in ShardedFMArrays.JAX_FIELDS}
    seqs = _lanes("reads.fq", 24)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded, "search_loop", functools.partial(
            jax_engine.search_loop, unroll=1))
        jeng = jax_sharded.ShardedSearchEngine(
            jsh, jax_sharded.make_mesh(2, 2, jax.devices()))
        want = jeng.search(seqs)
    eng = ShardedSearchEngine(MeshIndex(ShardedFMArrays.from_jax(fields),
                                        make_mesh(2, 2, ["cpu"] * 4)))
    assert eng.lane_bucket_lo == 256 and eng.overflow_bucket_lo == 32
    got = eng.search(seqs)
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[5], want[5])
    assert int(got[4].max()) > 1
    for lane in range(len(seqs)):
        k = min(int(want[4][lane]), 16)
        for j in range(4):
            np.testing.assert_array_equal(got[j][lane, :k],
                                          want[j][lane, :k])


def test_overflow_rerun_and_lane_buckets(port_index):
    """A lane past 16 hits keeps overwriting its last slot in the first
    pass and is re-run with a wider buffer; the re-run's lane bucket is
    max(32, n_dp) so it splits over the dp rows; the engine's output
    equals the single-device engine's, widened arrays included."""
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       ShardedSearchEngine,
                                                       make_mesh)
    seqs = _lanes("reads_n.fq", 64)
    eng = ShardedSearchEngine(_cpu_index(port_index, 2, 2, True))
    got = eng.search(seqs)
    assert int(got[4].max()) > eng.FIRST_MAX_HITS
    assert got[0].shape[1] > eng.FIRST_MAX_HITS
    want = BatchSearchEngine(DeviceFMIndex.build(
        port_index, device="cpu", wide=True, deep_ftab=False)).search(seqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dp64 = ShardedSearchEngine(MeshIndex(
        ShardedFMArrays.build(port_index, 1), make_mesh(64, 1, ["cpu"] * 64)))
    assert (dp64.lane_bucket_lo, dp64.overflow_bucket_lo) == (256, 64)


@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    """(path, port CFIndex) of an index built from three synth genomes,
    the third cut so that bwt_len = 119,168: bwt_len % 512 = 384, so the
    last real block's back half holds rows, and the 7,448 samples fill
    the single-device table's 8-wide rows, so its clipped index reads a
    real sample."""
    from centrifuge_tpu_torch.build.builder import build_index
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    d = tmp_path_factory.mktemp("tiny")
    recs = open(os.path.join(SYNTH, "db.fa")).read().split(">")[1:4]
    with open(d / "db.fa", "w") as f:
        for k, r in enumerate(recs):
            head, *seq = r.split("\n")
            seq = "".join(seq)
            f.write(f">{head}\n{seq[:39167] if k == 2 else seq}\n")
    base = str(d / "t")
    build_index([str(d / "db.fa")], base, os.path.join(SYNTH, "conv.dmp"),
                os.path.join(SYNTH, "nodes.dmp"),
                os.path.join(SYNTH, "names.dmp"))
    idx = load_cf_index(base)
    assert idx.bwt_len % 512 >= 258 and idx.offs.shape[0] % 8 == 0
    return base, idx


def _pad_even(rows):
    return rows if rows.shape[0] % 2 == 0 else np.append(rows, 0)


@pytest.fixture(scope="module")
def jax_fm2_wide(tiny_index):
    """The JAX (2, 2) wide mesh arrays of the tiny index, their port
    counterpart carried across, and the resolver inputs: the edge rows
    ('$', 0, the last row, sampled and boundary rows and their
    neighbours), sampled rows whose sample index lies past the table, and
    256 random rows."""
    from centrifuge_tpu.index.cf_io import load_cf_index
    from centrifuge_tpu.parallel import sharded as jax_sharded
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       make_mesh)
    jsh = jax_sharded.ShardedFMArrays.build(load_cf_index(tiny_index[0]), 2,
                                            wide=True)
    sh = ShardedFMArrays.from_jax(
        {k: getattr(jsh, k) for k in ShardedFMArrays.JAX_FIELDS})
    index = MeshIndex(sh, make_mesh(2, 2, ["cpu"] * 4))
    mesh = jax_sharded.make_mesh(2, 2, jax.devices())
    br = sh.boundary_rows.astype(np.int64)
    past = (sh.offs.shape[0] + np.array([0, 1, 9, 500])) << sh.offrate
    rows = np.concatenate([
        [0, sh.zoff, sh.bwt_len - 1, 16, 512, 96000], br, br + 1, past,
        np.random.default_rng(0).integers(0, sh.bwt_len, 256)])
    return jsh, mesh, index, _pad_even(rows.astype(np.int64)), past


@pytest.mark.parametrize("max_steps", [4096, 1, 2])
def test_plain_resolver_matches_jax(jax_fm2_wide, tiny_index, max_steps):
    """The plain K6 walk against the JAX make_sharded_resolver at fm=2,
    wide. Its step bound is tested once per 4 unrolled LF steps, so
    max_steps 1 and 2 both stop after 4 steps (the single-device walk
    after 8). A sampled row whose sample index no shard owns exits with 0
    (the single-device walk clips the index to its table instead)."""
    from centrifuge_tpu.parallel.sharded import make_sharded_resolver
    from centrifuge_tpu_torch.ops.fm_torch import (DeviceFMIndex,
                                                   resolve_rows_plain)
    from centrifuge_tpu_torch.parallel.sharded import (
        make_sharded_resolver as port_resolver, sharded_resolve_plain)
    jsh, mesh, index, rows, past = jax_fm2_wide
    want = np.asarray(make_sharded_resolver(mesh, jsh, max_steps)(rows))
    t = torch.from_numpy(rows)
    got = sharded_resolve_plain(index, t, max_steps)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_resolver(index, max_steps)(rows),
                                  want)
    idx = tiny_index[1]
    single = resolve_rows_plain(DeviceFMIndex.build(
        idx, device="cpu", wide=True, deep_ftab=False), t, max_steps)
    on_table = rows < idx.bwt_len
    if max_steps == 4096:
        assert (want[on_table] >= 0).all()
        np.testing.assert_array_equal(single.numpy()[on_table],
                                      want[on_table])
    else:
        assert (want < 0).sum() > (single.numpy() < 0).sum() > 0
    tail = np.isin(rows, past)
    assert (want[tail] == 0).all() and (single.numpy()[tail] > 0).all()


def test_host_resolver_counts_real_blocks(tiny_index):
    """HostResolver over the fm-padded blocks (n_fm = 8 pads 233 block
    rows to 240) counts only the real ones: every row of the last real
    block, whose back half the host walk ranks down from the next
    checkpoint, resolves as on the unpadded blocks and as the plain
    sharded walk does."""
    from centrifuge_tpu_torch.native.fmwalk import HostResolver
    from centrifuge_tpu_torch.parallel.sharded import (MeshIndex,
                                                       ShardedFMArrays,
                                                       make_mesh,
                                                       sharded_resolve_plain)
    idx = tiny_index[1]
    sh = ShardedFMArrays.build(idx, 8)
    real = (idx.bwt_len + 511) // 512
    assert sh.blocks.shape[0] > real
    hr = HostResolver(sh.blocks, idx, False)
    assert hr.nblk == real
    rows = np.arange((real - 1) * 512, idx.bwt_len, dtype=np.int32)
    want = sharded_resolve_plain(
        MeshIndex(sh, make_mesh(1, 8, ["cpu"] * 8)),
        torch.from_numpy(_pad_even(rows.astype(np.int64)).astype(np.int32)))
    got = hr(rows)
    np.testing.assert_array_equal(got, want.numpy()[: rows.shape[0]])
    np.testing.assert_array_equal(
        got, HostResolver(sh.blocks[:real], idx, False)(rows))
    assert (got >= 0).all()


def _stream(pipe, items, paired=False, size=1024):
    stream = pipe.classify_stream_paired if paired \
        else pipe.classify_stream_unpaired
    rows = [pipe.formatter.header()]
    for chunk in stream([items[i: i + size]
                         for i in range(0, len(items), size)]):
        rows += chunk
    return "\n".join(rows) + "\n"


@pytest.mark.parametrize("dp,n_fm,wide,host_resolve", [
    (2, 2, False, True), (2, 2, False, False), (1, 4, True, True),
    (2, 2, True, False)])
def test_mesh_pipeline_goldens(port_index, tmp_path, dp, n_fm, wide,
                               host_resolve):
    """GPUClassificationPipeline(mesh=<cpu mesh>, device="cpu"): unpaired
    rows and report byte-equal to the goldens, narrow and wide, SA rows
    resolved by the host walk over the padded blocks or by the sharded
    walk."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.parallel.sharded import (ShardedSearchEngine,
                                                       make_mesh)
    from centrifuge_tpu_torch.report.writers import write_report
    mesh = make_mesh(dp, n_fm, ["cpu"] * (dp * n_fm))
    pipe = GPUClassificationPipeline(
        port_index, PipelineConfig(host_resolve=host_resolve), device="cpu",
        mesh=mesh, wide=wide)
    assert isinstance(pipe.engine, ShardedSearchEngine) and not pipe.presolve
    assert hasattr(pipe.resolver, "first_hits") == host_resolve
    assert pipe.resolver.wide == wide
    recs = read_batch([os.path.join(SYNTH, "reads.fq")])
    assert _stream(pipe, recs) == _golden("golden_output.tsv")
    rep = tmp_path / "report.tsv"
    write_report(str(rep), port_index, pipe.spm, abundance_analysis=True)
    assert rep.read_text() == _golden("golden_report.tsv")
    assert pipe.metrics.resolve_rows > 0
    with pytest.raises(ValueError):
        GPUClassificationPipeline(port_index, device="cuda", mesh=mesh)


def test_mesh_pipeline_paired_and_report(port_index, tmp_path):
    """Paired rows and the abundance report at a wide (2, 2) mesh with the
    sharded resolver: byte-equal to golden_paired.tsv and
    golden_paired_report.tsv."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    from centrifuge_tpu_torch.io.fastx import read_fastx
    from centrifuge_tpu_torch.parallel.sharded import make_mesh
    from centrifuge_tpu_torch.report.writers import write_report
    pipe = GPUClassificationPipeline(
        port_index, PipelineConfig(host_resolve=False), device="cpu",
        mesh=make_mesh(2, 2, ["cpu"] * 4), wide=True)
    pairs = list(zip(read_fastx(os.path.join(SYNTH, "reads_1.fq")),
                     read_fastx(os.path.join(SYNTH, "reads_2.fq"))))
    assert _stream(pipe, pairs, paired=True, size=512) == _golden(
        "golden_paired.tsv")
    rep = tmp_path / "report.tsv"
    write_report(str(rep), port_index, pipe.spm, abundance_analysis=True,
                 verbose_stderr=False)
    assert rep.read_text() == _golden("golden_paired_report.tsv")


def test_chip_smoke_bound_counts_sharded_lookups(port_index):
    """The lookups the plain K6 search and walk record (global rows,
    entries and sample indexes), and chip_smoke's count of the sectors
    they need in the fm-padded tables (the ftab as (top, bot) pairs),
    against a count made address by address; recording leaves the
    outputs as they were."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from centrifuge_tpu_torch.classify.engine import BatchSearchEngine
    from centrifuge_tpu_torch.parallel.sharded import (sharded_resolve_plain,
                                                       sharded_search_plain)
    from test_torch_engine import _sectors_brute
    index = _cpu_index(port_index, 1, 2, False)
    seqs = _lanes("reads.fq", 64)
    rseqp, lengths = BatchSearchEngine(index).pack_transport(seqs, 128,
                                                             len(seqs))
    args = (torch.from_numpy(rseqp), torch.from_numpy(lengths),
            torch.zeros(len(seqs), dtype=torch.int32), 16, 22, 11, False)
    rows = torch.from_numpy(np.random.default_rng(2).integers(
        0, port_index.bwt_len, 512).astype(np.int32))
    st = {}
    for g, w in zip(sharded_search_plain(index, *args, stats=st),
                    sharded_search_plain(index, *args)):
        assert torch.equal(g, w)
    assert torch.equal(sharded_resolve_plain(index, rows, stats=st),
                       sharded_resolve_plain(index, rows))
    assert {"ftab", "bwt_rows", "rank_rows", "rank_chars", "offs"} <= set(st)
    smoke = object.__new__(chip_smoke.Smoke)
    smoke.torch = torch
    tables = smoke.sharded_tables(index)
    got = smoke.traffic(tables, st)
    ftab = st.pop("ftab")
    nbytes, ops, popc = _sectors_brute(tables, st)
    pair_sectors = {fi * 8 // 32 for fi in torch.cat(ftab).tolist()}
    assert got == (nbytes + 32 * len(pair_sectors), ops, popc)
