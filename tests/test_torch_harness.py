"""The port's harnesses on the CPU (--device cpu, the plain versions): the
wide regime's stream function (evaluation/widebench.py) on the synth
index with the wide layout forced, the mesh harnesses
(parallel/shardscale.py, shardbench.py, scaling_bench.py), and the
synthetic wide table of chip_smoke's wide_scale phase
(evaluation/wide_table.py) against the host oracle. The JAX widebench cannot run below 2^31 bases, so the reference
goldens are the common ground: tests/test_parallel.py holds the JAX
harnesses to them. No JAX compile."""

import json
import os
import socket
import types

import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

SYNTH = fixture_path("synth")
# the unpaired cases classify the first N_READS synth reads, held to the
# goldens' first N_READS rows
N_READS = 500
# the shard census's reads (shardbench.leg_cpu)
CENSUS_READS = 32


def _golden(name, n_rows=None):
    """A golden TSV's text: its header and its first n_rows rows (all
    without n_rows)."""
    with open(os.path.join(SYNTH, name)) as f:
        lines = f.read().splitlines(True)
    return "".join(lines if n_rows is None else lines[:1 + n_rows])


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(os.path.join(SYNTH, "synth"))


@pytest.mark.parametrize("paired,host_resolve", [
    (False, True), (True, True), (False, False)],
    ids=["unpaired", "paired", "unpaired_device_resolve"])
def test_widebench_streams_match_goldens(port_index, paired, host_resolve):
    """widebench.streams on the synth index in the wide layout (int64
    rows, 64-bit occ): two streams (one of the pairs) through fresh
    pipelines on one device index, byte-equal to the goldens (the first
    N_READS rows of the unpaired one), on either resolve path."""
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    from centrifuge_tpu_torch.evaluation import widebench
    from centrifuge_tpu_torch.io.fastx import read_batch, read_fastx
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    dfm = DeviceFMIndex.build(port_index, device="cpu", wide=True)
    assert dfm.wide
    if paired:
        items = list(zip(read_fastx(os.path.join(SYNTH, "reads_1.fq")),
                         read_fastx(os.path.join(SYNTH, "reads_2.fq"))))
        want = _golden("golden_paired.tsv")
    else:
        items = read_batch([os.path.join(SYNTH, "reads.fq")])[:N_READS]
        want = _golden("golden_output.tsv", N_READS)
    text, rates = widebench.streams(
        port_index, items, 512, dfm, runs=1 if paired else 2,
        cfg=PipelineConfig(host_resolve=host_resolve), device="cpu",
        paired=paired)
    assert text == want
    assert len(rates) == (1 if paired else 2) and min(rates) > 0


def test_widebench_refuses_a_narrow_index():
    """main keeps the JAX harness's check: the index must hold 2^31 bases
    or more."""
    from centrifuge_tpu_torch.evaluation import widebench
    with pytest.raises(SystemExit, match="not the wide regime"):
        widebench.main([os.path.join(SYNTH, "synth"),
                        os.path.join(SYNTH, "reads.fq"), "--device", "cpu"])


def test_shardscale_main(port_index, tmp_path):
    """shardscale at --dp 2 --fm 4 on a CPU mesh (tests/test_parallel.py's
    JAX case): the mesh stream byte-equal to the golden TSV's first
    N_READS rows; the budget's linear part the shards' block and sample
    bytes, per-shard sizes shrinking with fm, each fit judged against the
    H100's memory."""
    from centrifuge_tpu_torch.parallel import shardscale
    from centrifuge_tpu_torch.parallel.sharded import ShardedFMArrays
    out = tmp_path / "shardscale.json"
    ref = tmp_path / "ref.tsv"
    ref.write_text(_golden("golden_output.tsv", N_READS))
    rc = shardscale.main([
        os.path.join(SYNTH, "synth"), os.path.join(SYNTH, "reads.fq"),
        "--dp", "2", "--fm", "4", "--reads-count", str(N_READS),
        "--batch", "512", "--ref-tsv", str(ref), "--out", str(out),
        "--device", "cpu"])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["parity_vs_reference_binary"] is True
    assert data["mesh"] == {"dp": 2, "fm": 4} and data["reads"] == N_READS
    assert data["k6_launches"] == {"sharded_search": 0, "sharded_resolve": 0}
    bud = data["memory_budget"]
    sh = ShardedFMArrays.build(port_index, 4)
    assert bud["measured_linear_sharded_bytes"] == \
        sh.blocks.nbytes + sh.offs.nbytes
    assert bud["measured_const_sharded_bytes"] == sh.ftab_tb.nbytes
    card = shardscale.H100_MEMORY_BYTES
    assert bud["card_bytes"] == card and bud["narrow_to_wide_adjusted"]
    for row in bud["table"].values():
        sizes = [row[f"fm{nf}_per_shard_gb"] for nf in (1, 2, 4, 8, 16)]
        assert sizes == sorted(sizes, reverse=True)
        for nf in (1, 2, 4, 8, 16):
            assert row[f"fm{nf}_fits_card"] == (
                row[f"fm{nf}_per_shard_gb"] * 1e9 < 0.85 * card)
    nt = bud["table"]["64Gbp_nt_class"]
    assert nt["fm8_per_shard_gb"] < nt["fm4_per_shard_gb"] \
        < nt["fm1_per_shard_gb"]


@pytest.mark.parametrize("n_fm,wide", [(1, False), (4, False), (4, True)],
                         ids=["fm1_narrow", "fm4_narrow", "fm4_wide"])
def test_sharded_bytes_match_jax(synth_index, port_index, n_fm, wide):
    """The block and sample bytes shardscale's budget counts: the port's
    ShardedFMArrays.build against the JAX build on the same index (numpy,
    no compile), and from_device_index (wide_scale's mesh) against
    build."""
    from centrifuge_tpu.parallel.sharded import ShardedFMArrays as JaxSh
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    from centrifuge_tpu_torch.parallel.sharded import ShardedFMArrays
    jsh = JaxSh.build(synth_index, n_fm, wide=wide)
    sh = ShardedFMArrays.build(port_index, n_fm, wide=wide)
    for k in ("blocks", "offs"):
        assert getattr(sh, k).nbytes == np.asarray(getattr(jsh, k)).nbytes
        assert getattr(sh, k).shape == np.asarray(getattr(jsh, k)).shape
    dev = ShardedFMArrays.from_device_index(DeviceFMIndex.build(
        port_index, device="cpu", wide=wide, deep_ftab=False), n_fm)
    for k in ("blocks", "fchr", "ftab_tb", "offs", "boundary_rows",
              "boundary_refs"):
        a, b = getattr(dev, k), getattr(sh, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (dev.zoff, dev.bwt_len, dev.wide) == (sh.zoff, sh.bwt_len,
                                                 sh.wide)


def test_shardbench_cpu_census():
    """shardbench --cpu on a (1, 8) CPU mesh: its reads by owning shard
    equal the lookups the plain sharded search records, counted here
    against each shard's own key range; no kernel launch."""
    from centrifuge_tpu_torch.parallel import shardbench
    from centrifuge_tpu_torch.parallel.sharded import (
        MeshIndex, ShardedFMArrays, ShardedSearchEngine, make_mesh,
        sharded_search_plain)
    line = shardbench.leg_cpu(n_reads=CENSUS_READS)
    assert line["n_fm"] == 8 and line["k6_launches_per_batch"] == 0
    # the same search, recorded, and counted shard by shard
    idx = shardbench._index()
    index = MeshIndex(ShardedFMArrays.build(idx, 8),
                      make_mesh(1, 8, ["cpu"] * 8))
    eng = ShardedSearchEngine(index)
    seqs = [s for r in shardbench._mk_reads(CENSUS_READS)
            for s in (r.seq, r.revcomp())]
    rseqp, lengths = eng.pack_transport(seqs, 160, len(seqs))
    stats = {}
    sharded_search_plain(index, torch.from_numpy(rseqp),
                         torch.from_numpy(lengths),
                         torch.zeros(len(seqs), dtype=torch.int32), 16,
                         eng.min_hitlen, eng.increment, False, stats=stats)
    want = []
    for s in index.rows[0].shards:
        n = 0
        for key, base, per in (("rank_rows", s.blk_base, index.nblk_per),
                               ("bwt_rows", s.blk_base, index.nblk_per),
                               ("ftab", s.ftab_base, index.nftab_per)):
            for keys in stats[key]:
                k = keys.to(torch.int64) >> (9 if key != "ftab" else 0)
                n += int(((k >= base) & (k < base + per)).sum())
        want.append(n)
    total = sum(sum(t.numel() for t in stats[k])
                for k in ("rank_rows", "bwt_rows", "ftab"))
    assert line["reads_by_shard"] == want and line["reads"] == total
    assert line["steps"] == len(stats["ftab"])
    assert line["share_off_row_lead"] == round(1 - want[0] / total, 4)
    assert line["lanes"] == len(seqs)


def test_shardbench_real_rows_identical():
    """shardbench --real on the CPU at a small size: the plain engine and
    the (1, 1) mesh give the same rows; no kernel launch."""
    from centrifuge_tpu_torch.parallel import shardbench
    line = shardbench.leg_real("cpu", n_reads=128, batch=128)
    assert line["rows_identical"] is True
    assert len(line["plain_runs"]) == len(line["sharded_runs"]) == 3
    assert not any(line["launches"].values())


def test_scaling_bench_one_process(tmp_path, capsys):
    """scaling_bench's per-process leg, one process joined over gloo (in
    this process), a (2, 2) CPU mesh over the first N_READS reads: its
    rows equal the golden rows; its line names what it ran on."""
    import torch.distributed as dist
    from centrifuge_tpu_torch.parallel import scaling_bench
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "shard0.tsv"
    try:
        rc = scaling_bench.main([
            "--coordinator", f"localhost:{port}", "--nprocs", "1",
            "--procid", "0", "--local-devices", "4", "--n-fm", "2", "-x",
            os.path.join(SYNTH, "synth"), "-U",
            os.path.join(SYNTH, "reads.fq"), "--limit", str(N_READS),
            "--batch", str(N_READS), "--out", str(out), "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["nprocs"] == 1 and line["per_process_reads"] == N_READS
    assert line["mesh"] == [2, 2] and line["devices"] == ["cpu"] * 4
    assert "no card" in line["hardware_caveat"]
    assert out.read_text() == "".join(
        _golden("golden_output.tsv", N_READS).splitlines(True)[1:])


@pytest.mark.parametrize("bwt_len", [5003, (1 << 16) + 7])
def test_wide_table_matches_oracle(bwt_len):
    """wide_table.random_wide_index at a small size on the CPU, against
    FMOracle over the same BWT (decoded from the table): the occ of every
    block row, fchr, '$', the samples, the depth-10 ftab (the oracle's
    backward search of 1,000 random 10-mers), and walk_reads' reads,
    which the oracle finds in the table."""
    from centrifuge_tpu_torch.evaluation import wide_table
    from centrifuge_tpu_torch.ops.fm_numpy import FMOracle
    from centrifuge_tpu_torch.ops.rank import bwt_at_plain, u32
    fm = wide_table.random_wide_index(bwt_len, 5, "cpu")
    n = fm.bwt_len
    assert fm.wide and fm.blocks.shape == (n // 512 + 1, 40)
    bwt = bwt_at_plain(fm.blocks, torch.arange(n)).numpy().astype(np.uint8)
    n_samples = -(-n >> fm.offrate)
    idx = types.SimpleNamespace(
        bwt=bwt, zoff=fm.zoff, fchr=fm.fchr.numpy(), npat=fm.npat,
        boundary_rows=fm.boundary_rows.numpy(),
        boundary_refidx=fm.boundary_refs.numpy(), offrate=fm.offrate,
        offs=fm.offs.reshape(-1)[:n_samples].numpy(), ftab_chars=10,
        ftab_top=fm.ftab_top.numpy(), ftab_bot=fm.ftab_bot.numpy())
    orc = FMOracle(idx)
    # '$' in the last rows, stored as code 0; the padding is code 0 too
    assert bwt[fm.zoff] == 0 and fm.zoff >= n - 1 - min(1 << 20, n - 2)
    codes = bwt_at_plain(fm.blocks, torch.arange(n, 512 * fm.nblk))
    assert not codes.any()
    cnt = np.bincount(np.delete(bwt, fm.zoff), minlength=4)
    assert fm.fchr.tolist() == [0, *np.cumsum(cnt).tolist()]
    assert fm.fchr[4] == n - 1
    # occ: the count of each code before each block row, '$' as code 0
    starts = 512 * np.arange(fm.nblk)
    occ = u32(fm.blocks[:, :4]) | (u32(fm.blocks[:, 4:8]) << 32)
    for c in range(4):
        want = orc.rank(starts, np.full(fm.nblk, c)) \
            + ((c == 0) & (fm.zoff < starts))
        assert np.array_equal(occ[:, c].numpy(), want)
    assert fm.offs.reshape(-1)[n_samples:].eq(0).all()
    assert int(fm.offs.max()) < fm.npat
    assert np.all(np.diff(idx.boundary_rows) > 0) and fm.zoff in \
        idx.boundary_rows
    # the depth-10 ftab: the oracle's backward search, last char first
    for fi in np.random.default_rng(1).integers(0, 1 << 20, 1000):
        pat = [(int(fi) >> (2 * (9 - i))) & 3 for i in range(10)]
        top, bot = int(orc.fchr[pat[9]]), int(orc.fchr[pat[9] + 1])
        for c in pat[8::-1]:
            top, bot = int(orc.lf(top, c)), int(orc.lf(bot, c))
        assert (int(fm.ftab_top[fi]), int(fm.ftab_bot[fi])) == (top, bot)
    # every read walked back through the table occurs in it
    for read in wide_table.walk_reads(fm, 50, 40, 9, subst=0.0):
        top, bot = int(orc.fchr[read[-1]]), int(orc.fchr[read[-1] + 1])
        for c in read[-2::-1]:
            top, bot = int(orc.lf(top, c)), int(orc.lf(bot, c))
        assert bot > top
