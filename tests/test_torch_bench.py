"""The port's bench (centrifuge_tpu_torch/bench.py) on the CPU at a tiny
size: the kernels' plain versions, 256 reads a batch (so 1,536 simulated
reads and 768 pairs), one trial.

The run's last line holds every key of bench.py's line (written out here,
not imported) and the port's three; the parity gate covers all 3,000
fixture reads (about 2.5 s of the 7 s run on one torch thread: kept
whole; each stream batch costs about 0.2 s in K1's plain step loop).
The port's simulation writes files byte-equal to the JAX package's for
the bench's seeds, unpaired and paired; that is the only use of JAX here.
A short simulation file raises SystemExit, and a size that is not a
multiple of the synth genomes is simulated whole. Without a card,
--device cuda exits non-zero before any phase. The exit code follows the
parity gate: main() on the first 64 fixture reads against their golden
rows exits 0, and against the same rows with one changed prints its line
with parity_ok false and exits 1 (its throughput trials stubbed there,
to keep the file near its 10 s budget: the gate and the line are real).
"""

import json
import os

import pytest
import torch

from test_torch_twin import one_torch_thread  # noqa: F401

# bench.py's result line, in its order (bench.py:179-204)
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "vs_ref_cpu_local",
            "runs", "reads", "device_search_ms_per_batch",
            "device_batch_lanes", "paired_pairs_per_sec", "paired_runs",
            "parity_ok", "native_engine", "native_pack", "native_fmwalk",
            "native_ok", "native_fallbacks")
PORT_KEYS = ("device", "card", "launches")
BATCH, READS, PAIRS = 256, 1536, 768  # the bench simulates 6 batches
GATE_READS = 64                         # the failed-parity case's reads


@pytest.fixture
def tmpdir_sims(tmp_path, monkeypatch):
    """The bench's temp directory, where it keeps its simulated reads."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_bench_line_on_the_cpu(tmpdir_sims, capsys):
    from centrifuge_tpu_torch import bench
    rc = bench.main(["--device", "cpu", "--batch", str(BATCH),
                     "--trials", "1"])
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert rc == 0
    assert set(line) == set(JAX_KEYS) | set(PORT_KEYS)
    assert line["metric"] == "reads_per_sec_e2e_synth"
    assert line["unit"] == "reads/s"
    assert line["parity_ok"] is True
    assert line["native_ok"] is True and line["native_fallbacks"] == {}
    assert line["reads"] == bench.N_STREAM_BATCHES * BATCH
    assert line["device_batch_lanes"] == 2 * BATCH
    assert len(line["runs"]) == len(line["paired_runs"]) == 1
    assert line["value"] == line["runs"][0] > 0
    assert line["paired_pairs_per_sec"] == line["paired_runs"][0] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.BASELINE_READS_PER_SEC, 3)
    # the CPU runs the plain versions: no card time, no card, no launch
    assert line["device"] == "cpu"
    assert line["card"] is None
    assert line["device_search_ms_per_batch"] is None
    assert set(line["launches"]) >= {"search"}
    assert not any(line["launches"].values())
    # the simulations renamed into place, nothing temporary left
    assert sorted(os.listdir(tmpdir_sims)) == sorted(
        [f"cftpu_torch_bench_sim_{READS}{s}" for s in (".fq", ".truth")]
        + [f"cftpu_torch_bench_pairs_{PAIRS}{s}"
           for s in ("_1.fq", "_2.fq", ".truth")])


@pytest.mark.parametrize("paired", [False, True],
                         ids=["unpaired", "paired"])
@pytest.mark.parametrize("seed", [42, 43])
def test_simulation_equals_jax(seed, paired, tmp_path):
    from centrifuge_tpu.evaluation import simulate as jax_sim
    from centrifuge_tpu_torch import bench
    from centrifuge_tpu_torch.evaluation import simulate as port_sim
    from centrifuge_tpu_torch.evaluation import synth_reads
    fix = bench.FIXDIR
    outs = []
    for name, mod in (("jax", jax_sim), ("port", port_sim)):
        cfg = mod.SimConfig(num_fragments=240,
                            read_length=synth_reads.READ_LEN,
                            error_rate=synth_reads.ERROR_RATE, seed=seed,
                            paired=paired)
        mod.simulate(os.path.join(fix, "db.fa"),
                     os.path.join(fix, "conv.dmp"),
                     str(tmp_path / name), cfg)
        outs.append(sorted(p.name[len(name):] for p in tmp_path.iterdir()
                           if p.name.startswith(name)))
    assert outs[0] == outs[1]
    assert outs[0] == sorted(["_1.fq", "_2.fq", ".truth"] if paired
                             else [".fq", ".truth"])
    for suffix in outs[0]:
        assert (tmp_path / f"jax{suffix}").read_bytes() == \
            (tmp_path / f"port{suffix}").read_bytes(), suffix


@pytest.mark.parametrize("paired", [False, True],
                         ids=["unpaired", "paired"])
def test_short_simulation_file_raises(paired, tmpdir_sims):
    from centrifuge_tpu_torch import bench
    with open(os.path.join(bench.FIXDIR, "reads.fq")) as f:
        head = "".join(next(f) for _ in range(4 * 10))
    prefix = bench.sim_prefix(READS, paired)
    for s in (("_1.fq", "_2.fq") if paired else (".fq",)):
        with open(prefix + s, "w") as f:
            f.write(head)
    with pytest.raises(SystemExit, match=f"has 10 .*expected {READS}"):
        bench.simulated(READS, paired, 42)


def test_no_cpu_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs on it")
    from centrifuge_tpu_torch import bench
    assert bench.main([]) != 0
    assert bench.main(["--device", "cuda", "--trials", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA card" in out.err


@pytest.mark.parametrize("paired", [False, True],
                         ids=["unpaired", "paired"])
def test_any_size_simulated_whole(paired, tmp_path):
    """25 records: not a multiple of the 24 genomes, each of which the
    simulation gives round(n / 24) of them."""
    from centrifuge_tpu_torch.evaluation.synth_reads import synth_reads
    recs = synth_reads(25, paired, 43, str(tmp_path / "s"))
    assert len(recs) == 25
    assert all(len(m) == 2 for m in recs) if paired else True
    assert not [p for p in os.listdir(tmp_path) if "tmp" in p]


@pytest.mark.parametrize("parity_ok,rc", [(True, 0), (False, 1)])
def test_failed_parity_exits_1(parity_ok, rc, tmpdir_sims, monkeypatch,
                               capsys):
    from centrifuge_tpu_torch import bench
    with open(bench.FIXTURE_READS) as f:
        fq = [next(f) for _ in range(4 * GATE_READS)]
    names = {fq[i][1:].split()[0] for i in range(0, len(fq), 4)}
    with open(bench.GOLDEN) as f:
        golden = f.read().splitlines()
    rows = [r for r in golden[1:] if r.split("\t")[0] in names]
    assert rows == golden[1: 1 + len(rows)]
    if not parity_ok:
        rows[-1] = rows[-1].replace("\t", "\t0", 1)
    gate = tmpdir_sims / "gate"
    gate.mkdir()
    (gate / "reads.fq").write_text("".join(fq))
    (gate / "golden.tsv").write_text("\n".join([golden[0]] + rows) + "\n")
    monkeypatch.setattr(bench, "FIXTURE_READS", str(gate / "reads.fq"))
    monkeypatch.setattr(bench, "GOLDEN", str(gate / "golden.tsv"))
    monkeypatch.setattr(bench.Bench, "trials",
                        lambda self, recs, paired, size, n: [1.0] * n)
    assert bench.main(["--device", "cpu", "--batch", "32",
                       "--trials", "1"]) == rc
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["parity_ok"] is parity_ok
    assert line["value"] == 1.0
