"""The paired cell `bacterial256.paired`: its parts found by name, its
metrics, the readers of the pair counters (nothing where the program
has no such counter, as before those counters), and a tiny paired run on
the CPU that reads them."""

import json
from types import SimpleNamespace

import pytest

from benchmark import catalog, run
from conftest import DATA

BENCH = catalog.benchmark()
CELL = "bacterial256.paired"
NEW = ("pair_prep_ms", "pair_seeds_ms", "pair_prep_share")


def _run(counters, batches=4, window_s=2.0):
    base = dict(collect_wait_secs=0.2, tail_wait_secs=0.4)
    return SimpleNamespace(batches=batches, window_s=window_s,
                           handoff_s=0.1, consumer_s=0.1,
                           counters=dict(base, **counters))


def test_the_cell_finds_its_parts_by_name():
    cell = catalog.cell(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("bacterial256_paired", "paired", 1)
    assert catalog.config(cell["config"])["name"] == "bacterial256_paired"
    tr = catalog.traffic(cell["traffic"])
    assert (tr["read_len"], tr["sub_rate"], tr["paired"], tr["frag_min"],
            tr["frag_max"], tr["batch"], tr["pool_batches"]) == \
        (150, 0.002, True, 250, 400, 16384, 32)
    assert catalog.cell_options(CELL) == dict(sample_reads=2048)


def test_the_cell_reports_its_metrics():
    e2e = [m["name"] for m in catalog.metrics_of(BENCH, CELL, False)]
    assert e2e == ["device_ms_per_mread", "kernel_ms_per_mread", "setup_s"]
    layers = [m["name"] for m in catalog.metrics_of(BENCH, CELL, True)]
    assert layers == list(NEW)
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
            assert m["moves"] == "device_ms_per_mread"
    assert len({m["layer"] for m in BENCH["per_layer"]
                if m["name"] in NEW}) == 1


@pytest.mark.parametrize("counters, want", [
    (dict(pair_prep_secs=1.2, pair_seed_secs=0.4), (300.0, 100.0, 4 / 3)),
    (dict(pair_prep_secs=0.0, pair_seed_secs=0.0), (0.0, 0.0, 0.0)),
    (dict(pair_prep_secs=1.2), (300.0, None, None)),
    (dict(), (None, None, None)),
])
def test_the_pair_readers(counters, want):
    # main thread: 2.0 - 0.1 - 0.1 - 0.2 - 0.4 = 1.2 s over 4 batches
    got = tuple(catalog.metric_reader(n)(_run(counters)) for n in NEW)
    assert got == pytest.approx(want)


def test_the_pair_readers_need_a_batch():
    r = _run(dict(pair_prep_secs=0.0, pair_seed_secs=0.0), batches=0,
             window_s=0.0)
    assert [catalog.metric_reader(n)(r) for n in NEW] == [None] * 3


def test_a_tiny_paired_run_reads_the_pair_counters(tmp_path, cache):
    """tiny.paired on the CPU, traced, with the three metrics listed for
    it in a copy of the test data's BENCHMARK.json."""
    bench = catalog.benchmark(str(DATA) + "/BENCHMARK.json")
    bench["per_layer"] += [
        dict(m, workloads=["tiny.paired"]) for m in BENCH["per_layer"]
        if m["name"] in NEW]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = run.execute("tiny.paired", 2**32 + 5, 1.0, True, device="cpu",
                      bench_path=str(path), parts=DATA, cache=cache)
    assert out["correct"], out["check"]
    got = {n: out["metrics"][n]["value"] for n in NEW}
    assert got["pair_prep_ms"] > 0 and got["pair_seeds_ms"] > 0
    assert 0 < got["pair_prep_share"] < 1
