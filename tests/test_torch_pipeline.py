"""The port's classification pipeline and CLI on the CPU (the plain
PyTorch versions of the kernels): byte parity with the reference
goldens, and row parity with the JAX package's pipeline."""

import os
import sys

import pytest

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


def _batches(items, size=1024):
    return [items[i: i + size] for i in range(0, len(items), size)]


def test_unpaired_goldens(port_index, tmp_path):
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.report.writers import write_report
    pipe = GPUClassificationPipeline(port_index, device="cpu")
    recs = read_batch([os.path.join(SYNTH, "reads.fq")])
    rows = [pipe.formatter.header()]
    for chunk in pipe.classify_stream_unpaired(_batches(recs)):
        rows += chunk
    assert "\n".join(rows) + "\n" == _golden("golden_output.tsv")
    rep = tmp_path / "report.tsv"
    write_report(str(rep), port_index, pipe.spm, abundance_analysis=True)
    assert rep.read_text() == _golden("golden_report.tsv")


def test_paired_golden(port_index):
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_fastx
    pipe = GPUClassificationPipeline(port_index, device="cpu")
    pairs = list(zip(read_fastx(os.path.join(SYNTH, "reads_1.fq")),
                     read_fastx(os.path.join(SYNTH, "reads_2.fq"))))
    rows = [pipe.formatter.header()]
    for chunk in pipe.classify_stream_paired(_batches(pairs)):
        rows += chunk
    assert "\n".join(rows) + "\n" == _golden("golden_paired.tsv")
    # the main thread's pair steps are timed (benchmark: pair_prep_ms)
    assert pipe.metrics.pair_prep_secs > 0
    assert pipe.metrics.pair_seed_secs > 0


def _synth_pairs():
    from centrifuge_tpu_torch.io.fastx import read_fastx
    return list(zip(read_fastx(os.path.join(SYNTH, "reads_1.fq")),
                    read_fastx(os.path.join(SYNTH, "reads_2.fq"))))


def _event_names(run):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("threaded", [True, False],
                         ids=["threaded", "sequential"])
def test_paired_stream_spans_its_pair_steps(port_index, threaded):
    """Both branches of the paired stream (the tail-thread overlap and
    the sequential one) time the prep and the seeds into their counters
    and open the profiler ranges `pipeline.pair_prep` and
    `pipeline.pair_seeds`, with the rows unchanged."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import PipelineConfig
    pipe = GPUClassificationPipeline(
        port_index, PipelineConfig(threaded_stream=threaded), device="cpu")
    rows = [pipe.formatter.header()]

    def run():
        for chunk in pipe.classify_stream_paired(_batches(_synth_pairs())):
            rows.extend(chunk)

    names = _event_names(run)
    assert {"pipeline.pair_prep", "pipeline.pair_seeds"} <= names
    assert "\n".join(rows) + "\n" == _golden("golden_paired.tsv")
    assert pipe.metrics.pair_prep_secs > 0
    assert pipe.metrics.pair_seed_secs > 0


def test_unpaired_stream_has_no_pair_time_or_span(port_index):
    """The unpaired stream opens no range of the program's own and
    leaves the pair counters at 0."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_batch
    pipe = GPUClassificationPipeline(port_index, device="cpu")
    recs = read_batch([os.path.join(SYNTH, "reads.fq")], limit=1024)

    def run():
        for _ in pipe.classify_stream_unpaired(_batches(recs, 512)):
            pass

    names = _event_names(run)
    assert not [n for n in names if n.startswith("pipeline.")]
    assert pipe.metrics.reads == 1024
    assert pipe.metrics.pair_prep_secs == pipe.metrics.pair_seed_secs == 0


@pytest.mark.parametrize("tail", ["rows", "results"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_pool_form_tail_matches_padded(port_index, paired, tail):
    """The native tail's pool form of batch_begin (K1's hit pool, as a
    batch of 1,024 reads or 1,000 pairs searches it) against its padded form
    (the same pipeline with pool mode off): equal rows, from the row
    formatter (`rows`) and from the Python one over the tail's results
    (`results`); only the pool run counts pooled bytes, all of them."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_batch
    out = []
    for pool in (True, False):
        pipe = GPUClassificationPipeline(port_index, device="cpu")
        if not pool:
            pipe.engine._pool_budget = lambda *a: 0
        if tail == "results":
            pipe._flat_eligible = lambda: False
        if paired:
            rows = pipe.classify_batch_paired(_synth_pairs()[:1024])
        else:
            rows = pipe.classify_batch_unpaired(read_batch(
                [os.path.join(SYNTH, "reads.fq")], limit=1024))
        m = pipe.metrics
        assert m.download_bytes > 0 and m.pool_spills == 0
        assert m.pooled_download_bytes == (m.download_bytes if pool else 0)
        out.append(rows)
    assert out[0] == out[1] and len(out[0]) >= 1000


def test_met_rows_leave_out_the_pair_counters():
    """The --met surface (the reference's 134-name header, 30-value
    rows) is the same whatever the pair counters hold; the CLI's --met
    file is held to the reference's shape by test_torch_parity.py
    test_metrics_emission."""
    from centrifuge_tpu_torch.utils.metrics import (REF_COLUMNS,
                                                     PerfMetrics,
                                                     _row_values)
    def row(m):     # all but the clock (0) and the peak RSS (14)
        return [v for k, v in enumerate(_row_values(m)) if k not in (0, 14)]

    m = PerfMetrics(reads=7, bases=700, paired=3, resolve_rows=9)
    want = row(m)
    m.pair_prep_secs, m.pair_seed_secs = 1.5, 0.25
    assert row(m) == want
    assert len(_row_values(m)) == 30 and len(REF_COLUMNS) == 134
    assert m.minus(PerfMetrics()).pair_prep_secs == 1.5
    m.merge(m.snapshot())
    assert m.pair_seed_secs == 0.5


def test_rows_match_jax_pipeline(synth_index, port_index, monkeypatch):
    """The first 400 reads through both packages' pipelines, one batch.
    The JAX search loop is traced with unroll=1 (a per-lane no-op on
    done lanes, so outputs are unchanged) to keep its compile short."""
    import functools
    from centrifuge_tpu.classify import engine as jax_engine
    from centrifuge_tpu.classify.tpu_pipeline import \
        TPUClassificationPipeline
    from centrifuge_tpu.io.fastx import read_batch as jax_read_batch
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.io.fastx import read_batch
    monkeypatch.setattr(jax_engine, "search_loop", functools.partial(
        jax_engine.search_loop, unroll=1))
    path = os.path.join(SYNTH, "reads.fq")
    want = TPUClassificationPipeline(synth_index).classify_batch_unpaired(
        jax_read_batch([path], limit=400))
    got = GPUClassificationPipeline(port_index, device="cpu"
                                    ).classify_batch_unpaired(
        read_batch([path], limit=400))
    assert len(got) >= 400
    assert got == want


def test_cli_reproduces_golden(tmp_path, monkeypatch, capsys):
    """`python -m centrifuge_tpu_torch classify ... --device cpu`."""
    from centrifuge_tpu_torch import __main__ as entry
    out = tmp_path / "out.tsv"
    monkeypatch.setattr(sys, "argv", [
        "centrifuge_tpu_torch", "classify", "-x",
        os.path.join(SYNTH, "synth"), "-U",
        os.path.join(SYNTH, "reads.fq"), "-S", str(out), "--report-file",
        "", "--device", "cpu"])
    with pytest.raises(SystemExit) as ex:
        entry.main()
    assert ex.value.code == 0
    assert out.read_text() == _golden("golden_output.tsv")
