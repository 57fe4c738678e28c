"""The share of the main thread's own time in the pipeline
(main_thread_ms's: the window less the benchmark's hand-off and
consumer time and the pipeline's waits) that the paired prep and seeds
take (`PerfMetrics.pair_prep_secs` + `pair_seed_secs`): how far the pair
work sets the stream's pace. None where the program has no such
counters."""

from .main_thread_ms import read as main_thread_ms


def read(run):
    prep = run.counters.get("pair_prep_secs")
    seeds = run.counters.get("pair_seed_secs")
    ms = main_thread_ms(run)
    if prep is None or seeds is None or not ms or ms <= 0:
        return None
    return (prep + seeds) / (ms * run.batches / 1e3)
