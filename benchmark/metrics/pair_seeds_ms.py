"""The main thread's time a batch in the pairs' tie-break seeds
(`PerfMetrics.pair_seed_secs`: `_paired_seeds`). None where the program
has no such counter or no batch came out."""


def read(run):
    secs = run.counters.get("pair_seed_secs")
    return 1e3 * secs / run.batches \
        if secs is not None and run.batches else None
