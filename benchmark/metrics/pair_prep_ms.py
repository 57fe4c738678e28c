"""The main thread's time a batch in the paired prep
(`PerfMetrics.pair_prep_secs`: `_prep_paired`'s filters, reverse
complements, outer tallies and read units). None where the program has
no such counter or no batch came out."""


def read(run):
    secs = run.counters.get("pair_prep_secs")
    return 1e3 * secs / run.batches \
        if secs is not None and run.batches else None
