"""The bytes the search engine copied back from the card a read
(`PerfMetrics.download_bytes` over the reads whose rows came out; a
pair's two mates count as two reads): K1's hits, padded or pooled, and
any presolve's rows. None where the run classified nothing."""


def read(run):
    n = run.counters.get("download_bytes")
    return n / run.reads if n is not None and run.reads else None
