"""The share of the search engine's copied-back bytes
(`PerfMetrics.download_bytes`) that came from K1's dense hit pool
(`PerfMetrics.pooled_download_bytes`): 1.0 when every launch of the
window took pool mode. None where the program has no pool counter or
copied nothing back."""


def read(run):
    pooled = run.counters.get("pooled_download_bytes")
    total = run.counters.get("download_bytes")
    return pooled / total if pooled is not None and total else None
