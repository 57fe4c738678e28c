"""The share of the search's uploaded bytes (lanes and lengths,
`PerfMetrics.upload_bytes`) that went to the card from page-locked host
memory (`PerfMetrics.staged_upload_bytes`): 1.0 when no upload waits for
the driver to stage pageable memory. None where the program has no such
counter or uploaded nothing."""


def read(run):
    staged = run.counters.get("staged_upload_bytes")
    total = run.counters.get("upload_bytes")
    return staged / total if staged is not None and total else None
