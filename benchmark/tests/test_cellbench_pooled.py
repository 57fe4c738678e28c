"""The readers of `download_bytes_per_read` and `pooled_download_share`:
the copied-back bytes a read, and the pool's share of them; nothing
where the program has no pool counter (an older commit), copied
nothing back or classified nothing."""

from types import SimpleNamespace

import pytest

from benchmark import catalog


@pytest.mark.parametrize("counters, reads, want", [
    (dict(download_bytes=528 * 1000), 1000, 528.0),
    (dict(download_bytes=208 * 1000, pooled_download_bytes=208 * 1000),
     1000, 208.0),
    (dict(download_bytes=100), 0, None),
    (dict(), 1000, None),
])
def test_download_bytes_per_read(counters, reads, want):
    read = catalog.metric_reader("download_bytes_per_read")
    assert read(SimpleNamespace(counters=counters, reads=reads)) == want


@pytest.mark.parametrize("counters, want", [
    (dict(download_bytes=400, pooled_download_bytes=400), 1.0),
    (dict(download_bytes=400, pooled_download_bytes=100), 0.25),
    (dict(download_bytes=400), None),
    (dict(download_bytes=0, pooled_download_bytes=0), None),
])
def test_pooled_download_share(counters, want):
    read = catalog.metric_reader("pooled_download_share")
    assert read(SimpleNamespace(counters=counters)) == want
