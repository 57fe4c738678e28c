"""The reader of `staged_upload_share`: the staged bytes over all the
uploaded bytes, and nothing where the program has no staged counter (an
older commit) or uploaded nothing."""

from types import SimpleNamespace

import pytest

from benchmark import catalog


@pytest.mark.parametrize("counters, want", [
    (dict(upload_bytes=400, staged_upload_bytes=400), 1.0),
    (dict(upload_bytes=400, staged_upload_bytes=100), 0.25),
    (dict(upload_bytes=400), None),
    (dict(upload_bytes=0, staged_upload_bytes=0), None),
])
def test_staged_upload_share(counters, want):
    read = catalog.metric_reader("staged_upload_share")
    assert read(SimpleNamespace(counters=counters)) == want
