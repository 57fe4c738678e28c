"""Route d of the parity surface on the CPU: the cases of
chip_smoke.PARITY_CASES that change what the kernels see, through the
port's classify CLI over a (1, 2) mesh of ["cpu"] * 2 (K6's search, and
its walk on the device resolve; here their plain versions), on both
resolve paths, byte-equal to the reference goldens. The module shares
one ShardedFMArrays of each index."""

import pytest

import chip_smoke
from test_torch_parity import check_route, port, shared  # noqa: F401
from test_torch_twin import one_torch_thread  # noqa: F401

CASES = [c for c in chip_smoke.PARITY_CASES if c.device_work]


@pytest.mark.parametrize("route", ["d-host", "d-device"])
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_parity_mesh(port, shared, case, route, tmp_path):  # noqa: F811
    check_route(port, shared, case, route, tmp_path)
