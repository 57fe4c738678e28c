"""Route b of the parity surface on the CPU: every case of
chip_smoke.PARITY_CASES through the port's classify CLI with
GPUClassificationPipeline on host_resolve=False (the presolve K5 and the
resolve walk K3 in each dispatch, the tail's misses through K3; here
their plain versions), byte-equal to the reference goldens. The CLI has
no resolve flag, as the JAX CLI has none: chip_smoke.parity_pipe stands
in for the pipeline the CLI builds."""

import pytest

import chip_smoke
from test_torch_parity import check_route, port, shared  # noqa: F401
from test_torch_twin import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES,
                         ids=[c.name for c in chip_smoke.PARITY_CASES])
def test_parity_device_resolve(port, shared, case, tmp_path):  # noqa: F811
    check_route(port, shared, case, "b", tmp_path)
