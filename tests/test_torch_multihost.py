"""The port's multi-process classification on the CPU: two processes
joined by torch.distributed (gloo), each classifying its contiguous
shard of 512 synth reads over its own mesh of 4 CPU devices (n_fm 1 and
2, wide rows); the merged rows equal the golden rows, as
tests/test_multihost.py holds the JAX package's."""

import os
import socket
import subprocess
import sys

import pytest

from conftest import fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import sys
pid, nproc, n_fm, port = (int(a) for a in sys.argv[1:5])
out_path = sys.argv[5]
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
from centrifuge_tpu_torch.parallel import multihost
multihost.initialize(f"localhost:{port}", nproc, pid)
from centrifuge_tpu_torch.index.cf_io import load_cf_index
from centrifuge_tpu_torch.io.fastx import read_batch
idx = load_cf_index(%(idx)r)
pipe = multihost.make_multihost_pipeline(idx, n_fm=n_fm, wide=True,
                                         devices=["cpu"] * 4)
assert pipe.sync is multihost.sync_max
reads = read_batch([%(reads)r], limit=512)
mine = multihost.shard_reads(reads, pid, nproc)
rows = []
for chunk in pipe.classify_stream_unpaired(
        mine[i: i + 128] for i in range(0, len(mine), 128)):
    rows += chunk
with open(out_path, "w") as f:
    f.write("\\n".join(rows) + "\\n")
assert "jax" not in sys.modules and "centrifuge_tpu" not in sys.modules
"""


def _free_port() -> int:
    """A free local port, not the JAX test's 12501-12502."""
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in (12501, 12502):
            return port


@pytest.mark.parametrize("n_fm", [1, 2])
def test_two_process_classification(tmp_path, n_fm):
    nproc = 2
    port = _free_port()
    script = _WORKER % dict(repo=REPO, idx=fixture_path("synth", "synth"),
                            reads=fixture_path("synth", "reads.fq"))
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"shard{pid}.tsv"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(pid), str(nproc), str(n_fm),
             str(port), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, se = p.communicate(timeout=240)
            assert p.returncode == 0, se[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    merged = []
    for out in outs:
        merged += out.read_text().splitlines()
    golden = open(fixture_path(
        "synth", "golden_output.tsv")).read().splitlines()
    got_ids = {r.split("\t", 1)[0] for r in merged}
    want = [line for line in golden[1:]
            if line.split("\t", 1)[0] in got_ids]
    assert len(got_ids) == 512 and merged == want
