"""The port's entry points (centrifuge_tpu_torch/graft_entry.py) against
the JAX package's (__graft_entry__.py) and the reference goldens.

entry(): the port's K1 call on the CPU (the plain version) against the
JAX package's `search_loop` over `direct_kernels`, on the arguments
that __graft_entry__.entry() itself returns. The JAX side runs
search_loop with unroll=1, not jax.jit of the entry's function: the loop
body is a per-lane transition that is a no-op on done lanes, so the
unroll factor changes no output, and the entry's unroll of 8 costs
about 30 s of compile on a CPU against about 1 s. Integer outputs:
exact equality, unused hit slots included.

dryrun_multichip(): meshes of "cpu" entries, the rows held to the
golden rows; a changed golden, an empty golden and a short read file
each make it raise; an odd n whose dp rows do not divide the 256-lane
bucket raises ValueError, as the JAX package's does. Without a card,
neither entry point runs on the CPU unless asked.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.partial(jax.jit, static_argnames=(
    "min_hitlen", "increment", "max_hits", "first_hit_only"))
def _jax_search(blocks, fchr, ftab_tb, zoff, rseq, lengths, start,
                min_hitlen, increment, max_hits, first_hit_only):
    from centrifuge_tpu.classify.engine import direct_kernels, search_loop
    kern = direct_kernels(blocks, fchr, ftab_tb, zoff)
    return search_loop(kern, rseq, lengths, start, min_hitlen, increment,
                       max_hits, first_hit_only, unroll=1)


@pytest.fixture(scope="module")
def jax_args():
    """__graft_entry__.entry()'s example arguments, the module loaded by
    path."""
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, args = mod.entry()
    return args


@pytest.fixture(scope="module")
def port_entry():
    from centrifuge_tpu_torch.graft_entry import entry
    return entry(device="cpu")


def test_entry_lanes_equal_jax(jax_args, port_entry):
    from centrifuge_tpu_torch.classify.engine import unpack_reads
    _, args = port_entry
    rseq, lengths, start = (np.asarray(a) for a in jax_args[4:])
    codes = unpack_reads(args[4]).numpy()
    assert rseq.shape == (128, rseq.shape[1])
    np.testing.assert_array_equal(codes[:, : rseq.shape[1]], rseq)
    assert not codes[:, rseq.shape[1]:].any()
    np.testing.assert_array_equal(args[5].numpy(), lengths)
    np.testing.assert_array_equal(args[6].numpy(), start)
    assert args[3] == int(jax_args[3])


def test_entry_outputs_equal_jax_search(jax_args, port_entry):
    from centrifuge_tpu_torch.graft_entry import (INCREMENT, MAX_HITS,
                                                  MIN_HITLEN)
    fn, args = port_entry
    want = _jax_search(*jax_args, min_hitlen=MIN_HITLEN, increment=INCREMENT,
                       max_hits=MAX_HITS, first_hit_only=False)
    got = fn(*args)
    assert len(got) == len(want) == 6
    assert [tuple(g.shape) for g in got] == [(128, 8)] * 4 + [(128,)] * 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {k}")
    nhits = got[4].numpy()
    assert (nhits > 0).all()
    # unused slots hold (-1, -1, 0, 0)
    unused = np.arange(8)[None, :] >= nhits[:, None]
    assert unused.any()
    for k, v in enumerate((-1, -1, 0, 0)):
        assert (got[k].numpy()[unused] == v).all()


@pytest.fixture
def meshes_made(monkeypatch):
    """The (n_dp, n_fm) of every mesh the dry run makes."""
    from centrifuge_tpu_torch.parallel import sharded
    made = []
    real = sharded.make_mesh

    def spy(n_dp, n_fm, devices=None):
        made.append((n_dp, n_fm))
        return real(n_dp, n_fm, devices)

    monkeypatch.setattr(sharded, "make_mesh", spy)
    return made


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (8, (4, 2))])
def test_dryrun_on_cpu_meshes(n, shape, meshes_made):
    from centrifuge_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(n, devices=["cpu"] * n)
    assert meshes_made == [shape]


def test_dryrun_odd_n_raises_as_jax():
    from centrifuge_tpu_torch.graft_entry import dryrun_multichip
    with pytest.raises(ValueError, match="do not split over 3 dp rows"):
        dryrun_multichip(3, devices=["cpu"] * 3)


def _golden_lines():
    with open(fixture_path("synth", "golden_output.tsv")) as f:
        return f.read().splitlines(keepends=True)


def test_dryrun_fails_on_a_changed_golden_row(tmp_path, monkeypatch):
    from centrifuge_tpu_torch import graft_entry
    lines = _golden_lines()
    f = lines[5].rstrip("\n").split("\t")
    f[3] = str(int(f[3]) + 1)                 # the score of read 4
    lines[5] = "\t".join(f) + "\n"
    bad = tmp_path / "golden_output.tsv"
    bad.write_text("".join(lines))
    monkeypatch.setattr(graft_entry, "GOLDEN", str(bad))
    with pytest.raises(AssertionError, match="differ from the golden rows"):
        graft_entry.dryrun_multichip(1, devices=["cpu"])


def test_dryrun_fails_on_an_empty_golden(tmp_path, monkeypatch):
    from centrifuge_tpu_torch import graft_entry
    empty = tmp_path / "golden_output.tsv"
    empty.write_text(_golden_lines()[0])      # the header alone
    monkeypatch.setattr(graft_entry, "GOLDEN", str(empty))
    with pytest.raises(AssertionError, match="no golden row"):
        graft_entry.dryrun_multichip(1, devices=["cpu"])


def test_dryrun_fails_on_missing_reads(tmp_path, monkeypatch):
    from centrifuge_tpu_torch import graft_entry
    with open(fixture_path("synth", "reads.fq")) as f:
        head = [next(f) for _ in range(4 * 100)]
    short = tmp_path / "reads.fq"
    short.write_text("".join(head))
    monkeypatch.setattr(graft_entry, "READS", str(short))
    with pytest.raises(AssertionError, match="rows for 100 of 256 reads"):
        graft_entry.dryrun_multichip(1, devices=["cpu"])


@pytest.mark.skipif(torch.cuda.device_count() > 0,
                    reason="a card is present: the default devices exist")
def test_no_silent_cpu_without_a_card():
    from centrifuge_tpu_torch.graft_entry import dryrun_multichip, entry
    with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_module_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "centrifuge_tpu_torch.graft_entry",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines() == ["entry ok", "dryrun ok"]
