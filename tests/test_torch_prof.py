"""evaluation/prof.py, the cost breakdown of the GPU pipeline's main path,
on the CPU at a tiny size (the synth fixture, 2 batches of 256 reads or
pairs): every key of the JSON line, the main thread's split against the
loop it replays, the device timings null. And the plain search loop's
steps per lane against the JAX package's search_loop(count_steps=True),
lane for lane."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

# keys with the JAX profile's meaning (centrifuge_tpu/evaluation/prof.py)
JAX_KEYS = ("device_search_fetch_ms", "device_compute_ms", "dispatch_ms",
            "transfer_block_ms", "host_tail_ms", "host_prep_ms",
            "e2e_serial_reads_per_sec", "e2e_serial_runs",
            "e2e_serial_collect_wait_s", "e2e_serial_tail_wait_s",
            "e2e_serial_tail_run_s", "e2e_serial_batches",
            "e2e_threaded_reads_per_sec", "e2e_threaded_runs",
            "e2e_threaded_collect_wait_s", "e2e_threaded_tail_wait_s",
            "e2e_threaded_tail_run_s", "e2e_threaded_batches",
            "upload_mb_per_batch", "download_mb_per_batch",
            "resolve_rows_per_batch", "index_bwt_len")
LOCKSTEP_KEYS = ("lockstep_mean_steps", "lockstep_max_steps",
                 "lockstep_survivors")
# null on the CPU: times of the card
DEVICE_KEYS = ("device_search_fetch_ms", "device_compute_ms",
               "device_presolve_ms", "device_ops", "nvidia_smi", "card")
# the replayed steps are leaves of the loop the profile times as a whole;
# what they leave out is the loop's own glue (a deque, the timers)
SPLIT_TOLERANCE = 0.05


def _synth(name):
    return fixture_path("synth", name)


CASES = {
    "host_resolve": ["--reads", _synth("reads.fq")],
    "device_resolve": ["--reads", _synth("reads.fq"), "--no-host-resolve",
                       "--no-steps"],
    "paired": ["--paired", "--reads", _synth("reads_1.fq"), "--reads2",
               _synth("reads_2.fq"), "--no-steps"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_prof_cpu_breakdown(case, tmp_path, capsys):
    from centrifuge_tpu_torch.evaluation import prof
    out = tmp_path / "prof.json"
    argv = CASES[case] + ["--device", "cpu", "--batch", "256", "--batches",
                          "2", "--runs", "1", "--out", str(out)]
    assert prof.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.read_text() == line + "\n"
    art = json.loads(line)
    assert art["metric"] == "e2e_cost_breakdown"
    assert art["device"] == "cpu"
    paired = case == "paired"
    host = case != "device_resolve"
    assert (art["paired"], art["host_resolve"]) == (paired, host)
    assert art["resolver"] == ("HostResolver" if host else "function")
    assert art["presolve"] is not host
    assert (art["batches"], art["batch_reads"], art["reads"]) == (2, 256, 512)
    for k in JAX_KEYS + ("lanes", "device_idle_share", "host_prep_split_ms",
                         "host_tail_runs_ms"):
        assert k in art, k
    for k in DEVICE_KEYS:
        assert art[k] is None, k
    assert art["device_idle_share"] == {"value": None,
                                        "method": "not measured: no card"}
    assert art["e2e_serial_batches"] == art["e2e_threaded_batches"] == 2
    assert len(art["e2e_serial_runs"]) == len(art["e2e_threaded_runs"]) == 1
    assert art["resolve_rows_per_batch"] > 0

    split = art["host_prep_split_ms"]
    assert tuple(split) == (prof.PAIRED_STEPS if paired
                            else prof.UNPAIRED_STEPS)
    assert all(v >= 0 for v in split.values()), split
    total = art["host_prep_ms"]
    assert (1 - SPLIT_TOLERANCE) * total <= sum(split.values()) \
        <= total * (1 + 1e-9)
    if case == "host_resolve":
        assert 0 < art["lockstep_mean_steps"] <= art["lockstep_max_steps"]
        steps = [s["step"] for s in art["lockstep_survivors"]]
        assert steps == sorted(steps) and steps[-1] <= \
            art["lockstep_max_steps"]
    else:
        assert not any(k in art for k in LOCKSTEP_KEYS)


@functools.partial(jax.jit, static_argnames=("min_hitlen", "increment",
                                             "nblk"))
def _jax_steps(ufm, fchr, ftab_tb, zoff, rseq, lengths, min_hitlen,
               increment, nblk):
    from centrifuge_tpu.classify.engine import direct_kernels, search_loop
    kern = direct_kernels(ufm, fchr, ftab_tb, zoff, nblk)
    return search_loop(kern, rseq, lengths, jnp.zeros_like(lengths),
                       min_hitlen, increment, 32, False, unroll=1,
                       count_steps=True)[6]


@pytest.mark.parametrize("one_row", [False, True],
                         ids=["direct", "one_row"])
def test_steps_match_jax_search_loop(synth_index, one_row):
    """The port's step is JAX's `direct_kernels` step without `nblk`: one
    start or one char a step, the same count lane for lane. With `nblk`
    (the one-row step JAX's engine runs) a lane whose bot row lies past
    its top row's block waits one more step (the `pend` deferral the port
    does not copy), so JAX counts at least as many, and more on some
    lanes."""
    from centrifuge_tpu.classify.engine import BatchSearchEngine as JaxEngine
    from centrifuge_tpu.ops.fm_jax import DeviceFMIndex as JaxFM
    from centrifuge_tpu_torch.classify import engine as em
    from centrifuge_tpu_torch.io.fastx import read_batch
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    seqs = []
    for r in read_batch([_synth("reads.fq")], limit=128):
        seqs += [r.seq, r.revcomp()]
    j = JaxFM.build(synth_index, wide=False, deep_ftab=False,
                    keep_host_blocks=True)
    arrays = {k: np.asarray(getattr(j, k)) for k in (
        "ufm", "fchr", "ftab_top", "ftab_bot", "offs", "boundary_rows",
        "boundary_refs")}
    meta = dict(nblk=j.nblk, nblk12=j.nblk12, zoff=j.zoff, bwt_len=j.bwt_len,
                ftab_chars=j.ftab_chars, offrate=j.offrate, npat=j.npat,
                wide=j.wide)
    fm = DeviceFMIndex.from_jax_arrays(arrays, meta, device="cpu")
    mhl = 22
    jeng = JaxEngine(j, mhl)
    rseq, lengths = jeng.pack(seqs, 160, len(seqs))
    want = np.asarray(_jax_steps(
        j.ufm, j.fchr, j.ftab_tb, jnp.asarray(j.zoff, j.row_dtype),
        jnp.asarray(rseq.astype(np.int32)), jnp.asarray(lengths),
        min_hitlen=mhl, increment=jeng.increment,
        nblk=j.nblk if one_row else None))
    eng = em.BatchSearchEngine(fm, mhl)
    rseqp, plens = eng.pack_transport(seqs, 160, len(seqs))
    stats = {}
    em.search_plain(fm, torch.from_numpy(rseqp), torch.from_numpy(plens),
                    torch.zeros(len(seqs), dtype=torch.int32), 16, mhl,
                    eng.increment, False, False, stats=stats)
    got = torch.cat(stats["steps"]).numpy()
    assert got.min() > 0
    if one_row:
        assert (want >= got).all() and (want > got).any()
    else:
        np.testing.assert_array_equal(got, want)
