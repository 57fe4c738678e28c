"""The port's device index (ops/fm_torch.py) and rank (ops/rank.py)
against the JAX package on the synth index: packing byte for byte, the
index carried across from a JAX DeviceFMIndex (from_jax_arrays) equal to
the port's own build, the plain rank equal to the JAX rank kernels
(XLA and the Pallas kernel in interpret mode), and the plain depth-12
ftab equal to the JAX device build and the native host extension.
Integers throughout: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fixture_path
from test_torch_twin import one_torch_thread  # noqa: F401

FIELDS = ("ufm", "fchr", "ftab_top", "ftab_bot", "offs", "boundary_rows",
          "boundary_refs")


@pytest.fixture(scope="module")
def port_index():
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    return load_cf_index(fixture_path("synth", "synth"))


@pytest.fixture(scope="module")
def builds(synth_index, port_index):
    """(JAX DeviceFMIndex, the port's build on the CPU) per (wide, deep)."""
    from centrifuge_tpu.ops.fm_jax import DeviceFMIndex as JaxFM
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    return {(w, d): (JaxFM.build(synth_index, wide=w, deep_ftab=d),
                     DeviceFMIndex.build(port_index, device="cpu", wide=w,
                                         deep_ftab=d))
            for w in (False, True) for d in (False, True)}


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_packing_byte_equal(synth_index, wide):
    from centrifuge_tpu.ops import fm_jax
    from centrifuge_tpu_torch.ops import fm_torch
    blocks = fm_torch.pack_bwt_blocks(synth_index.bwt, wide)
    np.testing.assert_array_equal(
        blocks, fm_jax.pack_bwt_blocks(synth_index.bwt, wide))
    assert blocks.dtype == np.uint32
    np.testing.assert_array_equal(
        fm_torch.pack_ftab_rows(synth_index.ftab_top, synth_index.ftab_bot,
                                wide, blocks.shape[1]),
        fm_jax.pack_ftab_rows(synth_index.ftab_top, synth_index.ftab_bot,
                              wide, blocks.shape[1]))
    np.testing.assert_array_equal(fm_torch._pack_offs8(synth_index.offs),
                                  fm_jax._pack_offs8(synth_index.offs))


@pytest.mark.parametrize("deep", [False, True], ids=["plain", "deep"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_from_jax_arrays_equals_build(builds, wide, deep):
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    j, fm = builds[wide, deep]
    d = {k: np.asarray(getattr(j, k)) for k in FIELDS}
    meta = dict(nblk=j.nblk, nblk12=j.nblk12, zoff=j.zoff,
                bwt_len=j.bwt_len, ftab_chars=j.ftab_chars,
                offrate=j.offrate, npat=j.npat, wide=j.wide)
    carried = DeviceFMIndex.from_jax_arrays(d, meta, device="cpu")
    assert fm.wide == wide and fm.deep == deep and carried.deep == deep
    assert fm.tensors().keys() == carried.tensors().keys()
    for k, t in fm.tensors().items():
        c = carried.tensors()[k]
        assert t.dtype == c.dtype, k
        assert torch.equal(t, c), k
    for k in ("zoff", "bwt_len", "ftab_chars", "offrate", "npat", "nblk"):
        assert getattr(fm, k) == getattr(carried, k) == getattr(j, k), k
    np.testing.assert_array_equal(fm.host_blocks, carried.host_blocks)
    assert fm.row_dtype == (torch.int64 if wide else torch.int32)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_rank_matches_jax(builds, synth_index, wide):
    from centrifuge_tpu.ops.fm_jax import lf_kernel, rank_kernel
    from centrifuge_tpu.ops.pallas_rank import rank_with_pallas
    from centrifuge_tpu_torch.ops.rank import bwt_at_plain, lf, rank
    j, fm = builds[wide, False]
    rng = np.random.default_rng(1)
    B = 2048
    it = np.int64 if wide else np.int32
    rows = rng.integers(0, synth_index.bwt_len + 1, B)
    # the traps: word and block edges (a full-word mask must not shift
    # by 32) and the '$' row, stored as code 0 and subtracted once
    rows[:12] = [0, 15, 16, 511, 512, 513, fm.zoff - 1, fm.zoff,
                 fm.zoff + 1, fm.zoff + 16, synth_index.bwt_len - 1,
                 synth_index.bwt_len]
    rows = rows.astype(it)
    chars = rng.integers(0, 4, B).astype(np.int32)
    chars[:12] = 0
    jz = jnp.asarray(j.zoff, j.row_dtype)
    want = np.asarray(rank_kernel(j.blocks, jz, jnp.asarray(rows),
                                  jnp.asarray(chars)))
    tr, tc = torch.from_numpy(rows), torch.from_numpy(chars)
    got = rank(fm.blocks, fm.zoff, tr, tc)
    assert got.dtype == tr.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if not wide:   # the Pallas kernel covers the narrow layout only
        pal = np.asarray(rank_with_pallas(j.blocks, jz, jnp.asarray(rows),
                                          jnp.asarray(chars),
                                          interpret=True))
        np.testing.assert_array_equal(got.numpy(), pal)
    want_lf = np.asarray(lf_kernel(j.blocks, j.fchr, jz, jnp.asarray(rows),
                                   jnp.asarray(chars)))
    np.testing.assert_array_equal(
        lf(fm.blocks, fm.fchr, fm.zoff, tr, tc).numpy(), want_lf)
    np.testing.assert_array_equal(
        bwt_at_plain(fm.blocks, tr).numpy(),
        synth_index.bwt[np.minimum(rows, synth_index.bwt_len - 1)])


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_level1_matches_jax(builds, wide):
    """The port's plain level 1 of the depth-12 ftab (ops/rank.py
    level1_plain, what K0's level-1 entry is held to) on the synth
    index's 2^20 depth-10 ranges, at 256 of them (empty parents, the
    ranges that hold the '$' row, random ones), against the JAX
    package's level 1 on the same (row, char) pairs: lf_kernel of both
    ends for every char under its guard, where(b0 > t0, LF, 0); narrow
    also the Pallas kernel in interpret mode plus fchr, same guard."""
    from centrifuge_tpu.ops.fm_jax import lf_kernel
    from centrifuge_tpu.ops.pallas_rank import rank_with_pallas
    from centrifuge_tpu_torch.ops.fm_torch import N10
    from centrifuge_tpu_torch.ops.rank import level1_plain
    j, fm = builds[wide, False]
    t0, b0 = fm.ftab_top[:N10], fm.ftab_bot[:N10]
    t1, b1 = level1_plain(fm.blocks, fm.fchr, fm.zoff, t0, b0)
    assert t1.dtype == b1.dtype == fm.row_dtype
    rng = np.random.default_rng(4)
    empty = np.nonzero((b0 <= t0).numpy())[0]
    dollar = np.nonzero(((t0 <= fm.zoff) & (b0 > fm.zoff)).numpy())[0]
    live = np.nonzero((b0 > t0).numpy())[0]
    e = np.concatenate([rng.choice(empty, 64, replace=False), dollar,
                        rng.choice(live, 256, replace=False)])[:256]
    n = e.shape[0]
    chars = np.repeat(np.arange(4, dtype=np.int32), n)
    at = (np.arange(4)[:, None] * N10 + e[None, :]).reshape(-1)
    jz = jnp.asarray(j.zoff, j.row_dtype)
    for ends, got in ((t0, t1), (b0, b1)):
        rows = np.tile(ends.numpy()[e], 4)
        ok = np.tile((b0 > t0).numpy()[e], 4)
        want = np.where(ok, np.asarray(lf_kernel(
            j.blocks, j.fchr, jz, jnp.asarray(rows), jnp.asarray(chars))), 0)
        np.testing.assert_array_equal(got.numpy()[at], want)
        if not wide:   # the Pallas kernel covers the narrow layout only
            pal = np.asarray(rank_with_pallas(
                j.blocks, jz, jnp.asarray(rows), jnp.asarray(chars),
                interpret=True)) + np.asarray(j.fchr)[chars]
            np.testing.assert_array_equal(got.numpy()[at],
                                          np.where(ok, pal, 0))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_ftab12_matches_jax_and_host(builds, port_index, wide):
    from centrifuge_tpu_torch.native.fmwalk import ftab_extend
    from centrifuge_tpu_torch.ops.fm_torch import pack_ftab_rows
    j, fm = builds[wide, True]
    ufm = np.asarray(j.ufm)
    np.testing.assert_array_equal(fm.ftab12_rows.numpy().view(np.uint32),
                                  ufm[j.nblk12:])
    ft12 = ftab_extend(fm.host_blocks, port_index, wide)
    assert ft12 is not None, "the native host extension must build"
    np.testing.assert_array_equal(
        fm.ftab12_rows.numpy().view(np.uint32),
        pack_ftab_rows(ft12[0], ft12[1], wide, ufm.shape[1]))


def test_cuda_is_the_default_device(port_index):
    """Entry points run on the card unless asked for the CPU: without a
    card the default raises instead of falling back."""
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.ops.fm_torch import DeviceFMIndex
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFMIndex.build(port_index)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPUClassificationPipeline(port_index)
