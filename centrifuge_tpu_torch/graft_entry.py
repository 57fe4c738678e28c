"""The port's entry points: one K1 launch and a mesh dry run.

entry(device="cuda") -> (fn, args): fn(*args) is one call of K1
    (classify/engine.py search_lanes: csrc/search.cu on the card, the
    plain version on the CPU) over the 128 lanes of the first 64 synth
    reads (fw then rc each, reversed, padded to lmax + ftab_chars codes,
    two codes a byte) at min_hitlen 22, increment 11 and 8 hit slots.
    It returns the six outputs [h_top, h_bot, h_off, h_len, nhits, sums]
    on `device`; args holds the tables it reads, zoff, the lanes, their
    lengths and start cursors, on `device`.
dryrun_multichip(n, devices=None): the classification over an (n/2, 2)
    (dp, fm) mesh, (n, 1) for odd n, on the wide (int64) layout: K6's
    search a dp row, the host walk over the fm-padded blocks. It streams
    the first 256 synth reads in 128-read chunks and raises
    AssertionError unless the rows equal the golden rows of those reads.
    devices: the first n CUDA devices by default; a device may repeat
    (["cuda:0"] * n on one card, ["cpu"] * n for the plain versions).
    The lanes of a batch split evenly over the dp rows, so an n whose dp
    rows do not divide the 256-lane bucket (3, 6, ...) raises ValueError.

    python -m centrifuge_tpu_torch.graft_entry [--device cpu]

runs fn(*args) and prints "entry ok", then dryrun_multichip over every
CUDA device (8 CPU entries under --device cpu) and prints "dryrun ok";
any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "synth")
READS = os.path.join(FIXDIR, "reads.fq")
GOLDEN = os.path.join(FIXDIR, "golden_output.tsv")

ENTRY_READS = 64        # 2 lanes a read
MIN_HITLEN = 22
INCREMENT = 11
MAX_HITS = 8
DRYRUN_READS = 256
DRYRUN_CHUNK = 128


def _load_index():
    from .index.cf_io import load_cf_index
    return load_cf_index(os.path.join(FIXDIR, "synth"))


def entry(device="cuda"):
    """(fn, args): fn(*args) is one K1 call over the entry's lanes (module
    docstring)."""
    from .classify.engine import BatchSearchEngine, search_lanes
    from .io.fastx import read_batch
    from .ops.fm_torch import DeviceFMIndex, resolve_device

    dev = resolve_device(device)
    fm = DeviceFMIndex.build(_load_index(), device=dev)
    seqs = []
    for r in read_batch([READS], limit=ENTRY_READS):
        seqs += [r.seq, r.revcomp()]
    eng = BatchSearchEngine(fm, MIN_HITLEN)
    rseq, lengths = eng.pack(seqs, max(len(s) for s in seqs), len(seqs))

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def forward(blocks, fchr, ftab_rows, zoff, reads, lengths, start):
        tables = dataclasses.replace(fm, blocks=blocks, fchr=fchr,
                                     ftab_rows=ftab_rows, zoff=zoff)
        return search_lanes(tables, reads, lengths, start, MAX_HITS,
                            MIN_HITLEN, INCREMENT, False, False)

    args = (fm.blocks, fm.fchr, fm.ftab_rows, int(fm.zoff),
            put(eng.transport(rseq)), put(lengths),
            put(np.zeros(len(seqs), np.int32)))
    return forward, args


def _first_diff(got, want) -> str:
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return (f"row {i}: {got[i] if i < len(got) else None!r} vs golden "
            f"{want[i] if i < len(want) else None!r}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The synth reads through the mesh pipeline on n devices, held to
    the golden rows (module docstring)."""
    from .classify.gpu_pipeline import GPUClassificationPipeline
    from .io.fastx import read_batch
    from .parallel.sharded import make_mesh

    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    n_fm = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices // n_fm, n_fm, devices)
    # the wide layout always: the fm axis exists for the >= 2^31-base
    # regime, and torch has int64 rows without a switch
    pipe = GPUClassificationPipeline(_load_index(), mesh=mesh, wide=True,
                                     device=mesh.devices[0][0].type)
    reads = read_batch([READS], limit=DRYRUN_READS)
    rows = []
    for chunk in pipe.classify_stream_unpaired(
            reads[i: i + DRYRUN_CHUNK]
            for i in range(0, len(reads), DRYRUN_CHUNK)):
        rows += chunk
    with open(GOLDEN) as f:
        golden = f.read().splitlines()[1:]
    ids = {r.split("\t", 1)[0] for r in rows}
    want = [r for r in golden if r.split("\t", 1)[0] in ids]
    # explicit raises: python -O must not strip the check
    if not want:
        raise AssertionError("no golden row for the dry run's reads")
    if len(ids) < DRYRUN_READS:
        raise AssertionError(f"rows for {len(ids)} of {DRYRUN_READS} reads")
    if rows != want:
        raise AssertionError("the mesh rows differ from the golden rows at "
                             + _first_diff(rows, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m centrifuge_tpu_torch.graft_entry",
        description="one K1 launch, then the mesh dry run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    a = ap.parse_args(argv)
    fn, args = entry(device=a.device)
    fn(*args)
    cpu = torch.device(a.device).type == "cpu"
    if not cpu:
        torch.cuda.synchronize()
    print("entry ok", flush=True)
    if cpu:
        dryrun_multichip(8, devices=["cpu"] * 8)
    else:
        dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
