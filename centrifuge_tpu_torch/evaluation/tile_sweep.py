"""Time K1 (csrc/search.cu), K3 (csrc/resolve.cu) and K4
(csrc/ftab12.cu) at each tile size.

    python3 -m centrifuge_tpu_torch.evaluation.tile_sweep

Needs one CUDA card and nvcc. Builds the three sources once for each
tile size G (4 and 8: a copy of each with its kTile constant set to G)
into csrc/_build/sweep/, then, on the
256 Mbp bigdb database (evaluation/bigdb.py: built into
.chip_smoke_cache/ when absent, as chip_smoke.py builds it), times K1 on
the first 32,768-read batch (65,536 lanes, 16 hit slots), K3 on that
batch's presolve rows and K4's launch (level 2 of the depth-12 ftab,
from the index's level-1 ranges), by CUDA events, the sizes in turns
(4, 8, 8, 4). Every size's outputs must equal the plain versions'. Then,
at each size, K1 and K3 on the first quarter and sixteenth of those
lanes and rows: a time that falls with the work says the kernel is held
by its throughput, one that stays says by its longest chains (K4's work
is fixed: the 2^22 level-1 ranges). Prints one JSON line per timed turn
and per size's scaling, then a summary line and the card's nvidia-smi
line.
"""

from __future__ import annotations

import ctypes as C
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import _cuda
from ..classify import engine as eng_mod
from ..classify.algo import ClassifierConfig
from ..index.cf_io import load_cf_index
from ..io.fastx import read_batch
from ..ops import fm_torch as fmt
from . import bigdb

TILES = (4, 8)
KERNELS = ("search", "resolve", "ftab12")
TILE_LINE = re.compile(r"constexpr int kTile = \d+;")   # as each source sets it
BATCH_READS = 32768
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(REPO, ".chip_smoke_cache")


def build(tile: int) -> dict:
    """The search, resolve and ftab12 libraries built with kTile = tile,
    loaded: name -> ctypes library, with the signatures _cuda sets."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in KERNELS:
        with open(os.path.join(_cuda.CSRC, f"{name}.cu")) as f:
            src, n = TILE_LINE.subn(f"constexpr int kTile = {tile};",
                                    f.read())
        if n != 1:
            raise RuntimeError(f"{name}.cu: no kTile line to set")
        cu = os.path.join(out_dir, f"{name}.tile{tile}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = cu[:-3] + ".so"
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", _cuda.CSRC, "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, so, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}.cu (tile {tile}):\n"
                               f"{log}")
        dll = C.CDLL(so)
        for fn, argtypes in _cuda.SIGNATURES[name].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = C.c_int
        libs[name] = dll
    return libs


def use(libs: dict) -> None:
    """Make the wrappers launch these builds."""
    with _cuda._LOCK:
        _cuda._LIBS.update(libs)


def time_cuda(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def main(argv) -> int:
    if argv:
        print("usage: python3 -m centrifuge_tpu_torch.evaluation.tile_sweep",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    builds = {t: build(t) for t in TILES}
    idx = load_cf_index(bigdb.ensure_bigdb(CACHE))
    recs = read_batch([os.path.join(CACHE, "reads_100k.fq")])[:BATCH_READS]
    fm = fmt.DeviceFMIndex.build(idx, device=dev)
    eng = eng_mod.BatchSearchEngine(fm)
    seqs = []
    for r in recs:
        seqs += [r.seq, r.revcomp()]
    lmax = eng_mod._bucket_len(max(len(s) for s in seqs))
    rseqp, lengths = eng.pack_transport(seqs, lmax, len(seqs))
    args = (fm, torch.from_numpy(rseqp).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.zeros(len(seqs), dtype=torch.int32, device=dev), 16,
            eng.min_hitlen, eng.increment, False, eng._deep(lmax))
    want = eng_mod.search_plain(*args)
    cls = ClassifierConfig()
    flat = eng_mod.presolve_rows_plain(
        want[0], want[1], want[3], cls.khits, cls.ihits(idx.compressed),
        eng.min_hitlen, eng_mod.presolve_rk(cls.khits))
    want_t = fmt.resolve_rows_plain(fm, flat)
    t0, b0 = fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10]
    want12 = torch.zeros_like(fm.ftab12_rows)
    fmt.ftab12_plain(fm.blocks, fm.fchr, fm.zoff, t0, b0, want12)
    t1, b1 = fmt.ftab12_level1(fm.blocks, fm.fchr, fm.zoff, t0, b0)
    out12 = torch.zeros_like(want12)
    ftab12_args = (fm.blocks, fm.fchr, fm.zoff, t0, b0, t1, b1, out12)
    times = {t: {k: [] for k in KERNELS} for t in TILES}
    for tile in TILES + TILES[::-1]:
        use(builds[tile])
        got = eng_mod.search_lanes(*args)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"tile {tile}: search differs from plain")
        if not torch.equal(fmt.resolve_rows(fm, flat), want_t):
            raise SystemExit(f"tile {tile}: resolve differs from plain")
        out12.zero_()
        if not torch.equal(fmt.ftab12_level2(*ftab12_args), want12):
            raise SystemExit(f"tile {tile}: ftab12 differs from plain")
        row = dict(tile=tile,
                   search_ms=time_cuda(lambda: eng_mod.search_lanes(*args),
                                       10),
                   resolve_ms=time_cuda(lambda: fmt.resolve_rows(fm, flat),
                                        20),
                   search=_cuda.persistent_config("search", fm.wide,
                                                  len(seqs)),
                   resolve=_cuda.persistent_config("resolve", fm.wide,
                                                   flat.numel()),
                   ftab12_ms=time_cuda(lambda: fmt.ftab12_level2(
                       *ftab12_args), 5),
                   ftab12=_cuda.persistent_config("ftab12", fm.wide,
                                                  4 * fmt.N10))
        for k in KERNELS:
            times[tile][k].append(row[f"{k}_ms"])
        print(json.dumps(row), flush=True)
    for tile in TILES:
        use(builds[tile])
        scaling = []
        for part in (1, 4, 16):
            L, n = len(seqs) // part, flat.numel() // part
            sub = (fm, args[1][:L], args[2][:L], args[3][:L]) + args[4:]
            rows = flat[:n]
            scaling.append(dict(
                lanes=L, rows=n,
                search_ms=time_cuda(lambda: eng_mod.search_lanes(*sub), 10),
                resolve_ms=time_cuda(lambda: fmt.resolve_rows(fm, rows),
                                     20)))
        print(json.dumps(dict(tile=tile, scaling=scaling)), flush=True)
    print(json.dumps(dict(
        lanes=len(seqs), presolve_rows=int(flat.numel()), card=smi,
        mean_ms={t: {k: float(np.mean(v)) for k, v in times[t].items()}
                 for t in TILES})), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
