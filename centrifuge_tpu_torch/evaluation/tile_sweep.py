"""Time K1 (csrc/search.cu), K3 (csrc/resolve.cu), K4 (csrc/ftab12.cu)
and K0's two entries (csrc/rank.cu) at each tile size.

    python3 -m centrifuge_tpu_torch.evaluation.tile_sweep [--parent DIR]

Needs one CUDA card and nvcc. Builds the sources once for each tile size
G (K1, K3, K4: 4 and 8; K0: 1, 2, 4 and 8, both of its entries at G: a
copy of each source with its kTile constants set to G) into
csrc/_build/sweep/, all nvcc processes started together, then, on the
256 Mbp bigdb database (evaluation/bigdb.py: built into
.chip_smoke_cache/ when absent, as chip_smoke.py builds it), times by
CUDA events:
  - K1 on the first 32,768-read batch (65,536 lanes, 16 hit slots), K3
    on that batch's presolve rows and K4's launch (level 2 of the
    depth-12 ftab, from the index's level-1 ranges), the sizes in turns
    (4, 8, 8, 4); then, at each size, K1 and K3 on the first quarter
    and sixteenth of those lanes and rows: a time that falls with the
    work says the kernel is held by its throughput, one that stays says
    by its longest chains (K4's work is fixed: the 2^22 level-1 ranges);
  - K0's level-1 entry on the index's 2^20 depth-10 ranges, its generic
    kernel on the same 8,388,608 (row, char) pairs and on 65,536 random
    ones (there also the kernel alone, a CUDA graph of launches through
    its C entry, as the wrapper's host work paces back-to-back calls of
    a kernel that short), and the whole depth-12 build (the level 1,
    then the committed K4's launch), in turns: the sizes (both entries
    at G), then the committed source (its own kTile and kTileL1), and
    back (1, 2, 4, 8, committed, committed, 8, 4, 2, 1).
With --parent DIR (a checkout of another commit of this repository, for
instance the parent one unpacked with `git archive`), its csrc/rank.cu
is built as it is and timed in the K0 turns too, beside the committed
source (..., committed, parent, parent, committed, ...), through the
same wrappers, whose C interface it shares; it has no level-1 entry, so
its level 1 is the query tensors that the port built before the level-1
entry (both ends of every range for each code) and one launch of its
generic kernel.
Every variant's outputs must equal the plain versions'. Prints one JSON
line per timed turn and per size's scaling, then a summary line and the
card's nvidia-smi line.
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
from ..ops import rank as rk
from . import bigdb

SWEEP = {"search": (4, 8), "resolve": (4, 8), "ftab12": (4, 8),
         "rank": (1, 2, 4, 8)}
TILES = SWEEP["search"]           # K1, K3 and K4 share their sizes
LANE_KERNELS = ("search", "resolve", "ftab12")
# as each source sets its tile sizes (csrc/rank.cu: kTile and kTileL1)
TILE_LINE = re.compile(r"(constexpr int kTile\w*) = \d+;")
BATCH_READS = 32768
RANDOM_QUERIES = 65536
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(REPO, ".chip_smoke_cache")


def _nvcc(cu: str, so: str, include: str):
    cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-I", include, "-o", so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _load(so: str, sigs: dict) -> C.CDLL:
    dll = C.CDLL(so)
    for fn, argtypes in sigs.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = C.c_int
    return dll


def build(parent: str = None) -> dict:
    """Every (kernel, tile) of SWEEP built with its kTile constants set to
    the tile, and, given a checkout `parent`, its rank.cu as it is under
    the key ("rank", "parent"): key -> loaded ctypes library, with the
    signatures _cuda sets (the parent's K0: its fm_rank_* entries).
    Prints the K0 builds' registers and spill."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, tiles in SWEEP.items():
        with open(os.path.join(_cuda.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for tile in tiles:
            text, n = TILE_LINE.subn(rf"\1 = {tile};", src)
            if n < 1:
                raise RuntimeError(f"{name}.cu: no kTile line to set")
            cu = os.path.join(out_dir, f"{name}.tile{tile}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs.append(((name, tile), cu[:-3] + ".so",
                          _cuda.SIGNATURES[name],
                          _nvcc(cu, cu[:-3] + ".so", _cuda.CSRC)))
    if parent is not None:
        csrc = os.path.join(os.path.abspath(parent), "centrifuge_tpu_torch",
                            "csrc")
        so = os.path.join(out_dir, "rank.parent.so")
        sigs = {fn: _cuda.SIGNATURES["rank"][fn]
                for fn in ("fm_rank_narrow", "fm_rank_wide")}
        procs.append((("rank", "parent"), so, sigs,
                      _nvcc(os.path.join(csrc, "rank.cu"), so, csrc)))
    libs = {}
    for key, so, sigs, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = _load(so, sigs)
        if key[0] == "rank":
            print(json.dumps(dict(kernel="rank", variant=key[1],
                                  ptxas=_cuda.ptxas_report(log))), flush=True)
    return libs


def use(libs: dict) -> None:
    """Make the wrappers launch these builds (kernel name -> library)."""
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


def parent_level1(fm, t0, b0):
    """The level 1 as the port built it before K0's level-1 entry: the
    8,388,608 (row, char) queries of both ends of every range for each
    code, one launch of the generic kernel, no empty-parent guard."""
    rows = torch.cat([t0.repeat(4), b0.repeat(4)])
    chars = torch.arange(4, dtype=torch.int32, device=t0.device
                         ).repeat_interleave(t0.numel()).repeat(2)
    out = rk.lf(fm.blocks, fm.fchr, fm.zoff, rows, chars)
    return out[: 4 * t0.numel()], out[4 * t0.numel():]


def sweep_lanes(libs, fm, args, flat, want, want_t, want12, ftab12_args,
                out12) -> dict:
    """K1, K3 and K4 at each tile size, in turns, then K1's and K3's
    scaling; returns tile -> kernel -> times."""
    nlanes = args[1].shape[0]
    times = {t: {k: [] for k in LANE_KERNELS} for t in TILES}
    for tile in TILES + TILES[::-1]:
        use({k: libs[k, tile] for k in LANE_KERNELS})
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
                   search=_cuda.persistent_config("search", fm.wide, nlanes),
                   resolve=_cuda.persistent_config("resolve", fm.wide,
                                                   flat.numel()),
                   ftab12_ms=time_cuda(lambda: fmt.ftab12_level2(
                       *ftab12_args), 5),
                   ftab12=_cuda.persistent_config("ftab12", fm.wide,
                                                  4 * fmt.N10))
        for k in LANE_KERNELS:
            times[tile][k].append(row[f"{k}_ms"])
        print(json.dumps(row), flush=True)
    for tile in TILES:
        use({k: libs[k, tile] for k in LANE_KERNELS})
        scaling = []
        for part in (1, 4, 16):
            L, n = nlanes // part, flat.numel() // part
            sub = (fm, args[1][:L], args[2][:L], args[3][:L]) + args[4:]
            rows = flat[:n]
            scaling.append(dict(
                lanes=L, rows=n,
                search_ms=time_cuda(lambda: eng_mod.search_lanes(*sub), 10),
                resolve_ms=time_cuda(lambda: fmt.resolve_rows(fm, rows),
                                     20)))
        print(json.dumps(dict(tile=tile, scaling=scaling)), flush=True)
    return times


def rank_kernel_ms(fm, rows, chars, out, reps: int) -> float:
    """ms per launch of the current K0 library's generic kernel alone, by
    CUDA events over a CUDA graph of `reps` launches through its C entry
    (as the wrapper calls it, without the wrapper's checks and
    allocation), so that the host's work per launch does not pace
    launches this short; writes rank_c(row) into out."""
    lib = _cuda.lib("rank")
    fn = lib.fm_rank_wide if fm.wide else lib.fm_rank_narrow

    def launch():   # on the current stream: the graph's while capturing
        _cuda.check(fn(fm.blocks.data_ptr(), None, int(fm.zoff),
                       rows.data_ptr(), chars.data_ptr(), out.data_ptr(),
                       rows.numel(), _cuda.stream_ptr(rows.device)),
                    "rank kernel")

    side = torch.cuda.Stream(rows.device)
    side.wait_stream(torch.cuda.current_stream(rows.device))
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream(rows.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    return time_cuda(graph.replay, 3) / reps


def sweep_rank(libs, fm, idx, want12, out12) -> dict:
    """K0's level-1 entry, its generic kernel on the level-1 pairs and on
    65,536 random pairs, and the whole depth-12 build, for each variant
    (each tile size, the committed source, the parent's K0 when built)
    in turns; returns variant -> measure -> times."""
    t0, b0 = fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10]
    l1_args = (fm.blocks, fm.fchr, fm.zoff, t0, b0)
    want_l1 = torch.cat(rk.level1_plain(*l1_args))
    live8 = (b0 > t0).repeat(8)
    rows1 = torch.cat([t0.repeat(4), b0.repeat(4)])
    chars1 = torch.arange(4, dtype=torch.int32, device=t0.device
                          ).repeat_interleave(fmt.N10).repeat(2)
    lf_args = (fm.blocks, fm.fchr, fm.zoff, rows1, chars1)
    want8 = (fm.fchr.to(torch.int64)[chars1.to(torch.int64)]
             + rk.rank_plain(fm.blocks, fm.zoff, rows1, chars1)
             ).to(rows1.dtype)
    g = np.random.default_rng(11)
    rows_q = torch.from_numpy(g.integers(0, idx.bwt_len + 1, RANDOM_QUERIES)
                              .astype(np.int64 if fm.wide else np.int32)
                              ).to(t0.device)
    chars_q = torch.from_numpy(g.integers(0, 4, RANDOM_QUERIES).astype(
        np.int32)).to(t0.device)
    q_args = (fm.blocks, fm.zoff, rows_q, chars_q)
    want_q = rk.rank_plain(*q_args).to(rows_q.dtype)
    variants = list(SWEEP["rank"]) + ["committed"]
    if ("rank", "parent") in libs:
        variants.append("parent")
    out_q = torch.empty_like(rows_q)
    times = {v: {} for v in variants}
    for v in variants + variants[::-1]:
        use({"rank": libs["rank", v]})
        level1 = (lambda: parent_level1(fm, t0, b0)) if v == "parent" \
            else (lambda: rk.level1(*l1_args))

        def build_ftab12():   # K4 writes every entry: no zeroing
            return fmt.ftab12_level2(fm.blocks, fm.fchr, fm.zoff, t0, b0,
                                     *level1(), out12)

        l1 = torch.cat(level1())
        if not torch.equal(torch.where(live8, l1, 0), want_l1) or (
                v != "parent" and not torch.equal(l1, want_l1)):
            raise SystemExit(f"rank {v}: level 1 differs from plain")
        if not torch.equal(rk.lf(*lf_args), want8):
            raise SystemExit(f"rank {v}: LF of the level-1 pairs differs")
        if not torch.equal(rk.rank(*q_args), want_q):
            raise SystemExit(f"rank {v}: the random ranks differ")
        out12.zero_()
        if not torch.equal(build_ftab12(), want12):
            raise SystemExit(f"rank {v}: the depth-12 build differs")
        row = dict(kernel="rank", variant=v,
                   level1_ms=time_cuda(level1, 10),
                   lf_8388608_ms=time_cuda(lambda: rk.lf(*lf_args), 5),
                   rank_65536_ms=rank_kernel_ms(fm, rows_q, chars_q, out_q,
                                                50),
                   rank_65536_wrapper_ms=time_cuda(lambda: rk.rank(*q_args),
                                                   50),
                   build_ms=time_cuda(build_ftab12, 5))
        if not torch.equal(out_q, want_q):
            raise SystemExit(f"rank {v}: the timed kernel differs")
        if v != "parent":
            row.update(
                level1=_cuda.persistent_config("rank", fm.wide, fmt.N10,
                                               "lf_level1"),
                rank_8388608=_cuda.persistent_config("rank", fm.wide,
                                                     rows1.numel()),
                rank_65536=_cuda.persistent_config("rank", fm.wide,
                                                   RANDOM_QUERIES))
        for k, val in row.items():
            if k.endswith("_ms"):
                times[v].setdefault(k, []).append(val)
        print(json.dumps(row), flush=True)
    return times


def main(argv) -> int:
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print("usage: python3 -m centrifuge_tpu_torch.evaluation.tile_sweep"
              " [--parent DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = build(parent)
    # the sources as they are, restored after the lane sweep
    committed = {k: _cuda.lib(k) for k in LANE_KERNELS + ("rank",)}
    libs["rank", "committed"] = committed["rank"]
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
    times = sweep_lanes(libs, fm, args, flat, want, want_t, want12,
                        ftab12_args, out12)
    use(committed)
    rank_times = sweep_rank(libs, fm, idx, want12, out12)
    print(json.dumps(dict(
        lanes=len(seqs), presolve_rows=int(flat.numel()), card=smi,
        mean_ms={t: {k: float(np.mean(v)) for k, v in times[t].items()}
                 for t in TILES},
        rank_mean_ms={v: {k: float(np.mean(x)) for k, x in m.items()}
                      for v, m in rank_times.items()})), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
