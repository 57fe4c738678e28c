#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (centrifuge_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, sm_90a), nvcc, and this
repository around the script. It builds the port's kernels from
centrifuge_tpu_torch/csrc, then runs these phases, each printing one
JSON line; any failure exits non-zero:

  env       card name, count, power limit
  kernels   each kernel against its plain PyTorch version on the synth
            index (tests/fixtures/synth), exact integer equality, narrow
            and wide: rank (K0) on 65,536 random (row, char) pairs and
            K0's level-1 entry on the 2^20 depth-10 ranges,
            depth-12 ftab (K4), greedy search (K1) on every lane of the
            synth reads, deep or not, min_hitlen 16 and 22; the SA
            resolve walk (K3) on 65,536 random rows and the edge rows, at
            the full step budget and at max_steps=1; the presolve (K5,
            then K3) on the synth lane sets, khits 5 and 16; K6's sharded
            search (synth lane sets, min_hitlen 16 and 22, first hits) and
            sharded walk (edge rows and 65,536 random rows, max_steps
            4096 and 1) on (2, 2) and (1, 4) meshes of cuda:0, narrow and
            wide, and across cards when there are several, also against
            K1 and K3 on the same lanes and rows, one launch per dp row;
            K1's, K3's and K4's launch shape: a tile of more than one
            thread a lane, row or level-1 range, a persistent grid
            capped at what the items fill (one block for the 2-lane
            first-hit search); K0's two entries' the same, a warp a
            chunk of 32 items
  synth     the classify CLI on the card (host resolve), then
            GPUClassificationPipeline with host_resolve=False (device
            resolve): unpaired output and report and paired output
            byte-equal to the reference goldens; once more with the
            presolve off, so the tail thread resolves every row on the
            card
  synth_sharded  GPUClassificationPipeline over meshes that repeat
            cuda:0 ((2, 2) narrow unpaired + report, (1, 4) wide paired),
            host and device resolve: byte-equal to the goldens, K6
            launched and no single-device kernel
  multihost two processes on cuda:0 joined by gloo
            (parallel/multihost.py, a (1, 2) wide mesh each) classify
            the two halves of the synth reads: merged rows equal the
            golden rows
  full      the 256 Mbp production-regime database generated from its
            seed (evaluation/bigdb.py: 64 x 4 Mbp genomes, 100k 100 bp
            reads), built into .chip_smoke_cache/, streamed through
            GPUClassificationPipeline in 32,768-read batches four times
            on one index, in turns: host resolve (the default; the
            counted main path, index build included), device resolve
            (counted), device, host; every stream's rows byte-equal to
            the first's. Launch counts of each path, the first 300 reads
            against the host oracle (ClassificationPipeline + FMOracle),
            reads/s, kernel times at this size by CUDA events beside
            their plain versions and bounds (K0's level-1 entry on the
            2^20 depth-10 ranges, and its generic kernel on the same
            8,388,608 (row, char) pairs and on 65,536 random ones, there
            the kernel alone (a CUDA graph of launches through its C
            entry) and the wrapper; K4's
            own launch and, apart, the whole depth-12 build, each with
            its own bound; K1 and K5 on the first batch, K5's
            kernel alone and its wrapper beside it; K3 on that batch's
            presolve rows; K0's, K1's, K3's and K4's tile, grid and
            registers,
            and the plain versions' lockstep steps and longest walk: the
            longest chains of dependent reads), peak device memory
  full_sharded  the same reads through a (1, 4) mesh of cuda:0 (K6),
            host and device resolve, each stream byte-equal to the
            single-device host-resolve stream; K6's search on the first
            batch and its walk on that batch's presolve rows, timed
            beside their plain versions and bounds

Then one JSON line of per-kernel numbers, the card's nvidia-smi line,
and last {"ok": true, "device": {...}}. It takes no arguments.

Each kernel's bound is the larger of two times, from the lookups that
its plain version records on the same inputs: the bytes it must move
(each input and output once; of the index tables, each 32-byte sector
its lookups touch, once) over the HBM rate, and its rank arithmetic
over the card's integer and popcount issue rates.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "tests", "fixtures", "synth")
CACHE = os.path.join(REPO, ".chip_smoke_cache")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# Integer issue rates of the H100 SXM, from the data sheet's 67 TFLOP/s
# fp32 (132 SMs x 128 lanes x 2 flops per FMA x 1.98 GHz): 64 INT32
# lanes per SM (16.75 TOP/s) and 16 population counts per SM per clock
# (4.19 TOP/s).
INT32_OPS_PER_S = 67e12 / 4
POPC_OPS_PER_S = 67e12 / 16
SECTOR = 32                    # bytes: the unit the L2 moves to/from HBM
# Integer operations of one lookup, counted from csrc/fm_common.cuh:
# rank() takes 10 for the row address, the char pattern, the occ add and
# the '$' correction, 4 per full word (XOR-NOT, shift, AND-mask, add) and
# 7 for a partial word (3 more for its mask), plus one popcount per word;
# bwt_at() takes 5. The search's read decoding is not counted, so its
# bound is, if anything, too low.
RANK_OPS, WORD_OPS, PARTIAL_OPS, BWT_OPS = 10, 4, 7, 5
# The all-code scan of a range end by K0's level 1 and K4 (fm_common.cuh
# scan_ends, PairAllPart, planes_before): per 32 bases before the end,
# 12 operations (the mask, the two bit planes, their AND, the field
# shifts and adds) and 3 population counts; per end, 38 more (its row
# address and occ, and LF of each of the 4 codes from the planes, the
# '$' correction). Their operations bound is that of the cheaper scheme
# on the same ends: this one, or one rank per (end, code) as counted
# above.
ALL_HALF_OPS, ALL_HALF_POPC, ALL_END_OPS = 12, 3, 38
# The presolve (K5), per hit entry: its size, the scoring and gate
# tests and its sort key (about 20 operations); per mate, the compares
# of a sort of its 2 mh keys (2 mh log2(2 mh)); per flat slot, its
# index and the copy. K3's exit tests (the sample and boundary checks)
# are not counted, so its bound is, if anything, too low.
PICK_OPS = 20
SEARCH_MH = 16                 # hit slots per lane in the K1 checks
BATCH_READS = 32768            # bench.py's batch: 65,536 lanes
BIGDB_GENOMES = 64             # evaluation/bigdb.py N_GENOMES (256 Mbp)
ORACLE_READS = 300

KERNELS = {
    "rank": dict(source="centrifuge_tpu_torch/csrc/rank.cu",
                 replaces="centrifuge_tpu/ops/pallas_rank.py:91"),
    "search": dict(source="centrifuge_tpu_torch/csrc/search.cu",
                   replaces="centrifuge_tpu/classify/engine.py:181"),
    "ftab12": dict(source="centrifuge_tpu_torch/csrc/ftab12.cu",
                   replaces="centrifuge_tpu/ops/fm_jax.py:456"),
    "resolve": dict(source="centrifuge_tpu_torch/csrc/resolve.cu",
                    replaces="centrifuge_tpu/ops/fm_jax.py:611"),
    "presolve": dict(source="centrifuge_tpu_torch/csrc/presolve.cu",
                     replaces="centrifuge_tpu/classify/engine.py:868"),
    "sharded_search": dict(source="centrifuge_tpu_torch/csrc/sharded.cu",
                           replaces="centrifuge_tpu/parallel/sharded.py:358"),
    "sharded_resolve": dict(source="centrifuge_tpu_torch/csrc/sharded.cu",
                            replaces="centrifuge_tpu/parallel/sharded.py:405"),
}
# the kernels each path launches, counted from 0 just before it
HOST_RESOLVE_PATH = ("rank", "ftab12", "search")
DEVICE_RESOLVE_PATH = ("search", "presolve", "resolve")
MESH_HOST_PATH = ("sharded_search",)
MESH_DEVICE_PATH = ("sharded_search", "sharded_resolve")
SINGLE_DEVICE = ("rank", "ftab12", "search", "presolve", "resolve")
MESH_FM = 4                    # full_sharded's (1, 4) mesh
NO_LIBRARY = ("no single PyTorch call computes a batched BWT rank, a "
              "greedy FM search, an FM-index ftab extension, an LF walk "
              "to an SA sample, the presolve's pick or their sharded "
              "forms")


# one process of chip_smoke's multihost phase: argv = repo, process id,
# process count, port, output file, device; prints its launch counts last
MULTIHOST_WORKER = r"""
import json, os, sys
repo, pid, nproc, port, out, dev = sys.argv[1:7]
sys.path.insert(0, repo)
from centrifuge_tpu_torch import _cuda
from centrifuge_tpu_torch.index.cf_io import load_cf_index
from centrifuge_tpu_torch.io.fastx import read_batch
from centrifuge_tpu_torch.parallel import multihost
multihost.initialize(f"localhost:{port}", int(nproc), int(pid))
fix = os.path.join(repo, "tests", "fixtures", "synth")
idx = load_cf_index(os.path.join(fix, "synth"))
pipe = multihost.make_multihost_pipeline(idx, n_fm=2, wide=True,
                                         devices=[dev, dev])
mine = multihost.shard_reads(read_batch([os.path.join(fix, "reads.fq")]),
                             int(pid), int(nproc))
_cuda.reset_launches()
rows = []
for chunk in pipe.classify_stream_unpaired(
        mine[i: i + 512] for i in range(0, len(mine), 512)):
    rows += chunk
with open(out, "w") as f:
    f.write("\n".join(rows) + "\n")
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps(_cuda.LAUNCHES))
"""


def load_port():
    """Import what the run needs: the port, torch and numpy only."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify import engine
    from centrifuge_tpu_torch.classify.algo import ClassifierConfig
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import (
        ClassificationPipeline, PipelineConfig)
    from centrifuge_tpu_torch.cli import classify as cli
    from centrifuge_tpu_torch.evaluation import bigdb, tile_sweep
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    from centrifuge_tpu_torch.io.fastx import read_batch, read_fastx
    from centrifuge_tpu_torch.ops import fm_torch, rank
    from centrifuge_tpu_torch.ops.fm_numpy import FMOracle
    from centrifuge_tpu_torch.parallel import sharded
    from centrifuge_tpu_torch.report.writers import write_report
    from centrifuge_tpu_torch.utils.fallback import fallbacks
    return dict(np=np, torch=torch, cuda=_cuda, engine=engine,
                sharded=sharded,
                Pipe=GPUClassificationPipeline,
                OraclePipe=ClassificationPipeline, Cfg=PipelineConfig,
                cli=cli, bigdb=bigdb, tile_sweep=tile_sweep,
                load_cf_index=load_cf_index,
                read_batch=read_batch, read_fastx=read_fastx,
                ClsCfg=ClassifierConfig,
                write_report=write_report,
                fm_torch=fm_torch, rank=rank, FMOracle=FMOracle,
                fallbacks=fallbacks)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


class Smoke:
    def __init__(self, m):
        self.m = m
        self.torch = m["torch"]
        self.np = m["np"]
        self.dev = self.torch.device("cuda", 0)
        self.rows = {k: dict(name=k, route="cuda", **v)
                     for k, v in KERNELS.items()}

    # ---- helpers ----

    def time_cuda(self, fn, reps: int) -> float:
        """ms per call of fn by CUDA events, after one warm-up call."""
        torch = self.torch
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

    def time_host(self, fn):
        """(result, ms) of one call ending in a device synchronize."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def equal(self, what: str, got, want) -> int:
        """Exact equality of integer tensors; returns max |diff| (0)."""
        torch = self.torch
        if len(got) != len(want):
            fail(f"{what}: {len(got)} vs {len(want)} outputs")
        err = 0
        for k, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{what}[{k}]: {g.shape}/{g.dtype} vs "
                     f"{w.shape}/{w.dtype}")
            d = (g.to(torch.int64) - w.to(torch.int64)).abs()
            err = max(err, int(d.max().item()) if d.numel() else 0)
        if err:
            fail(f"{what}: kernel differs from its plain version by {err}")
        return err

    def traffic(self, fm, stats: dict):
        """(bytes, integer ops, popcounts) that the lookups recorded by a
        plain run need: each 32-byte sector of blocks, ftab, ftab12 and
        the SA samples that they touch counted once, however often it is
        read. fm is a DeviceFMIndex, or sharded_tables() of a mesh index,
        whose ftab holds (top, bot) pairs (`ftab_tb`)."""
        torch = self.torch
        i64 = torch.int64
        width = fm.blocks.shape[1] * 4
        word0 = (8 if fm.wide else 4) * 4
        pairs = getattr(fm, "ftab_tb", None)
        tables = dict(blocks=fm.blocks, ftab=fm.ftab_rows if pairs is None
                      else pairs, ftab12=fm.ftab12_rows, offs=fm.offs)
        seen = {k: torch.zeros(t.numel() * 4 // SECTOR + 1,
                               dtype=torch.bool, device=t.device)
                for k, t in tables.items() if t is not None}
        blk = seen["blocks"]
        int_ops = popc = 0
        for r, c in zip(stats.get("rank_rows", []),
                        stats.get("rank_chars", [])):
            r, c = r.to(i64), c.to(i64)
            base = (r >> 9) * width
            full = (r & 511) >> 4
            part = ((r & 15) != 0).to(i64)
            nw = full + part
            blk[(base + 4 * c) // SECTOR] = True      # occ (low word)
            if fm.wide:
                blk[(base + 16 + 4 * c) // SECTOR] = True
            first = (base + word0) // SECTOR
            last = (base + word0 + 4 * nw - 1) // SECTOR
            for k in range(5):                         # 128 B span <= 5
                sec = first + k
                blk[sec[(nw > 0) & (sec <= last)]] = True
            int_ops += (RANK_OPS * r.numel() + WORD_OPS * int(full.sum())
                        + PARTIAL_OPS * int(part.sum()))
            popc += int(nw.sum())
        for r in stats.get("bwt_rows", []):
            r = r.to(i64)
            blk[((r >> 9) * width + word0 + 4 * ((r & 511) >> 4))
                // SECTOR] = True
            int_ops += BWT_OPS * r.numel()
        shift, entry = (3, 16) if fm.wide else (4, 8)
        for key in ("ftab", "ftab12"):
            for fi in stats.get(key, []):
                fi = fi.to(i64)
                if key == "ftab" and pairs is not None:
                    seen[key][fi * entry // SECTOR] = True
                    continue
                seen[key][((fi >> shift) * width
                           + (fi & ((1 << shift) - 1)) * entry)
                          // SECTOR] = True
        for si in stats.get("offs", []):
            seen["offs"][si.to(i64) * 4 // SECTOR] = True
        nbytes = SECTOR * sum(int(v.sum()) for v in seen.values())
        return nbytes, int_ops, popc

    def sharded_tables(self, index):
        """The shapes traffic() needs of a mesh index's tables, as the
        fm-padded global tables that the shards slice: the bytes a shard
        reads lie at the same offsets there."""
        torch = self.torch
        e = dict(device=index.device)
        width = 40 if index.wide else 36
        return types.SimpleNamespace(
            blocks=torch.empty((index.nblk_per * index.n_fm, width),
                               dtype=torch.int32, **e),
            ftab_tb=torch.empty((index.nftab_per * index.n_fm, 2),
                                dtype=index.row_dtype, **e),
            ftab_rows=None, ftab12_rows=None,
            offs=torch.empty(index.noffs_per * index.n_fm,
                             dtype=torch.int32, **e), wide=index.wide)

    @staticmethod
    def bound(nbytes: int, int_ops: int, popc: int) -> dict:
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = max(int_ops / INT32_OPS_PER_S, popc / POPC_OPS_PER_S) * 1e3
        return dict(bound_ms=max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    moved_bytes=nbytes, int_ops=int_ops, popc_ops=popc)

    def presolve_kernel_ms(self, pre, flat, reps: int) -> float:
        """ms per K5 launch by CUDA events: the kernel alone, called
        through its C entry as the wrapper calls it, each launch on a
        ticket buffer zeroed before the timing; the wrapper's launch
        count is not touched."""
        torch, cuda = self.torch, self.m["cuda"]
        h_top, h_bot, h_len, khits, ihits, mhl, rk = pre
        M = h_top.shape[0] // 2
        lib = cuda.lib("presolve")
        fn = lib.fm_presolve_wide if h_top.dtype == torch.int64 \
            else lib.fm_presolve_narrow
        per = self.m["engine"].PRESOLVE_MATES_PER_BLOCK
        states = torch.zeros((reps + 1, 1 + -(-M // per)),
                             dtype=torch.int64, device=self.dev)
        out = torch.empty_like(flat)
        stream = cuda.stream_ptr(self.dev)

        def launch(k):
            cuda.check(fn(h_top.data_ptr(), h_bot.data_ptr(),
                          h_len.data_ptr(), M, h_top.shape[1], khits, ihits,
                          mhl, rk, out.data_ptr(), out.numel(),
                          states[k].data_ptr(), stream), "presolve kernel")

        launch(reps)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for k in range(reps):
            launch(k)
        e.record()
        e.synchronize()
        self.equal("presolve (timed kernel)", [out], [flat])
        return s.elapsed_time(e) / reps

    def ends_scan(self, fm, ends):
        """(bytes, integer ops, popcounts) of scanning the block row of
        each range end once for every code (fm_common.cuh scan_ends):
        each 32-byte sector of the block table that the ends touch (occ
        and the words before each end, as a rank of each code reads
        them), once; operations the cheaper of one all-code scan per end
        and one rank per (end, code)."""
        torch = self.torch
        nbytes, rank_ops, rank_popc = self.traffic(fm, dict(
            rank_rows=[ends] * 4,
            rank_chars=[torch.full_like(ends, c) for c in range(4)]))
        halves = int(((ends & 511) + 31).div(32, rounding_mode="floor")
                     .sum())
        all_ops = ALL_END_OPS * ends.numel() + ALL_HALF_OPS * halves
        all_popc = ALL_HALF_POPC * halves

        def t_ops(ops, popc):
            return max(ops / INT32_OPS_PER_S, popc / POPC_OPS_PER_S)

        if t_ops(all_ops, all_popc) <= t_ops(rank_ops, rank_popc):
            return nbytes, all_ops, all_popc
        return nbytes, rank_ops, rank_popc

    def ftab12_bound(self, fm, t0, b0, t1, b1) -> dict:
        """K4's bound on this run's inputs: bytes = the depth-10 and
        level-1 pairs in, every depth-12 entry out, and the scans of the
        non-empty level-1 ranges' ends (ends_scan)."""
        torch = self.torch
        live = (b0 > t0).repeat(4) & (b1 > t1)
        ends = torch.cat([t1[live], b1[live]]).to(torch.int64)
        nbytes, ops, popc = self.ends_scan(fm, ends)
        io = (2 * t0.numel() + 2 * t1.numel() + 2 * self.m["fm_torch"].N12
              ) * fm.fchr.element_size()
        return dict(**self.bound(nbytes + io, ops, popc),
                    live_ranges=int(live.sum()), scanned_ends=ends.numel())

    def level1_bound(self, fm, t0, b0) -> dict:
        """K0's level-1 bound on this run's inputs: bytes = the depth-10
        pairs in, the level-1 pairs out (4 a range), and the scans of the
        non-empty depth-10 ranges' ends (ends_scan)."""
        torch = self.torch
        live = b0 > t0
        ends = torch.cat([t0[live], b0[live]]).to(torch.int64)
        nbytes, ops, popc = self.ends_scan(fm, ends)
        io = 10 * t0.numel() * fm.fchr.element_size()
        return dict(**self.bound(nbytes + io, ops, popc),
                    live_ranges=int(live.sum()), scanned_ends=ends.numel())

    def stream(self, idx, batches, host_resolve: bool, dfm=None):
        """A fresh pipeline (on dfm, else building the index) streaming
        the batches, launch counts from 0 before it is built: (pipe,
        rows, build seconds, stream seconds, launches)."""
        m, torch = self.m, self.torch
        m["cuda"].reset_launches()
        t0 = time.perf_counter()
        pipe = m["Pipe"](idx, m["Cfg"](host_resolve=host_resolve),
                         device=self.dev, dfm=dfm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = []
        for chunk in pipe.classify_stream_unpaired(batches):
            rows += chunk
        t2 = time.perf_counter()
        return pipe, rows, t1 - t0, t2 - t1, dict(m["cuda"].LAUNCHES)

    @staticmethod
    def same_rows(what: str, got, want) -> None:
        if got != want:
            bad = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            fail(f"{what} stream differs from the host-resolve stream at "
                 f"row {bad}")

    def check_path(self, path: str, launches: dict, kernels,
                   absent=()) -> None:
        """Fail unless each kernel of a path was launched in its run, and
        none of `absent` was; a mesh path (K6) launches no single-device
        kernel, a single-device path no K6."""
        mesh = any(k.startswith("sharded") for k in kernels)
        absent = tuple(absent) + (SINGLE_DEVICE if mesh else
                                  MESH_DEVICE_PATH)
        for k in kernels:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the {path} path")
        for k in absent:
            if launches[k]:
                fail(f"kernel {k} was launched on the {path} path")
        if self.m["fallbacks"]():
            fail(f"native fallbacks: {self.m['fallbacks']()}")

    def golden_run(self, pipe, items, paired=False, size=1024) -> str:
        """The output file a pipeline writes for the synth items."""
        stream = pipe.classify_stream_paired if paired \
            else pipe.classify_stream_unpaired
        rows = [pipe.formatter.header()]
        for chunk in stream([items[i: i + size]
                             for i in range(0, len(items), size)]):
            rows += chunk
        return "\n".join(rows) + "\n"

    @staticmethod
    def same_golden(got: str, gold: str, what: str) -> None:
        with open(os.path.join(FIX, gold)) as f:
            if got != f.read():
                fail(f"{gold}: {what} differs")

    def mesh(self, n_dp: int, n_fm: int):
        """A (n_dp, n_fm) mesh with every entry cuda:0."""
        return self.m["sharded"].make_mesh(n_dp, n_fm,
                                           [self.dev] * (n_dp * n_fm))

    def lanes_of(self, recs):
        seqs = []
        for r in recs:
            seqs += [r.seq, r.revcomp()]
        return seqs

    def packed_lanes(self, eng, seqs, start=None):
        """Device tensors of the engine's lane matrix for seqs."""
        np, torch = self.np, self.torch
        lmax = self.m["engine"]._bucket_len(max(len(s) for s in seqs))
        rseqp, lengths = eng.pack_transport(seqs, lmax, len(seqs))
        st = np.zeros(len(seqs), np.int32) if start is None else start
        return (torch.from_numpy(rseqp).to(self.dev),
                torch.from_numpy(lengths).to(self.dev),
                torch.from_numpy(st).to(self.dev), lmax)

    # ---- phases ----

    def env(self) -> None:
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        self.smi = smi[0] if smi else ""
        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        cap = torch.cuda.get_device_capability(0)
        cuda = self.m["cuda"]
        t0 = time.perf_counter()
        cuda.build_all()
        build_s = time.perf_counter() - t0
        regs = {}
        for name in cuda.SIGNATURES:    # the compiler logs of the builds
            with open(os.path.join(cuda.BUILD_DIR, f"{name}.log")) as f:
                regs[name] = cuda.ptxas_report(f.read())
        self.ptxas = regs
        emit(dict(phase="env", device=self.name, count=self.count,
                  capability=list(cap), nvidia_smi=self.smi,
                  torch=torch.__version__, cuda=torch.version.cuda,
                  kernel_build_s=round(build_s, 3), ptxas=regs))

    def launch_shape(self, kernel: str, wide: bool, n: int,
                     entry: str = None) -> dict:
        """The launch of K1, K3 or K4 for n lanes, rows or level-1
        ranges, or of K0 (entry "lf_level1": its level 1) for n queries
        or depth-10 ranges: a persistent grid, the resident blocks capped
        at what n items fill. K1, K3 and K4 run an item on a tile of more
        than one thread; K0's warps take chunks of 32 items, a thread's
        share of a block an item."""
        cfg = self.m["cuda"].persistent_config(kernel, wide, n, entry)
        rank = kernel == "rank"
        need = -(-n * (1 if rank else cfg["tile"]) // cfg["threads"])
        if (cfg["tile"] < 2 and not rank) or cfg["grid"] != min(
                cfg["resident_blocks"], need):
            fail(f"{entry or kernel} launch shape for {n} items: {cfg}")
        return cfg

    def kernels(self) -> None:
        m, torch, np = self.m, self.torch, self.np
        fmt, rk, eng_mod = m["fm_torch"], m["rank"], m["engine"]
        idx = m["load_cf_index"](os.path.join(FIX, "synth"))
        fms = {}
        for wide in (False, True):
            fm = fmt.DeviceFMIndex.build(idx, device=self.dev, wide=wide,
                                         deep_ftab=True)
            fms[wide] = fm
            # K4 against the plain version, same inputs
            plain = torch.zeros_like(fm.ftab12_rows)
            fmt.ftab12_plain(fm.blocks, fm.fchr, fm.zoff,
                             fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10],
                             plain)
            self.equal(f"ftab12 wide={wide}", [fm.ftab12_rows], [plain])
            # K0 on 65,536 random (row, char) pairs, rank and LF
            g = np.random.default_rng(7)
            rows = torch.from_numpy(g.integers(
                0, idx.bwt_len + 1, 65536).astype(
                    np.int64 if wide else np.int32)).to(self.dev)
            chars = torch.from_numpy(g.integers(0, 4, 65536).astype(
                np.int32)).to(self.dev)
            got = rk.rank(fm.blocks, fm.zoff, rows, chars)
            want = rk.rank_plain(fm.blocks, fm.zoff, rows, chars).to(
                rows.dtype)
            self.equal(f"rank wide={wide}", [got], [want])
            got = rk.lf(fm.blocks, fm.fchr, fm.zoff, rows, chars)
            want = (fm.fchr.to(torch.int64)[chars.to(torch.int64)]
                    + rk.rank_plain(fm.blocks, fm.zoff, rows, chars)
                    ).to(rows.dtype)
            self.equal(f"lf wide={wide}", [got], [want])
            # K0's level 1 on the index's 2^20 depth-10 ranges
            t0, b0 = fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10]
            self.equal(f"level 1 wide={wide}",
                       list(rk.level1(fm.blocks, fm.fchr, fm.zoff, t0, b0)),
                       list(rk.level1_plain(fm.blocks, fm.fchr, fm.zoff, t0,
                                            b0)))
            # K3 on the edge rows (0, the '$' row, the last row, the
            # boundary rows) and 65,536 random rows, at the full step
            # budget and cut to 8 LF steps (max_steps=1)
            qrows = np.concatenate([
                [0, idx.zoff, idx.bwt_len - 1],
                idx.boundary_rows.astype(np.int64),
                g.integers(0, idx.bwt_len, 65536)])
            qrows = torch.from_numpy(qrows.astype(
                np.int64 if wide else np.int32)).to(self.dev)
            for steps in (fmt.RESOLVE_MAX_STEPS, 1):
                self.equal(f"resolve wide={wide} max_steps={steps}",
                           [fmt.resolve_rows(fm, qrows, steps)],
                           [fmt.resolve_rows_plain(fm, qrows, steps)])
        rb = m["read_batch"]
        sets = {
            "reads": self.lanes_of(rb([os.path.join(FIX, "reads.fq")])),
            "reads_n": self.lanes_of(rb([os.path.join(FIX, "reads_n.fq")])),
            "pairs": self.lanes_of(rb([os.path.join(FIX, "reads_1.fq")])
                                   + rb([os.path.join(FIX, "reads_2.fq")])),
        }
        n_checked = 0
        for wide in (False, True):
            fm = fms[wide]
            for deep in (False, True):
                for mhl in (16, 22):
                    eng = eng_mod.BatchSearchEngine(fm, mhl)
                    for name, seqs in sets.items():
                        reads, lens, st, lmax = self.packed_lanes(eng, seqs)
                        args = (fm, reads, lens, st, 16, mhl,
                                eng.increment, False, deep)
                        got = eng_mod.search_lanes(*args)
                        want = eng_mod.search_plain(*args)
                        self.equal(f"search {name} wide={wide} deep={deep} "
                                   f"mhl={mhl}", got, want)
                        n_checked += len(seqs)
            # first-hit-only mode (the extension searches) from offsets
            eng = eng_mod.BatchSearchEngine(fm, 22)
            seqs = sets["reads_n"]
            offs = np.random.default_rng(3).integers(
                0, 90, len(seqs)).astype(np.int32)
            reads, lens, st, lmax = self.packed_lanes(eng, seqs, offs)
            args = (fm, reads, lens, st, 1, 22, eng.increment, True, True)
            self.equal(f"first hits wide={wide}",
                       eng_mod.search_lanes(*args),
                       eng_mod.search_plain(*args))
            # K5 then K3 on each lane set's first-pass hit buffers
            for name, seqs in sets.items():
                reads, lens, st, lmax = self.packed_lanes(eng, seqs)
                hits = eng_mod.search_lanes(
                    fm, reads, lens, st, min(eng.FIRST_MAX_HITS, lmax), 22,
                    eng.increment, False, eng._deep(lmax))
                for khits in (5, 16):
                    args = (fm, hits[0], hits[1], hits[3], khits,
                            m["ClsCfg"](khits=khits).ihits(idx.compressed),
                            22, eng_mod.presolve_rk(khits))
                    self.equal(f"presolve {name} wide={wide} khits={khits}",
                               list(eng_mod.presolve_lanes(*args)),
                               list(eng_mod.presolve_plain(*args)))
        shapes = {}
        for wide in (False, True):
            if self.launch_shape("search", wide, 2)["grid"] != 1:
                fail("the 2-lane first-hit search launches more than one "
                     "block")
            shapes["wide" if wide else "narrow"] = dict(
                search=self.launch_shape("search", wide, 2 * BATCH_READS),
                resolve=self.launch_shape("resolve", wide, 4 * BATCH_READS),
                ftab12=self.launch_shape("ftab12", wide, 4 * fmt.N10),
                rank=self.launch_shape("rank", wide, 8 * fmt.N10),
                lf_level1=self.launch_shape("rank", wide, fmt.N10,
                                            "lf_level1"))
        emit(dict(phase="kernels", ftab12="equal (narrow, wide)",
                  rank="equal on 65536 pairs (narrow, wide)",
                  level1="equal on the 2^20 depth-10 ranges (narrow, wide)",
                  resolve="equal on 65536 rows + edges (narrow, wide; "
                          "max_steps 4096 and 1)",
                  presolve="equal on the synth lane sets (narrow, wide; "
                           "khits 5 and 16)",
                  search_lanes_checked=n_checked, launch_shapes=shapes))

    def kernels_sharded(self) -> None:
        """K6 against its plain versions, and against K1 (no depth-12
        prime) and K3 (full budget) on the same lanes and rows, on the
        synth index: the shards of (2, 2) and (1, 4) meshes that repeat
        cuda:0, narrow and wide; when the machine has several cards,
        meshes across them too. Each call launches each kernel once per
        dp row."""
        m, torch, np = self.m, self.torch, self.np
        shd, cuda, eng_mod, fmt = (m["sharded"], m["cuda"], m["engine"],
                                   m["fm_torch"])
        idx = m["load_cf_index"](os.path.join(FIX, "synth"))
        meshes = [("cuda:0 (2, 2)", self.mesh(2, 2)),
                  ("cuda:0 (1, 4)", self.mesh(1, 4))]
        cross = "not run: one card"
        if self.count > 1:
            cards = [torch.device("cuda", i) for i in range(self.count)]
            nf = min(4, self.count)
            meshes += [(f"{nf} cards (1, {nf})", shd.make_mesh(1, nf, cards)),
                       (f"{self.count} cards ({self.count}, 1)",
                        shd.make_mesh(self.count, 1, cards))]
            cross = [name for name, _ in meshes[2:]]
        rb = m["read_batch"]
        sets = {
            "reads": self.lanes_of(rb([os.path.join(FIX, "reads.fq")])),
            "reads_n": self.lanes_of(rb([os.path.join(FIX, "reads_n.fq")])),
            "pairs": self.lanes_of(rb([os.path.join(FIX, "reads_1.fq")])
                                   + rb([os.path.join(FIX, "reads_2.fq")])),
        }
        g = np.random.default_rng(7)
        rows_np = np.concatenate([
            [0, idx.zoff, idx.bwt_len - 1],
            idx.boundary_rows.astype(np.int64),
            g.integers(0, idx.bwt_len, 65536)])
        rows_np = rows_np[: rows_np.shape[0] // 12 * 12]   # any dp split
        checked = []
        for wide in (False, True):
            qrows = torch.from_numpy(rows_np.astype(
                np.int64 if wide else np.int32)).to(self.dev)
            fm = fmt.DeviceFMIndex.build(idx, device=self.dev, wide=wide,
                                         deep_ftab=False)
            k3 = fmt.resolve_rows(fm, qrows)
            for name, mesh in meshes:
                what = f"{name} wide={wide}"
                index = shd.MeshIndex(
                    shd.ShardedFMArrays.build(idx, mesh.n_fm, wide=wide),
                    mesh)
                eng = shd.ShardedSearchEngine(index)
                pad = [np.zeros(0, np.uint8)] * (-len(sets["reads"])
                                                 % mesh.n_dp)
                cuda.reset_launches()
                calls = 0
                for mhl in (16, 22):
                    inc = 10 if 2 * mhl <= 33 else 2 * mhl - 33
                    for sname, seqs in sets.items():
                        reads, lens, st, _ = self.packed_lanes(
                            eng, seqs + [np.zeros(0, np.uint8)]
                            * (-len(seqs) % mesh.n_dp))
                        args = (reads, lens, st, SEARCH_MH, mhl, inc, False)
                        got = shd.sharded_search(index, *args)
                        self.equal(f"sharded search {sname} {what} "
                                   f"mhl={mhl}", got,
                                   shd.sharded_search_plain(index, *args))
                        self.equal(f"sharded search vs K1 {sname} {what} "
                                   f"mhl={mhl}", got,
                                   eng_mod.search_lanes(fm, *args, False))
                        calls += 1
                seqs = sets["reads_n"] + pad
                offs = np.random.default_rng(3).integers(
                    0, 90, len(seqs)).astype(np.int32)
                reads, lens, st, _ = self.packed_lanes(eng, seqs, offs)
                args = (reads, lens, st, 1, 22, eng.increment, True)
                self.equal(f"sharded first hits {what}",
                           shd.sharded_search(index, *args),
                           shd.sharded_search_plain(index, *args))
                calls += 1
                for steps in (shd.SHARDED_RESOLVE_MAX_STEPS, 1):
                    got = shd.sharded_resolve(index, qrows, steps)
                    self.equal(f"sharded resolve {what} max_steps={steps}",
                               [got], [shd.sharded_resolve_plain(index, qrows,
                                                                 steps)])
                    if steps == shd.SHARDED_RESOLVE_MAX_STEPS:
                        self.equal(f"sharded resolve vs K3 {what}", [got],
                                   [k3])
                launches = (cuda.LAUNCHES["sharded_search"],
                            cuda.LAUNCHES["sharded_resolve"])
                if launches != (calls * mesh.n_dp, 2 * mesh.n_dp):
                    fail(f"K6 on {what}: {launches} launches for {calls} "
                         f"searches and 2 walks over {mesh.n_dp} dp rows")
                checked.append(what)
        emit(dict(phase="kernels_sharded", checked=checked,
                  search="equal on the synth lane sets (min_hitlen 16 and "
                         "22, first hits), and to K1",
                  resolve=f"equal on {rows_np.shape[0]} rows (max_steps "
                          "4096 and 1), and to K3 at 4096",
                  launches="one per dp row per call",
                  cross_card=cross))

    def synth(self) -> None:
        m = self.m
        base = os.path.join(FIX, "synth")
        with tempfile.TemporaryDirectory() as td:
            out, rep, outp = (os.path.join(td, f) for f in
                              ("out.tsv", "rep.tsv", "outp.tsv"))
            dev = ["--device", str(self.dev)]
            rc = m["cli"].run(["-x", base, "-U",
                               os.path.join(FIX, "reads.fq"), "-S", out,
                               "--report-file", rep] + dev)
            rc2 = m["cli"].run(["-x", base, "-1",
                                os.path.join(FIX, "reads_1.fq"), "-2",
                                os.path.join(FIX, "reads_2.fq"), "-S", outp,
                                "--report-file", ""] + dev)
            if rc or rc2:
                fail(f"classify CLI exit codes {rc}, {rc2}")
            checks = {}
            for got, gold in ((out, "golden_output.tsv"),
                              (rep, "golden_report.tsv"),
                              (outp, "golden_paired.tsv")):
                with open(got, "rb") as f1, \
                        open(os.path.join(FIX, gold), "rb") as f2:
                    same = f1.read() == f2.read()
                if not same:
                    fail(f"{gold}: the GPU path's output differs")
                checks[gold] = "byte-equal"
        emit(dict(phase="synth", **checks))
        self.synth_device_resolve()

    def synth_device_resolve(self) -> None:
        """The goldens through GPUClassificationPipeline with
        host_resolve=False (the CLI has no such flag, as the JAX CLI has
        none), then unpaired once more with the presolve off."""
        m = self.m
        cuda = m["cuda"]
        idx = m["load_cf_index"](os.path.join(FIX, "synth"))
        cfg = m["Cfg"](host_resolve=False)
        recs = m["read_batch"]([os.path.join(FIX, "reads.fq")])
        pairs = list(zip(m["read_fastx"](os.path.join(FIX, "reads_1.fq")),
                         m["read_fastx"](os.path.join(FIX, "reads_2.fq"))))

        run = self.golden_run

        def same(got: str, gold: str, what: str) -> None:
            self.same_golden(got, gold, f"the device-resolve path ({what})")

        out = {}
        cuda.reset_launches()
        pipe = m["Pipe"](idx, cfg, device=self.dev)
        same(run(pipe, recs), "golden_output.tsv", "unpaired")
        with tempfile.TemporaryDirectory() as td:
            rep = os.path.join(td, "rep.tsv")
            m["write_report"](rep, idx, pipe.spm, abundance_analysis=True)
            with open(rep) as f:
                same(f.read(), "golden_report.tsv", "report")
        dfm = pipe.dfm
        pipe = m["Pipe"](idx, cfg, device=self.dev, dfm=dfm)
        same(run(pipe, pairs, paired=True), "golden_paired.tsv", "paired")
        out["launches"] = dict(cuda.LAUNCHES)
        self.check_path("synth device-resolve", out["launches"],
                        DEVICE_RESOLVE_PATH)
        cuda.reset_launches()
        pipe = m["Pipe"](idx, cfg, device=self.dev, dfm=dfm)
        pipe.presolve = False
        same(run(pipe, recs), "golden_output.tsv", "presolve off")
        out["launches_presolve_off"] = dict(cuda.LAUNCHES)
        if pipe.metrics.resolve_miss_rows != pipe.metrics.resolve_rows:
            fail("with the presolve off, every row must resolve in the tail")
        self.check_path("synth tail-resolve", out["launches_presolve_off"],
                        ("search", "resolve"), absent=("presolve",))
        emit(dict(phase="synth_device_resolve",
                  unpaired="byte-equal", report="byte-equal",
                  paired="byte-equal", presolve_off="byte-equal",
                  tail_resolved_rows=pipe.metrics.resolve_rows, **out))

    def synth_sharded(self) -> None:
        """The goldens through GPUClassificationPipeline over meshes that
        repeat cuda:0: unpaired rows and report on a (2, 2) narrow mesh,
        paired rows on a (1, 4) wide mesh, with host and device resolve;
        each run launches K6 and no single-device kernel."""
        m = self.m
        cuda = m["cuda"]
        idx = m["load_cf_index"](os.path.join(FIX, "synth"))
        recs = m["read_batch"]([os.path.join(FIX, "reads.fq")])
        pairs = list(zip(m["read_fastx"](os.path.join(FIX, "reads_1.fq")),
                         m["read_fastx"](os.path.join(FIX, "reads_2.fq"))))
        out = {}
        for hr in (True, False):
            path = "host" if hr else "device"
            what = f"the mesh pipeline ({path} resolve"
            cuda.reset_launches()
            pipe = m["Pipe"](idx, m["Cfg"](host_resolve=hr), device=self.dev,
                             mesh=self.mesh(2, 2))
            self.same_golden(self.golden_run(pipe, recs),
                             "golden_output.tsv", what + ", unpaired)")
            with tempfile.TemporaryDirectory() as td:
                rep = os.path.join(td, "rep.tsv")
                m["write_report"](rep, idx, pipe.spm,
                                  abundance_analysis=True)
                with open(rep) as f:
                    self.same_golden(f.read(), "golden_report.tsv",
                                     what + ", report)")
            pipe = m["Pipe"](idx, m["Cfg"](host_resolve=hr), device=self.dev,
                             mesh=self.mesh(1, 4), wide=True)
            self.same_golden(self.golden_run(pipe, pairs, paired=True),
                             "golden_paired.tsv", what + ", paired)")
            out[f"launches_{path}_resolve"] = dict(cuda.LAUNCHES)
            self.check_path(
                f"synth mesh {path}-resolve", cuda.LAUNCHES,
                MESH_HOST_PATH if hr else MESH_DEVICE_PATH,
                absent=("sharded_resolve",) if hr else ())
        emit(dict(phase="synth_sharded", meshes=["(2, 2) narrow unpaired",
                                                 "(1, 4) wide paired"],
                  unpaired="byte-equal", report="byte-equal",
                  paired="byte-equal", **out))

    def multihost(self) -> None:
        """Two processes on cuda:0, joined by gloo for the host scalars,
        each classifying its half of the synth reads over a (1, 2) wide
        mesh (parallel/multihost.py); the merged rows equal the golden
        rows."""
        import socket
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = []
        with tempfile.TemporaryDirectory() as td:
            outs = [os.path.join(td, f"shard{p}.tsv") for p in range(2)]
            t0 = time.perf_counter()
            try:
                for pid, out in enumerate(outs):
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", MULTIHOST_WORKER, REPO,
                         str(pid), "2", str(port), out, str(self.dev)],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True))
                results = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, (so, se) in zip(procs, results):
                if p.returncode:
                    fail(f"multihost worker exit {p.returncode}: "
                         f"{se[-2000:]}")
            launches = [json.loads(so.strip().splitlines()[-1])
                        for so, _ in results]
            merged = []
            for out in outs:
                with open(out) as f:
                    merged += f.read().splitlines()
        for ln in launches:
            self.check_path("multihost", ln, MESH_DEVICE_PATH)
        with open(os.path.join(FIX, "golden_output.tsv")) as f:
            golden = f.read().splitlines()[1:]
        ids = {r.split("\t", 1)[0] for r in merged}
        if merged != [r for r in golden if r.split("\t", 1)[0] in ids] \
                or len(ids) != 3000:
            fail("multihost: the merged rows differ from the golden rows")
        emit(dict(phase="multihost", processes=2, mesh_per_process=[1, 2],
                  rows="merged rows equal the golden rows",
                  reads=len(ids), seconds=round(time.perf_counter() - t0, 3),
                  launches=launches))

    def full(self) -> None:
        m, torch, np = self.m, self.torch, self.np
        fmt, rk, eng_mod = m["fm_torch"], m["rank"], m["engine"]
        bigdb = m["bigdb"]
        bigdb.N_GENOMES = BIGDB_GENOMES
        t0 = time.perf_counter()
        base = bigdb.ensure_bigdb(CACHE)
        db_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx = m["load_cf_index"](base)
        load_s = time.perf_counter() - t0
        recs = m["read_batch"]([os.path.join(CACHE, "reads_100k.fq")])
        batches = [recs[i: i + BATCH_READS]
                   for i in range(0, len(recs), BATCH_READS)]

        # ---- the main path, counted: index load (K0 + K4), then every
        # batch through the pipeline (K1), rows resolved on the host ----
        torch.cuda.reset_peak_memory_stats()
        pipe, rows, index_s, stream_s, launches = self.stream(idx, batches,
                                                              True)
        peak = torch.cuda.max_memory_allocated()
        fm = pipe.dfm
        pm = pipe.metrics
        self.check_path("host-resolve", launches, HOST_RESOLVE_PATH,
                        absent=("presolve", "resolve"))
        off = [k for k, t in fm.tensors().items() if t.device != self.dev]
        if off:
            fail(f"index tensors off the card: {off}")
        if not fm.deep:
            fail("the depth-12 ftab gate did not switch on")
        emit(dict(phase="full_main_path", bases=int(idx.bwt_len),
                  genomes=BIGDB_GENOMES, reads=len(recs),
                  batch_reads=BATCH_READS, db_build_s=round(db_s, 3),
                  cf_load_s=round(load_s, 3),
                  index_to_device_s=round(index_s, 3),
                  stream_s=round(stream_s, 3),
                  reads_per_s=round(len(recs) / stream_s, 1),
                  launches=launches, index_mb=round(fm.nbytes / 1e6, 1),
                  max_memory_allocated=int(peak),
                  # main thread blocked on fetches / on the tail worker,
                  # and the tail worker's busy time (host clock)
                  collect_wait_s=round(pm.collect_wait_secs, 3),
                  tail_wait_s=round(pm.tail_wait_secs, 3),
                  tail_run_s=round(pm.tail_run_secs, 3),
                  upload_mb=round(pm.upload_bytes / 1e6, 1),
                  download_mb=round(pm.download_bytes / 1e6, 1)))

        # ---- the first 300 reads against the host oracle ----
        t0 = time.perf_counter()
        orc = m["OraclePipe"](idx, m["FMOracle"](idx), m["Cfg"]())
        want = []
        for r in recs[:ORACLE_READS]:
            want += orc.classify_unpaired(r)
        if rows[: len(want)] != want:
            bad = next(i for i, (a, b) in enumerate(zip(rows, want))
                       if a != b)
            fail(f"oracle mismatch at row {bad}: {rows[bad]!r} vs "
                 f"{want[bad]!r}")
        emit(dict(phase="full_oracle", reads=ORACLE_READS,
                  rows=len(want), result="byte-equal",
                  seconds=round(time.perf_counter() - t0, 3)))

        # ---- the device-resolve path (host_resolve=False) on the same
        # index and reads: presolve (K5 + K3) in each search dispatch,
        # the tail's misses through K3 and K1 ----
        torch.cuda.reset_peak_memory_stats()
        pipe2, rows2, _, stream2_s, launches2 = self.stream(
            idx, batches, False, fm)
        self.check_path("device-resolve", launches2, DEVICE_RESOLVE_PATH)
        self.same_rows("device-resolve", rows2, rows)
        pm2 = pipe2.metrics
        emit(dict(phase="full_device_resolve", reads=len(recs),
                  rows="byte-equal to the host-resolve stream",
                  stream_s=round(stream2_s, 3),
                  reads_per_s=round(len(recs) / stream2_s, 1),
                  launches=launches2,
                  max_memory_allocated=int(torch.cuda.max_memory_allocated()),
                  collect_wait_s=round(pm2.collect_wait_secs, 3),
                  tail_wait_s=round(pm2.tail_wait_secs, 3),
                  tail_run_s=round(pm2.tail_run_secs, 3),
                  resolve_rows=pm2.resolve_rows,
                  resolve_miss_rows=pm2.resolve_miss_rows,
                  ext_lanes=pm2.ext_lanes,
                  download_mb=round(pm2.download_bytes / 1e6, 1)))

        # ---- the two paths in turns on one card (host, device, device,
        # host): the first two are the streams above ----
        turns = [("host", stream_s, pm), ("device", stream2_s, pm2)]
        for path in ("device", "host"):
            p, r, _, sec, launches_t = self.stream(idx, batches,
                                                   path == "host", fm)
            if path == "host":      # the index is built: K1 only
                self.check_path("host-resolve (turn)", launches_t,
                                ("search",), absent=("presolve", "resolve"))
            else:
                self.check_path("device-resolve (turn)", launches_t,
                                DEVICE_RESOLVE_PATH)
            self.same_rows(f"{path}-resolve (turn)", r, rows)
            turns.append((path, sec, p.metrics))
        emit(dict(phase="full_turns", order=[t[0] for t in turns],
                  reads_per_s=[round(len(recs) / t[1], 1) for t in turns],
                  tail_run_s=[round(t[2].tail_run_secs, 3) for t in turns],
                  tail_wait_s=[round(t[2].tail_wait_secs, 3)
                               for t in turns]))

        # ---- K1 against its plain version on one full batch ----
        eng = pipe.engine
        seqs = self.lanes_of(batches[0])
        reads, lens, st, lmax = self.packed_lanes(eng, seqs)
        args = (fm, reads, lens, st, SEARCH_MH, eng.min_hitlen,
                eng.increment, False, eng._deep(lmax))
        got = eng_mod.search_lanes(*args)
        want, plain_ms = self.time_host(
            lambda: eng_mod.search_plain(*args))
        err = self.equal("search (full batch)", got, want)
        ms = self.time_cuda(lambda: eng_mod.search_lanes(*args), 5)
        stats = {}
        eng_mod.search_plain(*args, stats=stats)
        nbytes, int_ops, popc = self.traffic(fm, stats)
        # the plain lockstep loop's steps: its longest lane's chain
        longest = len(stats.get("bwt_rows", []))
        del stats
        rsz = fm.fchr.element_size()
        L = len(seqs)
        # reads, lengths and starts in; hit arrays, nhits and sums out
        io = (reads.numel() + 8 * L + L * SEARCH_MH * (2 * rsz + 8)
              + 8 * L + fm.fchr.numel() * rsz)
        self.rows["search"].update(
            launches=launches["search"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, lanes=L,
            lockstep_steps=longest,
            **self.bound(nbytes + io, int_ops, popc),
            **self.launch_shape("search", fm.wide, L),
            ptxas=self.ptxas.get("search", []))

        # ---- K5 on that batch's first-pass hit buffers, as the
        # device-resolve path's dispatch runs it: the kernel by CUDA
        # events (its launches alone, each on a zeroed ticket buffer),
        # the wrapper by events (back-to-back calls) and by the host
        # clock (one call to its synchronize) ----
        khits = pipe2.cfg.classifier.khits
        pre = (got[0], got[1], got[3], khits, pipe2.classifier.ihits,
               eng.min_hitlen, eng_mod.presolve_rk(khits))
        flat = eng_mod.presolve_rows(*pre)
        want, plain_ms = self.time_host(
            lambda: eng_mod.presolve_rows_plain(*pre))
        err = self.equal("presolve (full batch)", [flat], [want])
        ms = self.presolve_kernel_ms(pre, flat, 20)
        wrapper_ms = self.time_cuda(lambda: eng_mod.presolve_rows(*pre), 20)
        _, host_ms = self.time_host(lambda: eng_mod.presolve_rows(*pre))
        M, n = L // 2, 2 * SEARCH_MH
        # hit buffers in, flat rows out; the pick per entry and per mate,
        # the index and copy per flat slot
        io = L * SEARCH_MH * (2 * rsz + 4) + flat.numel() * rsz
        ops = (L * SEARCH_MH * PICK_OPS + M * n * math.ceil(math.log2(n))
               + 2 * flat.numel())
        self.rows["presolve"].update(
            launches=launches2["presolve"], max_abs_err=err, ms=ms,
            wrapper_ms=wrapper_ms, host_clock_ms=host_ms,
            plain_ms=plain_ms, library_ms=None, mates=M,
            flat_rows=flat.numel(), launches_per_call=1,
            mates_per_block=eng_mod.PRESOLVE_MATES_PER_BLOCK,
            blocks=-(-M // eng_mod.PRESOLVE_MATES_PER_BLOCK),
            **self.bound(io, ops, 0),
            ptxas=self.ptxas.get("presolve", []))

        # ---- K3 on those flat rows ----
        tidx = fmt.resolve_rows(fm, flat)
        want, plain_ms = self.time_host(
            lambda: fmt.resolve_rows_plain(fm, flat))
        err = self.equal("resolve (full batch)", [tidx], [want])
        ms = self.time_cuda(lambda: fmt.resolve_rows(fm, flat), 20)
        stats = {}
        fmt.resolve_rows_plain(fm, flat, stats=stats)
        steps = sum(r.numel() for r in stats.get("bwt_rows", []))
        longest = len(stats.get("bwt_rows", []))   # the longest walk
        nbytes, int_ops, popc = self.traffic(fm, stats)
        del stats
        # rows in, values out, the boundary table and fchr read
        io = (flat.numel() * (rsz + 4) + fm.boundary_rows.numel() * (rsz + 4)
              + fm.fchr.numel() * rsz)
        self.rows["resolve"].update(
            launches=launches2["resolve"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, rows=flat.numel(),
            lf_steps=steps, longest_walk=longest,
            unresolved=int((tidx < 0).sum()),
            **self.bound(nbytes + io, int_ops, popc),
            **self.launch_shape("resolve", fm.wide, flat.numel()),
            ptxas=self.ptxas.get("resolve", []))
        # what full_sharded runs again over the mesh
        self.full_state = dict(idx=idx, batches=batches, rows=rows,
                               hits=[t.clone() for t in got], flat=flat,
                               tidx=tidx)

        # ---- K4 against its plain version: its own launch (level 2),
        # and the whole build (K0's level-1 entry, then K4) ----
        t0v, b0v = fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10]
        plain = torch.zeros_like(fm.ftab12_rows)
        _, plain_ms = self.time_host(lambda: fmt.ftab12_plain(
            fm.blocks, fm.fchr, fm.zoff, t0v, b0v, plain))
        err = self.equal("ftab12 (full size)", [fm.ftab12_rows], [plain])
        t1, b1 = fmt.ftab12_level1(fm.blocks, fm.fchr, fm.zoff, t0v, b0v)
        scratch = torch.zeros_like(fm.ftab12_rows)
        ms = self.time_cuda(lambda: fmt.ftab12_level2(
            fm.blocks, fm.fchr, fm.zoff, t0v, b0v, t1, b1, scratch), 5)
        self.equal("ftab12 (timed launch)", [scratch], [plain])
        scratch.zero_()
        build_ms = self.time_cuda(lambda: fmt.build_ftab12(
            fm.blocks, fm.fchr, fm.zoff, t0v, b0v, scratch), 3)
        self.equal("ftab12 (timed build)", [scratch], [plain])
        del scratch, plain
        k4 = self.ftab12_bound(fm, t0v, b0v, t1, b1)
        self.rows["ftab12"].update(
            launches=launches["ftab12"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, build_ms=build_ms,
            **k4, **self.launch_shape("ftab12", fm.wide, 4 * fmt.N10),
            ptxas=self.ptxas.get("ftab12", []))
        del t1, b1

        # ---- K0 at the main path's size: its level-1 entry over the
        # 2^20 depth-10 ranges, the launch the index load makes ----
        l1_args = (fm.blocks, fm.fchr, fm.zoff, t0v, b0v)
        l1 = rk.level1(*l1_args)
        want, plain_ms = self.time_host(lambda: rk.level1_plain(*l1_args))
        err = self.equal("level 1 (full size)", list(l1), list(want))
        del want
        ms = self.time_cuda(lambda: rk.level1(*l1_args), 10)
        # ---- the generic kernel on the same 8,388,608 (row, char) pairs
        # (LF of both ends of every range for each char), where it equals
        # the level 1 under the empty-parent guard ----
        rows1 = torch.cat([t0v.repeat(4), b0v.repeat(4)])
        chars1 = torch.arange(4, dtype=torch.int32, device=self.dev
                              ).repeat_interleave(fmt.N10).repeat(2)
        lf_args = (fm.blocks, fm.fchr, fm.zoff, rows1, chars1)
        got = rk.lf(*lf_args)
        want, plain8_ms = self.time_host(lambda: (
            fm.fchr.to(torch.int64)[chars1.to(torch.int64)]
            + rk.rank_plain(fm.blocks, fm.zoff, rows1, chars1)
        ).to(rows1.dtype))
        err8 = self.equal("lf (the level-1 pairs)", [got], [want])
        self.equal("level 1 against the generic kernel", [torch.cat(l1)],
                   [torch.where((b0v > t0v).repeat(8), got, 0)])
        del got, want, l1
        ms8 = self.time_cuda(lambda: rk.lf(*lf_args), 5)
        nbytes, int_ops, popc = self.traffic(
            fm, dict(rank_rows=[rows1], rank_chars=[chars1]))
        io = rows1.numel() * (2 * rsz + 4) + fm.fchr.numel() * rsz
        b8 = self.bound(nbytes + io, int_ops, popc)
        self.rows["rank"].update(
            launches=launches["rank"], max_abs_err=max(err, err8), ms=ms,
            plain_ms=plain_ms, library_ms=None, ranges=fmt.N10,
            **self.level1_bound(fm, t0v, b0v),
            **self.launch_shape("rank", fm.wide, fmt.N10, "lf_level1"),
            ptxas=self.ptxas.get("rank", []),
            at_8388608_queries=dict(
                ms=ms8, plain_ms=plain8_ms, max_abs_err=err8,
                bound_ms=b8["bound_ms"], bound_by=b8["bound_by"],
                moved_bytes=b8["moved_bytes"],
                **self.launch_shape("rank", fm.wide, rows1.numel())))
        del rows1, chars1
        # the whole ftab build's bound: the level 1's work and K4's,
        # moved and computed once each
        r0, r4 = self.rows["rank"], self.rows["ftab12"]
        b = self.bound(r0["moved_bytes"] + r4["moved_bytes"],
                       r0["int_ops"] + r4["int_ops"],
                       r0["popc_ops"] + r4["popc_ops"])
        r4.update(build_bound_ms=b["bound_ms"], build_bound_by=b["bound_by"])

        # ---- K0 at 65,536 random queries ----
        g = np.random.default_rng(11)
        n = 65536
        rows_q = torch.from_numpy(g.integers(0, idx.bwt_len + 1, n).astype(
            np.int64 if fm.wide else np.int32)).to(self.dev)
        chars = torch.from_numpy(g.integers(0, 4, n).astype(np.int32)).to(
            self.dev)
        got = rk.rank(fm.blocks, fm.zoff, rows_q, chars)
        want, plain_ms = self.time_host(lambda: rk.rank_plain(
            fm.blocks, fm.zoff, rows_q, chars).to(rows_q.dtype))
        err = self.equal("rank (full size)", [got], [want])
        # the kernel alone, a CUDA graph of launches through its C entry:
        # back-to-back wrapper calls of a kernel this short are paced by
        # the wrapper's host work
        out = torch.empty_like(rows_q)
        ms = m["tile_sweep"].rank_kernel_ms(fm, rows_q, chars, out, 50)
        self.equal("rank (timed kernel)", [out], [want])
        wrapper_ms = self.time_cuda(lambda: rk.rank(fm.blocks, fm.zoff,
                                                    rows_q, chars), 50)
        nbytes, int_ops, popc = self.traffic(
            fm, dict(rank_rows=[rows_q], rank_chars=[chars]))
        io = n * (2 * rows_q.element_size() + 4)   # rows, chars in; out
        b = self.bound(nbytes + io, int_ops, popc)
        self.rows["rank"]["at_65536_queries"] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            max_abs_err=err, bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], **self.launch_shape("rank", fm.wide, n))
        emit(dict(phase="full_kernels", library_ms_note=NO_LIBRARY,
                  card=self.smi))


    def full_sharded(self) -> None:
        """The 256 Mbp stream through a (1, 4) mesh of cuda:0, host and
        device resolve, each byte-equal to the single-device host-resolve
        stream; then K6's search on the first batch and its walk on that
        batch's presolve rows, beside their plain versions, bounds and
        the single-device kernels' outputs."""
        m, torch = self.m, self.torch
        shd, eng_mod, cuda = m["sharded"], m["engine"], m["cuda"]
        st = self.full_state
        idx, batches = st["idx"], st["batches"]
        nreads = sum(len(b) for b in batches)
        mesh = self.mesh(1, MESH_FM)
        pipes = {}
        for hr in (True, False):
            path = "host" if hr else "device"
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            t0 = time.perf_counter()
            pipe = m["Pipe"](idx, m["Cfg"](host_resolve=hr), device=self.dev,
                             mesh=mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = []
            for chunk in pipe.classify_stream_unpaired(batches):
                rows += chunk
            t2 = time.perf_counter()
            launches = dict(cuda.LAUNCHES)
            self.check_path(f"mesh {path}-resolve", launches,
                            MESH_HOST_PATH if hr else MESH_DEVICE_PATH,
                            absent=("sharded_resolve",) if hr else ())
            self.same_rows(f"mesh {path}-resolve", rows, st["rows"])
            pm = pipe.metrics
            pipes[hr] = (pipe, launches)
            emit(dict(phase="full_sharded", mesh=[1, MESH_FM],
                      resolve=path, reads=nreads,
                      rows="byte-equal to the single-device host-resolve "
                           "stream",
                      index_to_device_s=round(t1 - t0, 3),
                      stream_s=round(t2 - t1, 3),
                      reads_per_s=round(nreads / (t2 - t1), 1),
                      launches=launches,
                      index_mb=round(pipe.mesh_index.nbytes / 1e6, 1),
                      max_memory_allocated=int(
                          torch.cuda.max_memory_allocated()),
                      collect_wait_s=round(pm.collect_wait_secs, 3),
                      tail_wait_s=round(pm.tail_wait_secs, 3),
                      tail_run_s=round(pm.tail_run_secs, 3),
                      resolve_rows=pm.resolve_rows, ext_lanes=pm.ext_lanes))

        # ---- K6's search on the first batch, against its plain version
        # and K1's outputs on the same lanes ----
        pipe = pipes[True][0]
        index, eng = pipe.mesh_index, pipe.engine
        seqs = self.lanes_of(batches[0])
        reads, lens, st0, _ = self.packed_lanes(eng, seqs)
        args = (reads, lens, st0, SEARCH_MH, eng.min_hitlen, eng.increment,
                False)
        before = cuda.LAUNCHES["sharded_search"]
        got = shd.sharded_search(index, *args)
        per_batch = cuda.LAUNCHES["sharded_search"] - before
        if per_batch != mesh.n_dp:
            fail(f"sharded search: {per_batch} launches for {mesh.n_dp} "
                 "dp rows")
        want, plain_ms = self.time_host(
            lambda: shd.sharded_search_plain(index, *args))
        err = self.equal("sharded search (full batch)", got, want)
        self.equal("sharded search vs K1 (full batch)", got, st["hits"])
        ms = self.time_cuda(lambda: shd.sharded_search(index, *args), 3)
        _, host_ms = self.time_host(lambda: shd.sharded_search(index, *args))
        stats = {}
        shd.sharded_search_plain(index, *args, stats=stats)
        tables = self.sharded_tables(index)
        nbytes, int_ops, popc = self.traffic(tables, stats)
        del stats
        rsz = 8 if index.wide else 4
        L = len(seqs)
        io = (reads.numel() + 8 * L + L * SEARCH_MH * (2 * rsz + 8)
              + 8 * L + 5 * rsz)
        b = self.bound(nbytes + io, int_ops, popc)
        self.rows["sharded_search"].update(
            launches=pipes[True][1]["sharded_search"], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=None, lanes=L,
            mesh=[1, MESH_FM], launches_per_batch=per_batch,
            host_clock_ms=host_ms, x_bound=ms / b["bound_ms"], **b)

        # ---- K6's walk on that batch's presolve rows, against its plain
        # version and K3's values ----
        flat = st["flat"]
        before = cuda.LAUNCHES["sharded_resolve"]
        tidx = shd.sharded_resolve(index, flat)
        per_call = cuda.LAUNCHES["sharded_resolve"] - before
        if per_call != mesh.n_dp:
            fail(f"sharded resolve: {per_call} launches for {mesh.n_dp} "
                 "dp rows")
        want, plain_ms = self.time_host(
            lambda: shd.sharded_resolve_plain(index, flat))
        err = self.equal("sharded resolve (full batch)", [tidx], [want])
        self.equal("sharded resolve vs K3 (full batch)", [tidx],
                   [st["tidx"]])
        ms = self.time_cuda(lambda: shd.sharded_resolve(index, flat), 5)
        _, host_ms = self.time_host(lambda: shd.sharded_resolve(index, flat))
        stats = {}
        shd.sharded_resolve_plain(index, flat, stats=stats)
        lf_steps = sum(r.numel() for r in stats.get("bwt_rows", []))
        nbytes, int_ops, popc = self.traffic(tables, stats)
        del stats, tables
        io = (flat.numel() * (rsz + 4)
              + index.rows[0].brows.numel() * (rsz + 4) + 5 * rsz)
        b = self.bound(nbytes + io, int_ops, popc)
        self.rows["sharded_resolve"].update(
            launches=pipes[False][1]["sharded_resolve"], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=None, rows=flat.numel(),
            mesh=[1, MESH_FM], lf_steps=lf_steps, launches_per_call=per_call,
            host_clock_ms=host_ms, x_bound=ms / b["bound_ms"], **b)
        emit(dict(phase="full_sharded_kernels", card=self.smi,
                  search_ms=self.rows["sharded_search"]["ms"],
                  search_host_clock_ms=self.rows["sharded_search"][
                      "host_clock_ms"],
                  resolve_ms=ms, resolve_host_clock_ms=host_ms))

def main(argv) -> int:
    if argv:
        print("usage: chip_smoke.py (no arguments)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "centrifuge_tpu_torch")) \
            or not os.path.isdir(FIX):
        print("chip_smoke: run from a checkout of the repository "
              "(centrifuge_tpu_torch/ and tests/fixtures/ beside it)",
              file=sys.stderr)
        return 2
    m = load_port()
    torch = m["torch"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    s = Smoke(m)
    for phase in (s.env, s.kernels, s.kernels_sharded, s.synth,
                  s.synth_sharded, s.multihost, s.full, s.full_sharded):
        phase()
    emit({"kernels": list(s.rows.values())})
    print(s.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": s.name,
                                 "count": s.count}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
