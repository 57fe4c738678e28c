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
            synth reads, deep or not, min_hitlen 16 and 22, and narrow
            also in pool mode (budgets of 8 records a lane and of 1, a
            spill; the pool expanded through HitPool); the SA
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
  wide_scale  every kernel past 2^31 rows: a wide table of 2^31 + 2^20 + 7
            rows generated on the card from a seed
            (evaluation/wide_table.py random_wide_index: random BWT words,
            occ, fchr and the depth-10 ftab counted from them by the
            plain versions, '$' and half the boundary rows past 2^31,
            random SA samples), reads walked back through it by LF; K4's
            depth-12 build, K0's level 1 and its generic entry on 65,536
            pairs with the edge rows, K3 on 65,536 rows below and past
            2^31 and the edges (max_steps 4096 and 1), K1 on 16,384 lanes
            (deep or not, min_hitlen 16 and 22), K5 then K3 on their hit
            buffers (khits 5 and 16), K6's search and walk on a (1, 2)
            mesh of cuda:0 (the second shard past 2^30 rows), also against
            K1 and K3: exact equality with the plain versions; the table
            is freed before the next phase
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
  graft_entry  the port's entry points (centrifuge_tpu_torch/graft_entry.py,
            the counterpart of __graft_entry__.py): entry()'s K1 call on
            the 128 lanes of the first 64 synth reads, launched once and
            equal to search_plain on the same arguments on the CPU, timed
            by CUDA events (median of 20 after a warm-up);
            dryrun_multichip over every card, then over meshes of 2, 4
            and 8 entries of cuda:0 ((1, 2), (2, 2), (4, 2)), the 256
            reads' rows equal to the golden rows, K6's search launched
            and no single-device kernel; python -m
            centrifuge_tpu_torch.graft_entry in a process of its own,
            exit 0 with both of its ok lines
  bench     python -m centrifuge_tpu_torch.bench (the counterpart of
            bench.py) with --trials 1 in a process of its own: the parity
            gate on the 3,000 synth reads, unpaired and paired reads/s
            (one trial of 12 batches of 65,536 lanes each; the 5-trial
            bench at its defaults is a run of its own), K1's launch alone
            by CUDA events; exit 0 with parity_ok and native_ok true, on
            "cuda", K1 launched, every rate above 0; its line is emitted
            with the phase's seconds
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
            its own bound; K1 and K5 on the first batch (K1 in the
            main path's pool mode, checked and timed, its padded mode
            timed beside it and checked as K5's input), K5's
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
  parity    the reference's parity surface: the 30 cases of
            PARITY_CASES (each the argv of a JAX test of the classify CLI
            and its goldens, from tests/test_cli.py, test_parity.py and
            test_parity_configs.py) through the classify CLI on six
            routes (PARITY_ROUTES: host and device resolve on one card,
            the wide layout forced on both, a (1, 2) mesh of cuda:0 on
            both), every output byte-equal to its golden, one line a
            route, each route's kernels launched and the other path's
            not; then the 256 Mbp database of `full` at k 1, k 20 and
            min-hitlen 16 over its reads and 16,384 pairs simulated from
            its genomes at k 1, each streamed on the host then the
            device resolve: byte-equal, the first 300 reads or pairs
            equal to the host oracle under the same settings, reads/s
  tools     the port's tool surface (python -m centrifuge_tpu_torch
            <tool>) on the synth fixture: build byte-equal to
            synth.{1..4}.cf; inspect, kreport and promote byte-equal to
            the goldens of tests/test_cli.py; simulate 1,000 reads,
            classify them on the card in a process of its own (run as
            python -m runs it), evaluate them (its per-rank lines)
  prof      evaluation/prof.py on the 256 Mbp index and the full batches
            that `full` holds, once with the host resolve and once with
            the device resolve: one JSON line each (the per-batch search,
            dispatch and block, the host tail, the main thread's split,
            streams, the device's idle share, steps per lane); each
            line's keys present and its device timings measured
  harnesses the mesh harnesses, launch counts from 0 before each:
            parallel/shardbench.py --real (the synth reads through the
            plain engine and a (1, 1) mesh, rows identical) and --device
            (K1 against K6 by CUDA events); parallel/shardscale.py on the
            256 Mbp database over a (2, 2) mesh of cuda:0, byte-equal to
            full's host-resolve stream; parallel/scaling_bench.py in 1 and
            then 2 processes on cuda:0 (a (2, 2) mesh each), the merged
            rows equal to the golden rows, and in 2 processes ((1, 2)
            meshes) on full's reads, the merged rows equal to full's
            stream

Then one JSON line of per-kernel numbers, the card's nvidia-smi line,
and last {"ok": true, "device": {...}}. It takes no arguments.

Each kernel's bound is the larger of two times, from the lookups that
its plain version records on the same inputs: the bytes it must move
(each input and output once; of the index tables, each 32-byte sector
its lookups touch, once) over the HBM rate, and its rank arithmetic
over the card's integer and popcount issue rates.
"""

import contextlib
import dataclasses
import gzip
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from typing import NamedTuple, Optional, Tuple

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
BIGDB_READS = "reads_100k.fq"  # evaluation/bigdb.py's reads
# the parity phase at 256 Mbp: the classifier settings of the
# configurations streamed on both resolve paths, and the pairs simulated
# from bigdb's genomes (evaluation/simulate.py; file prefix, count,
# seed) streamed at k 1, PARITY_PAIRS_BATCH pairs a batch
PARITY_FULL = (("k1", dict(khits=1)), ("k20", dict(khits=20)),
               ("minhit16", dict(min_hitlen=16)))
PARITY_PAIRS = ("bigdb_pairs_16k", 16384, 29)
PARITY_PAIRS_BATCH = 4096
PROF_RUNS = 2                  # prof's streams of each kind, tail replays
SIM_READS = 1000               # the tools phase's simulated reads
# scaling_bench's batch on synth: it divides the 3,000 synth reads and
# the 1,500 of each of two processes, so no read is left out (on full's
# 99,968 reads, an eighth of them: a quarter of each process's share)
SCALING_BATCH = 500
# the keys every prof line holds, and those that must hold a measurement
# on the card (with "value" of device_idle_share)
PROF_KEYS = ("device_search_fetch_ms", "device_compute_ms", "dispatch_ms",
             "transfer_block_ms", "host_tail_ms", "host_prep_ms",
             "host_prep_split_ms", "e2e_serial_reads_per_sec",
             "e2e_serial_runs", "e2e_serial_collect_wait_s",
             "e2e_serial_tail_wait_s", "e2e_serial_tail_run_s",
             "e2e_threaded_reads_per_sec", "e2e_threaded_runs",
             "e2e_threaded_collect_wait_s", "e2e_threaded_tail_wait_s",
             "e2e_threaded_tail_run_s", "upload_mb_per_batch",
             "download_mb_per_batch", "resolve_rows_per_batch",
             "device_idle_share", "device_ops", "nvidia_smi",
             "lockstep_mean_steps", "lockstep_max_steps",
             "lockstep_survivors", "index_bwt_len")
PROF_DEVICE_KEYS = ("device_search_fetch_ms", "device_compute_ms",
                    "device_ops", "nvidia_smi")
SYN = os.path.join(FIX, "synth")
# the tools phase's goldens (tests/test_cli.py): the tool's argv, the
# fixture fed on stdin, the golden
TOOL_GOLDENS = [(["inspect", flag, SYN], None, f"inspect/golden_{g}.txt")
                for flag, g in (("-n", "names"), ("-s", "summary"),
                                ("--conversion-table", "conv"),
                                ("--taxonomy-tree", "tree"),
                                ("--name-table", "nametab"),
                                ("--size-table", "sizetab"))] + [
    (["kreport", "-x", SYN], "golden_output.tsv", "golden_kreport.txt"),
    (["kreport", "-x", SYN, os.path.join(FIX, "golden_k20.tsv")], None,
     "golden_kreport_k20.txt"),
    (["kreport", "-x", SYN, "--no-lca", os.path.join(FIX, "golden_k20.tsv")],
     None, "golden_kreport_k20_nolca.txt"),
    (["kreport", "-x", SYN, "--min-score", "1000",
      os.path.join(FIX, "golden_output.tsv")], None,
     "golden_kreport_minscore.txt"),
    (["kreport", "-x", SYN, "--is-count-table"], "counts.tsv",
     "golden_kreport_counts.txt"),
    (["promote", SYN, os.path.join(FIX, "golden_output.tsv"), "species"],
     None, "golden_promote_species.tsv"),
    (["promote", SYN, os.path.join(FIX, "golden_k20.tsv"), "lca"], None,
     "golden_promote_lca.tsv"),
]
EVAL_LINES = ["reads", "unclassified", "strain", "species", "genus",
              "family", "order", "class", "phylum"]

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
GRAFT_MESH_SIZES = (2, 4, 8)   # graft_entry's meshes of cuda:0
GRAFT_REPS = 20                # graft_entry's timed K1 calls
BENCH_TIMEOUT = 300            # s for the bench with one trial
# wide_scale: its table's seed, K0's and K3's query rows, the reads
# walked through the table and their length
WIDE_SEED = 31
WIDE_ROWS = 65536
WIDE_READS = 8192
WIDE_READ_LEN = 150
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


# the tools phase's classify process: runs the port's __main__ as
# `python -m centrifuge_tpu_torch` does (runpy), then writes its launch
# counts; argv = repo, launch-count file, the tool's argv
TOOLS_WORKER = r"""
import json, runpy, sys
repo, counts = sys.argv[1:3]
sys.path.insert(0, repo)
from centrifuge_tpu_torch import _cuda
sys.argv = ["centrifuge_tpu_torch"] + sys.argv[3:]
try:
    runpy.run_module("centrifuge_tpu_torch", run_name="__main__",
                     alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
with open(counts, "w") as f:
    json.dump(_cuda.LAUNCHES, f)
sys.exit(code)
"""


# ---- the reference's parity surface ----

class ParityCase(NamedTuple):
    """A configuration of the reference's parity surface, held to the
    goldens of the JAX package's tests (tests/test_cli.py,
    test_parity.py, test_parity_configs.py), which the reference
    binaries wrote."""
    name: str
    # classify's argv after `-x <index> -S {td}/out.tsv`: {fx} is the
    # fixture's directory, {td} the run's; None: the pipeline-level case
    # (nfail_paired, test_parity_configs.py:65-86)
    argv: Optional[Tuple[str, ...]]
    # (file the run writes in {td}, its golden in {fx}); a golden of None
    # is an empty file (gunzipped where the name ends in .gz); "<stderr>"
    # is the run's standard error
    goldens: Tuple[Tuple[str, Optional[str]], ...]
    # the case changes what the kernels see (read lengths, empty lanes,
    # the mate layout, the hit count or length): routes c and d run it
    device_work: bool
    fixture: str = "synth"


PARITY_INDEX = {"synth": "synth", "example": "test"}
_U = ("-U", "{fx}/reads.fq")
_P = ("-1", "{fx}/reads_1.fq", "-2", "{fx}/reads_2.fq")
_NO_REPORT = ("--report-file", "")
_REPORT = ("--report-file", "{td}/rep.tsv")
# tests/test_cli.py QUAL_COLS
QUAL_COLS = ("readID,seqID,taxID,score,2ndBestScore,hitLength,queryLength,"
             "numMatches,readQual")


def _tsv(name: str, argv, device_work: bool) -> ParityCase:
    """A case whose one output is the TSV, held to golden_<name>.tsv."""
    return ParityCase(name, tuple(argv) + _NO_REPORT,
                      (("out.tsv", f"golden_{name}.tsv"),), device_work)


PARITY_CASES = (
    ParityCase("output", _U + _REPORT, (("out.tsv", "golden_output.tsv"),
                                        ("rep.tsv", "golden_report.tsv")),
               True),
    *(_tsv(f"k{k}", _U + ("-k", str(k)), True) for k in (1, 3, 20)),
    _tsv("minhit16", _U + ("--min-hitlen", "16"), True),
    _tsv("notraverse", _U + ("--no-traverse",), False),
    _tsv("host100", _U + ("--host-taxids", "100"), False),
    _tsv("excl", _U + ("--exclude-taxids", "1000,1001"), False),
    _tsv("rankgenus", _U + ("--classification-rank", "genus"), False),
    _tsv("nofw", _U + ("--nofw", "--norc"), True),
    ParityCase("paired", _P + _REPORT,
               (("out.tsv", "golden_paired.tsv"),
                ("rep.tsv", "golden_paired_report.tsv")), True),
    _tsv("paired_k1", _P + ("-k", "1"), True),
    _tsv("qseq", ("--qseq", "-U", "{fx}/reads.qseq"), False),
    _tsv("raw", ("-r", "-U", "{fx}/reads.raw"), False),
    _tsv("sample50", _U + ("--sample", "0.5"), False),
    _tsv("sample50_u1500", _U + ("--sample", "0.5", "-u", "1500"), False),
    _tsv("nceil", ("-U", "{fx}/reads_n.fq", "--n-ceil", "L,0,0.02"), True),
    _tsv("nceil_c3", ("-U", "{fx}/reads_n.fq", "--n-ceil", "C,3"), True),
    _tsv("qcfilter", ("--qseq", "-U", "{fx}/reads_filter.qseq",
                      "--qc-filter"), True),
    _tsv("tab12_mixed", ("--12", "{fx}/reads_mixed.tab"), True),
    _tsv("cols", _U + ("-u", "300", "--tab-fmt-cols",
                       "readID,taxID,taxRank,taxName,score,readSeq"), False),
    _tsv("paired_seqcols", _P + ("--tab-fmt-cols",
                                 "readID,seqID,taxID,score,readSeq,readQual"),
         False),
    _tsv("trim", _U + ("-5", "5", "-3", "7"), True),
    *(_tsv(enc, (flag, "-U", f"{{fx}}/reads_{enc}.fq", "--tab-fmt-cols",
                 QUAL_COLS), False)
      for enc, flag in (("phred64", "--phred64"),
                        ("solexa", "--solexa-quals"),
                        ("intq", "--int-quals"))),
    ParityCase("tee", _U + ("--un", "{td}/un.fq", "--al", "{td}/al.fq")
               + _NO_REPORT, (("out.tsv", "golden_output.tsv"),
                              ("un.fq", "golden_tee_un.fq"),
                              ("al.fq", "golden_tee_al.fq")), False),
    ParityCase("tee_conc", _P + ("--al-conc", "{td}/alc.fq",
                                 "--un-conc-gz", "{td}/unc.fq.gz")
               + _NO_REPORT, (("out.tsv", "golden_paired.tsv"),
                              ("alc.1.fq", "golden_tee_alc.1.fq"),
                              ("alc.2.fq", "golden_tee_alc.2.fq"),
                              ("unc.fq.1.gz", None)), False),
    ParityCase("nfail_paired", None,
               (("out.tsv", "golden_nfail_paired.tsv"),), True),
    ParityCase("example", ("-f", "-U", "{fx}/reads.fa") + _REPORT,
               (("out.tsv", "golden_output.tsv"),
                ("rep.tsv", "golden_report.tsv"),
                ("<stderr>", "golden_stderr.txt")), False, "example"),
)
# the routes through the kernels: (layout, host_resolve). a: the CLI as
# a user runs it (K1; K0 and K4 at load on a deep index); b: the device
# resolve (K1, K5 and K3 in each dispatch, the tail's K3 and first-hit
# K1); c: the wide layout forced (every kernel's int64 rows); d: a (1, 2)
# mesh (K6's search, and its walk on the device resolve)
PARITY_ROUTES = {"a": ("narrow", True), "b": ("narrow", False),
                 "c-host": ("wide", True), "c-device": ("wide", False),
                 "d-host": ("mesh", True), "d-device": ("mesh", False)}
PARITY_MESH = (1, 2)


def parity_pipe(m, route: str, shared: dict, made: list, device):
    """A stand-in for the classify CLI's GPUClassificationPipeline(idx,
    cfg, device=...) (cli/classify.py) that builds the same class on one
    route: cfg's host_resolve set by the route, the index shared through
    `shared` (one DeviceFMIndex a layout and one ShardedFMArrays an
    index, built at first use). Each pipeline made is appended to
    `made`."""
    layout, host_resolve = PARITY_ROUTES[route]

    def make(idx, cfg=None, device=device):
        cfg = dataclasses.replace(cfg or m["Cfg"](),
                                  host_resolve=host_resolve)
        key = (layout, idx.bwt_len)
        if layout == "mesh":
            if key not in shared:
                shared[key] = m["sharded"].ShardedFMArrays.build(
                    idx, PARITY_MESH[1])
            pipe = m["Pipe"](idx, cfg, device=device, sharded=shared[key],
                             mesh=m["sharded"].make_mesh(
                                 *PARITY_MESH,
                                 [device] * math.prod(PARITY_MESH)))
        else:
            if key not in shared:
                shared[key] = m["fm_torch"].DeviceFMIndex.build(
                    idx, device=device, wide=layout == "wide")
            pipe = m["Pipe"](idx, cfg, device=device, dfm=shared[key])
        made.append(pipe)
        return pipe

    return make


def _first_diff(got: bytes, want: bytes) -> str:
    a, b = got.splitlines(), want.splitlines()
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return (f"line {i + 1}: {a[i] if i < len(a) else b'<end>'!r} vs "
            f"{b[i] if i < len(b) else b'<end>'!r}")


def _route_fault(route: str, made: list) -> Optional[str]:
    """What a route's pipelines did not run as the route says: the host
    walk (HostResolver) on the host resolve and never on the device
    resolve, the wide layout, the mesh."""
    layout, host_resolve = PARITY_ROUTES[route]
    if not made:
        return "the CLI made no pipeline"
    for p in made:
        host = type(p.resolver).__name__ == "HostResolver"
        if host != host_resolve:
            return f"resolver {type(p.resolver).__name__}"
        if (getattr(p, "mesh_index", None) is not None) != (
                layout == "mesh"):
            return "mesh"
        wide = p.mesh_index.wide if layout == "mesh" else p.dfm.wide
        if wide != (layout == "wide"):
            return f"wide={wide}"
    return None


def run_parity_case(m, case: ParityCase, route: str, shared: dict, device,
                    td: str) -> Optional[str]:
    """Run one case on one route in directory td: None when every output
    equals its golden byte for byte, else the first difference. The CLI
    runs in this process with parity_pipe standing in for its
    GPUClassificationPipeline."""
    fx = os.path.join(REPO, "tests", "fixtures", case.fixture)
    made = []
    make = parity_pipe(m, route, shared, made, device)
    idx_base = os.path.join(fx, PARITY_INDEX[case.fixture])
    what = f"{case.name} on route {route}"
    if case.argv is None:
        return _nfail_paired(m, fx, idx_base, make, device, made, route,
                             what)
    argv = ["-x", idx_base, "-S", os.path.join(td, "out.tsv"),
            "--device", str(device)] + [a.format(fx=fx, td=td)
                                        for a in case.argv]
    gp = m["gpu_pipeline"]
    real, err = gp.GPUClassificationPipeline, io.StringIO()
    gp.GPUClassificationPipeline = make
    try:
        with contextlib.redirect_stderr(err):
            rc = m["cli"].run(argv)
    finally:
        gp.GPUClassificationPipeline = real
    if rc:
        return f"{what}: exit {rc}: {err.getvalue()[-1000:]}"
    fault = _route_fault(route, made)
    if fault:
        return f"{what}: the route did not run as set ({fault})"
    for name, gold in case.goldens:
        want = b""
        if gold is not None:
            with open(os.path.join(fx, gold), "rb") as f:
                want = f.read()
        if name == "<stderr>":
            # the EM lines; the first names the report path given
            got = err.getvalue().encode().splitlines(True)[:4]
            lines = want.splitlines(True)
            want = b"".join([f"report file {td}/rep.tsv\n".encode()]
                            + lines[1:4])
            got = b"".join(got)
        else:
            opener = gzip.open if name.endswith(".gz") else open
            with opener(os.path.join(td, name), "rb") as f:
                got = f.read()
        if got != want:
            return f"{what}: {name} differs from {gold}: " \
                   + _first_diff(got, want)
    return None


def _nfail_paired(m, fx, idx_base, make, device, made, route, what):
    """Case nfail_paired at the pipeline level, as the JAX test runs it:
    pairs whose mate 1 fails the N filter at k 20, with the native
    assigner and with the host pipeline's (use_native False)."""
    idx = m["load_cf_index"](idx_base)
    pairs = list(zip(m["read_batch"]([f"{fx}/reads_nfail_1.fq"]),
                     m["read_batch"]([f"{fx}/reads_nfail_2.fq"])))
    with open(f"{fx}/golden_nfail_paired.tsv", "rb") as f:
        want = f.read().split(b"\n", 1)[1]
    for native in (True, False):
        cfg = m["Cfg"](classifier=m["ClsCfg"](khits=20), use_native=native)
        pipe = make(idx, cfg, device=device)
        if (pipe.native is not None) != native:
            return f"{what}: use_native={native} made no such assigner"
        got = "".join(r + "\n" for r in pipe.classify_batch_paired(pairs))
        if got.encode() != want:
            return f"{what} (use_native={native}): " \
                   + _first_diff(got.encode(), want)
    return _route_fault(route, made)


def load_port():
    """Import what the run needs: the port, torch and numpy only."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from centrifuge_tpu_torch import _cuda
    from centrifuge_tpu_torch.classify import engine, gpu_pipeline
    from centrifuge_tpu_torch.classify.algo import ClassifierConfig
    from centrifuge_tpu_torch.classify.gpu_pipeline import \
        GPUClassificationPipeline
    from centrifuge_tpu_torch.classify.pipeline import (
        ClassificationPipeline, PipelineConfig)
    from centrifuge_tpu_torch.cli import classify as cli
    from centrifuge_tpu_torch import __main__ as tools
    from centrifuge_tpu_torch import graft_entry
    from centrifuge_tpu_torch.evaluation import (bigdb, prof, simulate,
                                                 tile_sweep, wide_table,
                                                 widebench)
    from centrifuge_tpu_torch.index.cf_io import load_cf_index
    from centrifuge_tpu_torch.io.fastx import read_batch, read_fastx
    from centrifuge_tpu_torch.ops import fm_torch, rank
    from centrifuge_tpu_torch.ops.fm_numpy import FMOracle
    from centrifuge_tpu_torch.parallel import (scaling_bench, shardbench,
                                               sharded, shardscale)
    from centrifuge_tpu_torch.report.writers import write_report
    from centrifuge_tpu_torch.utils.fallback import fallbacks
    return dict(np=np, torch=torch, cuda=_cuda, engine=engine,
                gpu_pipeline=gpu_pipeline,
                sharded=sharded,
                Pipe=GPUClassificationPipeline,
                OraclePipe=ClassificationPipeline, Cfg=PipelineConfig,
                cli=cli, bigdb=bigdb, tile_sweep=tile_sweep, tools=tools,
                graft_entry=graft_entry,
                prof=prof, simulate=simulate, wide_table=wide_table,
                widebench=widebench,
                shardbench=shardbench,
                shardscale=shardscale, scaling_bench=scaling_bench,
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

    def pool_equal(self, what: str, args, budget: int, want) -> int:
        """K1 in pool mode on search_lanes' args, with `budget` records in
        the first part of its buffer, against the padded outputs `want`
        of the plain version: the pool through HitPool equals them slot
        for slot (the card writes the lanes' records in the order lanes
        end). Returns the records written."""
        eng_mod, torch = self.m["engine"], self.torch
        L, mh = args[1].shape[0], args[4]
        buf = eng_mod.search_lanes(*args, pool_budget=budget)[0]
        pool = eng_mod.HitPool.of_buffer(buf.cpu().numpy(), L, mh, budget)
        self.equal(what, [torch.from_numpy(a) for a in pool.expand()],
                   [w.cpu() for w in want])
        return pool.records.shape[0]

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

    def stream(self, idx, batches, host_resolve: bool, dfm=None, cfg=None,
               paired=False):
        """A fresh pipeline (on dfm, else building the index) streaming
        the batches (of pairs, with paired), launch counts from 0 before
        it is built: (pipe, rows, build seconds, stream seconds,
        launches). cfg: the PipelineConfig (default: the default one);
        its host_resolve is set."""
        m, torch = self.m, self.torch
        cfg = dataclasses.replace(cfg or m["Cfg"](),
                                  host_resolve=host_resolve)
        m["cuda"].reset_launches()
        t0 = time.perf_counter()
        pipe = m["Pipe"](idx, cfg, device=self.dev, dfm=dfm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = []
        run = pipe.classify_stream_paired if paired \
            else pipe.classify_stream_unpaired
        for chunk in run(batches):
            rows += chunk
        t2 = time.perf_counter()
        return pipe, rows, t1 - t0, t2 - t1, dict(m["cuda"].LAUNCHES)

    def oracle_check(self, what: str, idx, items, rows, cfg=None,
                     paired=False) -> int:
        """Fail unless a stream's rows begin with the host oracle's
        (ClassificationPipeline + FMOracle, under cfg) for the first
        ORACLE_READS reads or pairs of items; returns the rows compared."""
        m = self.m
        orc = m["OraclePipe"](idx, m["FMOracle"](idx), cfg or m["Cfg"]())
        want = []
        for it in items[:ORACLE_READS]:
            want += orc.classify_paired(*it) if paired \
                else orc.classify_unpaired(it)
        if rows[: len(want)] != want:
            bad = next((i for i, (a, b) in enumerate(zip(rows, want))
                        if a != b), min(len(rows), len(want)))
            fail(f"{what}: oracle mismatch at row {bad}: "
                 f"{rows[bad] if bad < len(rows) else None!r} vs "
                 f"{want[bad]!r}")
        return len(want)

    @staticmethod
    def same_rows(what: str, got, want) -> None:
        if got != want:
            bad = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            fail(f"{what} stream differs from the host-resolve stream at "
                 f"row {bad}: {got[bad] if bad < len(got) else None!r} vs "
                 f"{want[bad] if bad < len(want) else None!r}")

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
                        # pool mode (narrow): the batch's budget of 8
                        # records a lane, and 1 a lane (a spill)
                        for per in (() if wide else (8, 1)):
                            self.pool_equal(
                                f"search pool {name} deep={deep} "
                                f"mhl={mhl} budget={per}/lane", args,
                                per * len(seqs), want)
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

    def wide_scale(self) -> None:
        """Every kernel past 2^31 rows, on a wide table of
        2^31 + 2^20 + 7 rows made on the card from a seed
        (evaluation/wide_table.py random_wide_index: random BWT words, the
        occ, fchr and depth-10 ftab counted from them by the plain
        versions, '$' among the last 2^20 rows) and reads walked back
        through it by LF (walk_reads), each kernel against its plain
        version, exact integer equality: K4's depth-12 build; K0's level
        1 on the 2^20 depth-10 ranges and its generic entry on 65,536
        (row, char) pairs with the edge rows; K3 on 65,536 rows below and
        past 2^31 and the edge rows at the full budget and max_steps=1; K1
        on the reads' lanes, deep or not, min_hitlen 16 and 22; K5 then K3
        on their hit buffers; K6's search and walk on a (1, 2) mesh of
        cuda:0, whose second shard starts past 2^30 rows, also against K1
        and K3. The table is freed at the end."""
        torch = self.torch
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        line = self.wide_checks()
        line.update(
            max_memory_allocated=int(torch.cuda.max_memory_allocated()),
            seconds=round(time.perf_counter() - t0, 3))
        torch.cuda.empty_cache()     # the table went with wide_checks
        emit(line)

    def wide_checks(self) -> dict:
        """wide_scale's checks; returns its line."""
        m, torch, np = self.m, self.torch, self.np
        wt, fmt, rk, eng_mod, shd = (m["wide_table"], m["fm_torch"],
                                     m["rank"], m["engine"], m["sharded"])
        n = wt.WIDE_SCALE_LEN
        fm, gen_s = self.time_host(lambda: wt.random_wide_index(
            n, WIDE_SEED, self.dev))
        if fm.zoff < (1 << 31) or fm.boundary_rows[-1] < (1 << 31):
            fail(f"wide_scale: '$' at {fm.zoff} or the last boundary row "
                 "below 2^31")
        checks = []

        def equal(what, got, want):
            self.equal(f"wide_scale {what}", got, want)
            checks.append(what)

        # K4 (after K0's level 1): the depth-12 ftab the deep search reads
        t0v, b0v = fm.ftab_top[:fmt.N10], fm.ftab_bot[:fmt.N10]
        fm.ftab12_rows = torch.zeros((fmt.N12 // 8, 40), dtype=torch.int32,
                                     device=self.dev)
        fmt.build_ftab12(fm.blocks, fm.fchr, fm.zoff, t0v, b0v,
                         fm.ftab12_rows)
        plain = torch.zeros_like(fm.ftab12_rows)
        fmt.ftab12_plain(fm.blocks, fm.fchr, fm.zoff, t0v, b0v, plain)
        equal("ftab12", [fm.ftab12_rows], [plain])
        del plain
        l1 = (fm.blocks, fm.fchr, fm.zoff, t0v, b0v)
        equal("level 1", list(rk.level1(*l1)), list(rk.level1_plain(*l1)))
        # K0's generic entry: the edges, then random rows below and past
        g = np.random.default_rng(WIDE_SEED)
        edges = [0, (1 << 31) - 1, 1 << 31, fm.zoff, fm.zoff + 1, n - 1, n]
        half = (WIDE_ROWS - len(edges)) // 2
        rows = np.concatenate([edges, g.integers(0, 1 << 31, half),
                               g.integers(1 << 31, n + 1,
                                          WIDE_ROWS - len(edges) - half)])
        rows = torch.from_numpy(rows.astype(np.int64)).to(self.dev)
        chars = torch.from_numpy(g.integers(0, 4, WIDE_ROWS).astype(
            np.int32)).to(self.dev)
        want = rk.rank_plain(fm.blocks, fm.zoff, rows, chars)
        equal("rank", [rk.rank(fm.blocks, fm.zoff, rows, chars)], [want])
        equal("lf", [rk.lf(fm.blocks, fm.fchr, fm.zoff, rows, chars)],
              [fm.fchr[chars.to(torch.int64)] + want])
        # K3: the edge rows (no row n: rows index the table), the boundary
        # rows, random rows below and past 2^31
        br = fm.boundary_rows.cpu().numpy()
        qrows = np.concatenate([edges[:-1], br, g.integers(0, 1 << 31, half),
                                g.integers(1 << 31, n, WIDE_ROWS - half)])
        qrows = torch.from_numpy(qrows.astype(np.int64)).to(self.dev)
        k3 = {}
        for steps in (fmt.RESOLVE_MAX_STEPS, 1):
            k3[steps] = fmt.resolve_rows(fm, qrows, steps)
            equal(f"resolve max_steps={steps}", [k3[steps]],
                  [fmt.resolve_rows_plain(fm, qrows, steps)])
        # K1 on the walked reads' lanes (each read and its reverse
        # complement), K5 then K3 on the deep min_hitlen-22 hit buffers
        codes = wt.walk_reads(fm, WIDE_READS, WIDE_READ_LEN, WIDE_SEED)
        seqs = [s for r in codes for s in (r, (3 - r[::-1]).astype(np.uint8))]
        hits = None
        for deep in (False, True):
            for mhl in (16, 22):
                eng = eng_mod.BatchSearchEngine(fm, mhl)
                reads, lens, st, lmax = self.packed_lanes(eng, seqs)
                args = (fm, reads, lens, st, SEARCH_MH, mhl, eng.increment,
                        False, deep)
                got = eng_mod.search_lanes(*args)
                equal(f"search deep={deep} mhl={mhl}", got,
                      eng_mod.search_plain(*args))
                if deep and mhl == 22:
                    hits = got
        longest = int(hits[3].max())
        if longest < WIDE_READ_LEN // 2:
            fail(f"wide_scale: the longest hit is {longest} bases")
        for khits in (5, 16):
            pre = (fm, hits[0], hits[1], hits[3], khits,
                   m["ClsCfg"](khits=khits).ihits(False), 22,
                   eng_mod.presolve_rk(khits))
            equal(f"presolve khits={khits}", list(eng_mod.presolve_lanes(*pre)),
                  list(eng_mod.presolve_plain(*pre)))
        # K6 on a (1, 2) mesh of cuda:0: its shards' tables split at
        # nblk_per block rows, past 2^30 rows
        index = shd.MeshIndex(shd.ShardedFMArrays.from_device_index(fm, 2),
                              self.mesh(1, 2))
        bases = [512 * s.blk_base for s in index.rows[0].shards]
        if bases[1] < (1 << 30):
            fail(f"wide_scale: the second shard starts at row {bases[1]}")
        eng = shd.ShardedSearchEngine(index)
        reads, lens, st, _ = self.packed_lanes(eng, seqs)
        args = (reads, lens, st, SEARCH_MH, 22, eng.increment, False)
        got = shd.sharded_search(index, *args)
        equal("sharded search", got, shd.sharded_search_plain(index, *args))
        equal("sharded search vs K1", got,
              eng_mod.search_lanes(fm, *args, False))
        for steps in (shd.SHARDED_RESOLVE_MAX_STEPS, 1):
            got = shd.sharded_resolve(index, qrows, steps)
            equal(f"sharded resolve max_steps={steps}", [got],
                  [shd.sharded_resolve_plain(index, qrows, steps)])
        equal("sharded resolve vs K3", [shd.sharded_resolve(index, qrows)],
              [k3[fmt.RESOLVE_MAX_STEPS]])
        return dict(
            phase="wide_scale", bwt_len=n, zoff=fm.zoff,
            boundary_rows=br.tolist(), generate_s=round(gen_s / 1e3, 3),
            blocks_bytes=fm.blocks.nbytes, samples_bytes=fm.offs.nbytes,
            ftab12_bytes=fm.ftab12_rows.nbytes, reads=WIDE_READS,
            read_len=WIDE_READ_LEN, lanes=len(seqs), longest_hit=longest,
            rows=WIDE_ROWS, shard_base_rows=bases, checks=checks,
            result="every kernel equal to its plain version")

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

    def entry_kernel_ms(self, fm, args, outs, reps: int) -> float:
        """ms per launch of K1 alone on graft_entry.entry()'s lanes, by
        CUDA events over a CUDA graph of `reps` launches through its C
        entry, each on its own zeroed work counter (as the wrapper calls
        it, without the wrapper's checks and allocation); the outputs
        must equal outs."""
        torch, cuda, ge = self.torch, self.m["cuda"], self.m["graft_entry"]
        reads, lengths, start = args[4:]
        lib = cuda.lib("search")
        fn = lib.fm_search_wide if fm.wide else lib.fm_search_narrow
        res = [torch.empty_like(o) for o in outs]
        counters = torch.zeros((reps, 1), dtype=torch.int32, device=self.dev)

        def launches():
            counters.zero_()
            for k in range(reps):
                cuda.check(fn(
                    fm.blocks.data_ptr(), fm.fchr.data_ptr(), int(fm.zoff),
                    fm.ftab_rows.data_ptr(), None, reads.data_ptr(),
                    reads.shape[1], lengths.data_ptr(), start.data_ptr(),
                    *[r.data_ptr() for r in res], reads.shape[0],
                    ge.MAX_HITS, ge.MIN_HITLEN, ge.INCREMENT, 0, 0,
                    counters[k].data_ptr(), cuda.stream_ptr(self.dev)),
                    "search kernel")

        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            launches()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launches()
        ms = self.time_cuda(graph.replay, 3) / reps
        self.equal("entry() (K1 alone)", res, outs)
        return ms

    def graft_entry(self) -> None:
        """The port's entry points: entry()'s K1 call once on the card
        (one launch) against the same call on its arguments moved to the
        CPU (search_plain), then timed; dryrun_multichip with the default
        devices and over meshes of GRAFT_MESH_SIZES entries of cuda:0,
        launch counts from 0 before each; the module as python -m runs
        it."""
        m, torch, np = self.m, self.torch, self.np
        cuda, ge = m["cuda"], m["graft_entry"]
        t_phase = time.perf_counter()
        fn, args = ge.entry()
        cuda.reset_launches()
        got = fn(*args)
        torch.cuda.synchronize()
        search = cuda.LAUNCHES["search"]
        if search != 1:
            fail(f"entry(): {search} K1 launches, not 1")
        cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args]
        t0 = time.perf_counter()
        want = fn(*cpu_args)          # CPU tensors: search_plain
        plain_ms = (time.perf_counter() - t0) * 1e3
        if cuda.LAUNCHES["search"] != 1:
            fail("entry()'s plain call launched K1")
        err = self.equal("entry() (K1)", [g.cpu() for g in got], want)
        # the same call on the card's tensors with the lookups recorded,
        # for the bound; then the kernel alone
        fm = m["fm_torch"].DeviceFMIndex.build(m["load_cf_index"](SYN),
                                               device=self.dev)
        stats = {}
        plain = m["engine"].search_plain(fm, *args[4:], ge.MAX_HITS,
                                         ge.MIN_HITLEN, ge.INCREMENT, False,
                                         False, stats=stats)
        self.equal("entry() (K1, plain on the card)", got, plain)
        nbytes, int_ops, popc = self.traffic(fm, stats)
        io = sum(t.numel() * t.element_size()
                 for t in list(args[4:]) + got + [fm.fchr])
        bound = self.bound(nbytes + io, int_ops, popc)
        kernel_ms = self.entry_kernel_ms(fm, args, got, GRAFT_REPS)
        fn(*args)
        ms = []
        for _ in range(GRAFT_REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        runs = []
        for n, devices in [(self.count, None)] + [
                (k, [str(self.dev)] * k) for k in GRAFT_MESH_SIZES]:
            what = f"dryrun_multichip({n}, devices=" + (
                "None)" if devices is None else f"[{self.dev}] * {n})")
            cuda.reset_launches()
            t0 = time.perf_counter()
            try:
                ge.dryrun_multichip(n, devices=devices)
            except AssertionError as e:
                fail(f"{what}: {e}")
            secs = time.perf_counter() - t0
            launches = dict(cuda.LAUNCHES)
            self.check_path(what, launches, MESH_HOST_PATH,
                            absent=("sharded_resolve",))
            n_fm = 2 if n % 2 == 0 else 1
            runs.append(dict(call=what, mesh=[n // n_fm, n_fm],
                             rows="equal to the golden rows",
                             sharded_search=launches["sharded_search"],
                             search=launches["search"],
                             seconds=round(secs, 3)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "centrifuge_tpu_torch.graft_entry"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        mod_s = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        if proc.returncode or "entry ok" not in lines \
                or "dryrun ok" not in lines:
            fail(f"python -m centrifuge_tpu_torch.graft_entry: exit "
                 f"{proc.returncode}, {lines}: {proc.stderr[-2000:]}")
        emit(dict(phase="graft_entry", lanes=int(args[4].shape[0]),
                  entry=dict(outputs="equal to search_plain on the CPU",
                             max_abs_err=err, search_launches=search,
                             k1_ms_median=float(np.median(ms)),
                             k1_ms_min=min(ms), reps=GRAFT_REPS,
                             kernel_alone_ms=kernel_ms, plain_ms=plain_ms,
                             lockstep_steps=len(stats.get("bwt_rows", [])),
                             **bound),
                  dryruns=runs,
                  module=dict(rc=proc.returncode, lines=lines,
                              seconds=round(mod_s, 3)),
                  card=self.smi,
                  seconds=round(time.perf_counter() - t_phase, 3)))

    def bench(self) -> None:
        """python -m centrifuge_tpu_torch.bench with one trial of each
        stream, its last line held to the bench's gate."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "centrifuge_tpu_torch.bench",
             "--trials", "1"], cwd=REPO,
            capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        secs = time.perf_counter() - t0
        out = proc.stdout.splitlines()
        try:
            line = json.loads(out[-1])
        except (IndexError, ValueError):
            fail(f"bench: exit {proc.returncode}, no result line: "
                 f"{out[-5:]} {proc.stderr[-2000:]}")
        checks = {"exit code": proc.returncode == 0,
                  "parity_ok": line.get("parity_ok") is True,
                  "native_ok": line.get("native_ok") is True,
                  "device": line.get("device") == "cuda",
                  "K1 launches": line.get("launches", {}).get("search", 0) > 0}
        for k in ("value", "paired_pairs_per_sec",
                  "device_search_ms_per_batch"):
            checks[k] = (line.get(k) or 0) > 0
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"bench: {', '.join(bad)} wrong: {json.dumps(line)} "
                 f"{proc.stderr[-2000:]}")
        emit(dict(phase="bench", seconds=round(secs, 3), line=line,
                  log=out[:-1]))

    def multihost(self) -> None:
        """Two processes on cuda:0, joined by gloo for the host scalars,
        each classifying its half of the synth reads over a (1, 2) wide
        mesh (parallel/multihost.py); the merged rows equal the golden
        rows."""
        t0 = time.perf_counter()
        launches, merged = self.processes(
            2, lambda pid, port, out: [
                sys.executable, "-c", MULTIHOST_WORKER, REPO, str(pid), "2",
                str(port), out, str(self.dev)], "multihost worker")
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
        recs = m["read_batch"]([os.path.join(CACHE, BIGDB_READS)])
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
        nrows = self.oracle_check("full", idx, recs, rows)
        emit(dict(phase="full_oracle", reads=ORACLE_READS,
                  rows=nrows, result="byte-equal",
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
        # the main path's pool mode, as the engine sizes it: the row's ms
        L = len(seqs)
        budget = eng._pool_budget(L, lmax, False, SEARCH_MH)
        if not budget:
            fail("the full batch's search does not take pool mode")
        records = self.pool_equal("search pool (full batch)", args, budget,
                                  want)
        ms = self.time_cuda(
            lambda: eng_mod.search_lanes(*args, pool_budget=budget), 5)
        padded_ms = self.time_cuda(lambda: eng_mod.search_lanes(*args), 5)
        stats = {}
        eng_mod.search_plain(*args, stats=stats)
        nbytes, int_ops, popc = self.traffic(fm, stats)
        # the plain lockstep loop's steps: its longest lane's chain
        longest = len(stats.get("bwt_rows", []))
        del stats
        rsz = fm.fchr.element_size()
        # reads, lengths and starts in; the pool's records (12 bytes
        # each), each lane's base and tail out
        io = (reads.numel() + 8 * L + 12 * records + 8 * L
              + fm.fchr.numel() * rsz)
        self.rows["search"].update(
            launches=launches["search"], max_abs_err=err, ms=ms,
            padded_ms=padded_ms, pool_records=records,
            pool_budget=budget, plain_ms=plain_ms, library_ms=None,
            lanes=L,
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
        # what full_sharded runs again over the mesh, and prof profiles
        self.full_state = dict(idx=idx, fm=fm, batches=batches, rows=rows,
                               hits=[t.clone() for t in got], flat=flat,
                               tidx=tidx, base=base, header=pipe.formatter
                               .header())

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

    def parity(self) -> None:
        """The reference's parity surface on the card: every case of
        PARITY_CASES through the classify CLI on every route of
        PARITY_ROUTES (parity_pipe standing in for the pipeline the CLI
        builds), launch counts from 0 before each route, then the 256 Mbp
        configurations (parity_full)."""
        m, cuda = self.m, self.m["cuda"]
        t_phase = time.perf_counter()
        shared = {}
        for route, (layout, host_resolve) in PARITY_ROUTES.items():
            cuda.reset_launches()
            t0 = time.perf_counter()
            faults = []
            for case in PARITY_CASES:
                with tempfile.TemporaryDirectory() as td:
                    fault = run_parity_case(m, case, route, shared, self.dev,
                                            td)
                if fault:
                    faults.append(fault)
            launches = dict(cuda.LAUNCHES)
            emit(dict(phase="parity", route=route, layout=layout,
                      resolve="host" if host_resolve else "device",
                      cases=len(PARITY_CASES),
                      equal=len(PARITY_CASES) - len(faults),
                      seconds=round(time.perf_counter() - t0, 3),
                      launches=launches))
            if faults:
                fail(f"{len(faults)} parity cases differ; first: "
                     f"{faults[0]}")
            if layout == "mesh":
                path, absent = (MESH_HOST_PATH, ("sharded_resolve",)) \
                    if host_resolve else (MESH_DEVICE_PATH, ())
            else:
                path, absent = (("search",), ("presolve", "resolve")) \
                    if host_resolve else (DEVICE_RESOLVE_PATH, ())
            self.check_path(f"parity route {route}", launches, path, absent)
        self.parity_full()
        emit(dict(phase="parity", route="all", card=self.smi,
                  seconds=round(time.perf_counter() - t_phase, 3)))

    def parity_full(self) -> None:
        """The 256 Mbp database of `full` at each PARITY_FULL setting, its
        99,968 reads streamed on the host and then the device resolve,
        and PARITY_PAIRS pairs simulated from its genomes at k 1 the same
        way: the two streams byte-equal, and their first ORACLE_READS
        reads or pairs equal to the host oracle's under the same
        settings."""
        m, st = self.m, self.full_state
        idx, fm, batches = st["idx"], st["fm"], st["batches"]
        recs = [r for b in batches for r in b]
        prefix, npairs, seed = PARITY_PAIRS
        pfx = os.path.join(CACHE, prefix)
        if not os.path.exists(pfx + "_2.fq"):
            sim = m["simulate"]
            sim.simulate(os.path.join(CACHE, "bigdb.fa"),
                         os.path.join(CACHE, "conv.dmp"), pfx,
                         sim.SimConfig(num_fragments=npairs, read_length=100,
                                       paired=True, error_rate=0.002,
                                       seed=seed))
        pairs = list(zip(m["read_fastx"](pfx + "_1.fq"),
                         m["read_fastx"](pfx + "_2.fq")))
        if len(pairs) != npairs:
            fail(f"simulated {len(pairs)} pairs, not {npairs}")
        runs = [(name, kw, batches, recs, False) for name, kw in PARITY_FULL]
        runs.append(("paired_k1", dict(khits=1),
                     [pairs[i: i + PARITY_PAIRS_BATCH]
                      for i in range(0, npairs, PARITY_PAIRS_BATCH)],
                     pairs, True))
        for name, kw, items, flat, paired in runs:
            cfg = m["Cfg"](classifier=m["ClsCfg"](**kw))
            rates, launches, host_rows = [], [], None
            for hr in (True, False):
                _, rows, _, secs, ln = self.stream(idx, items, hr, fm, cfg,
                                                   paired)
                if hr:
                    self.check_path(f"parity {name} host-resolve", ln,
                                    ("search",),
                                    absent=("presolve", "resolve"))
                    host_rows = rows
                else:
                    self.check_path(f"parity {name} device-resolve", ln,
                                    DEVICE_RESOLVE_PATH)
                    self.same_rows(f"parity {name} device-resolve", rows,
                                   host_rows)
                rates.append(len(flat) / secs)
                launches.append(ln)
            t0 = time.perf_counter()
            nrows = self.oracle_check(f"parity {name}", idx, flat, host_rows,
                                      cfg, paired)
            emit(dict(phase="parity_full", config=name,
                      classifier=kw, bases=int(idx.bwt_len),
                      **{"pairs" if paired else "reads": len(flat)},
                      rows=len(host_rows),
                      device_resolve="byte-equal to the host-resolve stream",
                      oracle=f"first {ORACLE_READS} byte-equal ({nrows} rows)",
                      oracle_s=round(time.perf_counter() - t0, 3),
                      **{("pairs" if paired else "reads") + "_per_s":
                         [round(r, 1) for r in rates]},
                      resolve=["host", "device"], launches=launches))

    def tool(self, argv, stdin=None) -> str:
        """stdout of `python -m centrifuge_tpu_torch argv`, run in this
        process through the port's __main__ table; stdin: a fixture file
        fed on standard input. Fails on a nonzero exit."""
        out = io.StringIO()
        old_stdin = sys.stdin
        try:
            if stdin is not None:
                with open(os.path.join(FIX, stdin)) as f:
                    sys.stdin = io.StringIO(f.read())
            with contextlib.redirect_stdout(out):
                rc = self.m["tools"].run(argv)
        finally:
            sys.stdin = old_stdin
        if rc:
            fail(f"{' '.join(argv[:2])}: exit {rc}")
        return out.getvalue()

    def tools(self) -> None:
        """The tool table on the synth fixture: build byte-equal to the
        fixture index; inspect, kreport and promote byte-equal to the
        goldens; simulate, classify on the card in a process of its own,
        evaluate."""
        t0 = time.perf_counter()

        def fx(name):
            return os.path.join(FIX, name)

        out = {}
        with tempfile.TemporaryDirectory() as td:
            base = os.path.join(td, "synth")
            self.tool(["build", "--conversion-table", fx("conv.dmp"),
                       "--taxonomy-tree", fx("nodes.dmp"), "--name-table",
                       fx("names.dmp"), "-q", fx("db.fa"), base])
            for ext in ("1", "2", "3", "4"):
                with open(f"{base}.{ext}.cf", "rb") as a, \
                        open(f"{SYN}.{ext}.cf", "rb") as b:
                    if a.read() != b.read():
                        fail(f"build: {ext}.cf differs from the fixture")
            out["build"] = "byte-equal to synth.{1..4}.cf"
            for argv, stdin, gold in TOOL_GOLDENS:
                self.same_golden(self.tool(argv, stdin), gold,
                                 " ".join(argv[:-1]))
                out.setdefault(argv[0], []).append(gold)
            sim = os.path.join(td, "sim")
            self.tool(["simulate", "-x", fx("db.fa"), "--conversion-table",
                       fx("conv.dmp"), "-o", sim, "--num", str(SIM_READS),
                       "--seed", "7"])
            tsv, counts = (os.path.join(td, f) for f in ("sim.tsv",
                                                         "counts.json"))
            proc = subprocess.run(
                [sys.executable, "-c", TOOLS_WORKER, REPO, counts,
                 "classify", "-x", SYN, "-U", sim + ".fq", "-S", tsv,
                 "--report-file", "", "--device", str(self.dev)],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode:
                fail(f"python -m centrifuge_tpu_torch classify: exit "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            with open(counts) as f:
                launches = json.load(f)
            self.check_path("tools classify", launches, ("search",),
                            absent=("presolve", "resolve"))
            lines = self.tool(["evaluate", "-x", SYN, "--truth",
                               sim + ".truth", tsv]).splitlines()
        if [ln.split("\t")[0] for ln in lines] != EVAL_LINES:
            fail(f"evaluate printed {lines}")
        emit(dict(phase="tools", **out, simulate_reads=SIM_READS,
                  classify="python -m centrifuge_tpu_torch classify "
                           f"--device {self.dev}",
                  classify_launches=launches, evaluate=lines,
                  seconds=round(time.perf_counter() - t0, 3)))

    def prof(self) -> None:
        """evaluation/prof.py on the 256 Mbp index and full batches of
        `full`, host and device resolve, launch counts from 0 before
        each: one JSON line each. It checks that every key is there and
        the device timings were measured, nothing numeric."""
        m, st = self.m, self.full_state
        batches = [b for b in st["batches"] if len(b) == BATCH_READS]
        for hr in (True, False):
            path = "host" if hr else "device"
            m["cuda"].reset_launches()
            t0 = time.perf_counter()
            art = m["prof"].profile(
                st["idx"], batches, host_resolve=hr, device=self.dev,
                dfm=st["fm"], runs=PROF_RUNS,
                log=lambda s: print(s, file=sys.stderr, flush=True))
            secs = time.perf_counter() - t0
            launches = dict(m["cuda"].LAUNCHES)
            if hr:
                self.check_path("prof host-resolve", launches, ("search",),
                                absent=("presolve", "resolve"))
            else:
                self.check_path("prof device-resolve", launches,
                                DEVICE_RESOLVE_PATH)
            measured = PROF_DEVICE_KEYS + (() if hr else
                                           ("device_presolve_ms",))
            missing = [k for k in PROF_KEYS + measured if k not in art]
            unmeasured = [k for k in measured if art.get(k) is None]
            if art["device_idle_share"].get("value") is None:
                unmeasured.append("device_idle_share")
            if missing or unmeasured:
                fail(f"prof ({path} resolve): keys missing {missing}, not "
                     f"measured {unmeasured}")
            emit(dict(phase="prof", resolve=path, seconds=round(secs, 3),
                      launches=launches, **art))


    def harnesses(self) -> None:
        """The mesh harnesses on the card, launch counts from 0 before
        each: shardbench --real (the plain engine against a (1, 1) mesh on
        the synth reads, rows identical) and --device (K1 and K6 on the
        same lanes by CUDA events); shardscale on the 256 Mbp database of
        `full` over a (2, 2) mesh of cuda:0, byte-equal to full's
        host-resolve stream; scaling_bench with 1 and then 2 processes
        on cuda:0, a (2, 2) mesh each, on the synth reads, the merged rows
        equal to the golden rows, and with 2 processes, a (1, 2) mesh
        each, on full's reads, the merged rows equal to full's stream."""
        m, st = self.m, self.full_state
        t0 = time.perf_counter()
        real = m["shardbench"].leg_real(self.dev)
        if not real["rows_identical"]:
            fail("shardbench --real: the (1, 1) mesh's rows differ")
        for k in ("search", "sharded_search"):
            if real["launches"][k] <= 0:
                fail(f"shardbench --real launched no {k}")
        emit(dict(phase="harnesses", harness="shardbench --real", **real))
        emit(dict(phase="harnesses", harness="shardbench --device",
                  **m["shardbench"].leg_device(self.dev)))
        nreads = sum(len(b) for b in st["batches"])
        with tempfile.TemporaryDirectory() as td:
            tsv = os.path.join(td, "full.tsv")
            with open(tsv, "w") as f:
                f.write("\n".join([st["header"]] + st["rows"]) + "\n")
            line = m["shardscale"].run(types.SimpleNamespace(
                index_base=st["base"], reads=os.path.join(CACHE, BIGDB_READS),
                dp=2, fm=2, reads_count=nreads, batch=BATCH_READS,
                ref_tsv=tsv, ref_binary=None, device=str(self.dev)))
        if line["parity_vs_reference_binary"] is not True:
            fail("shardscale: the (2, 2) mesh's stream differs from the "
                 "single-device host-resolve stream")
        # a batch's search is one launch a dp row, an overflow re-run one
        # more; the host walk resolves the rows
        if line["k6_launches"]["sharded_search"] < 2 * line["batches"] \
                or line["k6_launches"]["sharded_resolve"]:
            fail(f"shardscale launches {line['k6_launches']} for "
                 f"{line['batches']} batches over 2 dp rows")
        emit(dict(phase="harnesses", harness="shardscale",
                  rows="byte-equal to the single-device host-resolve stream",
                  **line))
        with open(os.path.join(FIX, "golden_output.tsv")) as f:
            golden = f.read().splitlines()[1:]
        # synth in 1 and 2 processes, (2, 2) meshes; then the 256 Mbp
        # reads in 2 processes, (1, 2) meshes, against full's stream
        runs = [(1, SYN, os.path.join(FIX, "reads.fq"), SCALING_BATCH, 4,
                 golden, "the golden rows"),
                (2, SYN, os.path.join(FIX, "reads.fq"), SCALING_BATCH, 4,
                 golden, "the golden rows"),
                (2, st["base"], os.path.join(CACHE, BIGDB_READS),
                 nreads // 8, 2, st["rows"],
                 "the single-device host-resolve stream")]
        for nprocs, index, reads, batch, ndev, want, what in runs:
            lines, merged = self.scaling_run(nprocs, index, reads, batch,
                                             ndev)
            if merged != want:
                fail(f"scaling_bench ({nprocs} processes, {index}): the "
                     f"merged rows differ from {what}")
            for ln in lines:
                self.check_path(f"scaling_bench ({nprocs} processes)",
                                ln["launches"], MESH_DEVICE_PATH)
            emit(dict(phase="harnesses", harness="scaling_bench",
                      processes=nprocs, index=index,
                      rows=f"merged rows equal {what}", **lines[0],
                      launches_by_process=[ln["launches"] for ln in lines]))
        emit(dict(phase="harnesses", harness="all",
                  seconds=round(time.perf_counter() - t0, 3)))

    def scaling_run(self, nprocs: int, index: str, reads: str, batch: int,
                    ndev: int):
        """scaling_bench's per-process leg in nprocs processes on cuda:0,
        each over a mesh of ndev entries, 2 fm shards a dp row: (each
        process's JSON line, their rows in process order)."""
        return self.processes(nprocs, lambda pid, port, out: [
            sys.executable, "-m", "centrifuge_tpu_torch.parallel.scaling_bench",
            "--coordinator", f"localhost:{port}", "--nprocs", str(nprocs),
            "--procid", str(pid), "--local-devices", str(ndev), "--n-fm", "2",
            "-x", index, "-U", reads, "--batch", str(batch), "--out", out,
            "--device", str(self.dev)], "scaling_bench")

    @staticmethod
    def processes(n: int, argv, what: str):
        """n processes, argv(pid, port, out) each, joined over a free
        localhost port and each writing its rows to out: (the last JSON
        line of each one's output, their rows in process order). Fails on
        a nonzero exit; kills what is left on the way out."""
        import socket
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = []
        with tempfile.TemporaryDirectory() as td:
            outs = [os.path.join(td, f"shard{p}.tsv") for p in range(n)]
            try:
                for pid, out in enumerate(outs):
                    procs.append(subprocess.Popen(
                        argv(pid, port, out), cwd=REPO,
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
                    fail(f"{what} exit {p.returncode}: {se[-2000:]}")
            merged = []
            for out in outs:
                with open(out) as f:
                    merged += f.read().splitlines()
        return [json.loads(so.strip().splitlines()[-1])
                for so, _ in results], merged


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
    for phase in (s.env, s.kernels, s.kernels_sharded, s.wide_scale,
                  s.synth, s.synth_sharded, s.graft_entry, s.bench,
                  s.multihost,
                  s.full,
                  s.full_sharded, s.parity, s.tools, s.prof, s.harnesses):
        phase()
    emit({"kernels": list(s.rows.values())})
    print(s.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": s.name,
                                 "count": s.count}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
