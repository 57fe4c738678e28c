"""Benchmark of the port: end-to-end classification throughput on the
synthetic DB, on the card. The counterpart of the repository root's
bench.py, with its phases, constants and JSON keys, each meaning the same.

    python -m centrifuge_tpu_torch.bench [--device cpu] [--batch N]
        [--trials N]

With no flags the sizes are bench.py's: BATCH reads a batch,
SIM_BATCHES x BATCH simulated reads (bench.py's N_THROUGHPUT_READS),
SIM_BATCHES x BATCH/2 pairs, TRIALS trials; --batch scales the
simulations with it.

  0. setup: the synth index loaded once and one DeviceFMIndex built,
     shared by every pipeline below (and with it one HostResolver); on
     the card the CUDA context is made and the kernels built here, so
     neither lands in a timed trial. Every pipeline dispatches
     2 x BATCH lanes in one 32-wide length band (engine.lane_bucket_lo,
     engine.lmax_lo), as bench.py's do.
  1. parity gate: the 3,000 fixture reads streamed in BATCH chunks;
     parity_ok when the header and rows equal golden_output.tsv line
     for line.
  2. unpaired throughput: 6 x BATCH reads simulated from the synth
     genomes (evaluation/synth_reads.py: 150 bp, 0.2% substitutions,
     seed 42), tiled to N_STREAM_BATCHES batches; one warm-up batch,
     then TRIALS fresh pipelines, each timed by the host clock around
     the whole stream: the window closes when the stream's generator is
     exhausted, after the last rows came out of the tail thread and its
     executor was shut down. The median is `value`, every trial in
     `runs`.
  3. paired throughput: 6 x BATCH/2 pairs (seed 43) tiled to
     N_STREAM_BATCHES batches of BATCH/2 pairs, the same 2 x BATCH
     lanes; a warm-up batch, then the median of TRIALS.
  4. device-only search time: K1's launch alone by CUDA events on the
     engine's stream over the lanes of the first BATCH simulated reads
     (evaluation/prof.device_only_ms), no output leaving the card.

Readable lines come first (each phase's seconds and K1 launches, the
device memory after each trial, the peak); the last line is one JSON
object: bench.py's keys, plus `device` ("cuda" or "cpu"), `card` (the
card's name and power limit as nvidia-smi gives them; null on the CPU)
and `launches` (the port's _cuda.LAUNCHES over phases 2-4).

Simulated reads are kept in the temp directory as
cftpu_torch_bench_{sim,pairs}_<n>.*, written under a temporary name and
renamed when complete; a file with fewer reads than asked raises
SystemExit.

Departures from bench.py: after printing its line the bench exits 1 when
parity_ok is false (bench.py prints and exits 0), so a parity failure
cannot pass as a result; a short pair file raises SystemExit as a short
read file does (bench.py tiles it). --device cuda, the default, without
a card exits 2 before phase 1. With --device cpu the kernels' plain
versions run and device_search_ms_per_batch is null.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import List, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "synth")
FIXTURE_READS = os.path.join(FIXDIR, "reads.fq")      # the parity gate's
GOLDEN = os.path.join(FIXDIR, "golden_output.tsv")    # reads and rows

BASELINE_READS_PER_SEC = 3333.0   # bench.py: the published desktop claim
REF_CPU_LOCAL = 167000.0          # bench.py: the reference C++ at -p 4
BATCH = 32768                     # reads a batch: 65,536 lanes
SIM_BATCHES = 6                   # batches of reads (pairs) simulated
N_STREAM_BATCHES = 12             # batches a timed run, by tiling
TRIALS = 5
LMAX_LO = 32                      # one length band: 150 bp -> 160
SEED_READS = 42
SEED_PAIRS = 43


def share_shapes(pipe, batch: int) -> None:
    """2 x batch lanes a dispatch, one 32-wide length band (bench.py's
    _share_shapes)."""
    pipe.engine.lane_bucket_lo = 2 * batch
    pipe.engine.lmax_lo = LMAX_LO


def sim_prefix(n: int, paired: bool) -> str:
    kind = "pairs" if paired else "sim"
    return os.path.join(tempfile.gettempdir(),
                        f"cftpu_torch_bench_{kind}_{n}")


def simulated(n: int, paired: bool, seed: int) -> list:
    """n reads (or pairs) of the synth genomes, simulated once into the
    temp directory."""
    from .evaluation.synth_reads import synth_reads
    return synth_reads(n, paired, seed, sim_prefix(n, paired))


def log(s: str) -> None:
    print(s, flush=True)


def tiled(recs: list, n: int) -> list:
    """recs repeated up to n (bench.py's tiling)."""
    while len(recs) < n:
        recs = recs + recs
    return recs[:n]


def chunks(recs: list, size: int):
    return (recs[i: i + size] for i in range(0, len(recs), size))


class Bench:
    """One run's index, shared by its pipelines."""

    def __init__(self, device: torch.device, batch: int):
        from .index.cf_io import load_cf_index
        from .ops.fm_torch import DeviceFMIndex
        self.device, self.batch = device, batch
        self.idx = load_cf_index(os.path.join(FIXDIR, "synth"))
        self.dfm = DeviceFMIndex.build(self.idx, device,
                                       keep_host_blocks=True)

    def pipe(self):
        """A fresh pipeline over the shared device index."""
        from .classify.gpu_pipeline import GPUClassificationPipeline
        p = GPUClassificationPipeline(self.idx, dfm=self.dfm)
        share_shapes(p, self.batch)
        return p

    def trials(self, recs: list, paired: bool, size: int,
               n: int) -> List[float]:
        """Units (reads or pairs) a second of n streams of recs in `size`
        batches, each through a fresh pipeline after one warm-up batch,
        by the host clock around the whole stream."""
        def stream(p, batches):
            run = p.classify_stream_paired if paired \
                else p.classify_stream_unpaired
            for _ in run(batches):
                pass

        stream(self.pipe(), [recs[:size]])
        rates = []
        for k in range(n):
            p = self.pipe()
            t0 = time.perf_counter()
            stream(p, chunks(recs, size))
            secs = time.perf_counter() - t0
            rates.append(len(recs) / secs)
            mem = (f", {torch.cuda.memory_allocated(self.device)} bytes "
                   f"allocated after" if self.device.type == "cuda" else "")
            log(f"bench: {'paired' if paired else 'unpaired'} trial "
                f"{k}: {rates[-1]:.1f}/s, {secs:.3f} s{mem}")
        return rates


def emit(line: dict) -> int:
    """Print the result line; the exit code: 1 unless parity held."""
    print(json.dumps(line), flush=True)
    return 0 if line["parity_ok"] else 1


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m centrifuge_tpu_torch.bench",
        description="end-to-end throughput on the synth database "
                    "(the port's bench.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions; device timings null)")
    p.add_argument("--batch", type=int, default=BATCH,
                   help=f"reads a batch (default {BATCH}); a paired batch "
                        f"is half as many pairs")
    p.add_argument("--trials", type=int, default=TRIALS)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    ap = make_parser()
    args = ap.parse_args(argv)
    if args.batch < 2 or args.trials < 1:
        ap.error("--batch must be at least 2 and --trials at least 1")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print(f"bench: no CUDA card for --device {args.device}; pass "
              f"--device cpu for the plain versions", file=sys.stderr)
        return 2
    from . import _cuda
    from .evaluation import prof
    from .io.fastx import read_batch
    from .native.fmwalk import _load as _fmwalk_load
    from .native.pack import _load as _pack_load
    from .ops.fm_torch import resolve_device
    from .utils.fallback import fallbacks as native_fallbacks

    batch = args.batch
    pb = batch // 2                    # pairs a batch: the same lanes

    # ---- phase 0: setup; the kernels' build and the context land here
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if device.type == "cuda":
        _cuda.lib("search")            # builds every kernel source
    _pack_load()                       # the native host paths (g++)
    _fmwalk_load()
    b = Bench(device, batch)
    log(f"bench: setup {time.perf_counter() - t0:.3f} s on {device}")

    # ---- phase 1: byte parity on the fixture reads ----
    t0 = time.perf_counter()
    fixture = read_batch([FIXTURE_READS])
    pipe = b.pipe()
    rows = [pipe.formatter.header()]
    for chunk in pipe.classify_stream_unpaired(chunks(fixture, batch)):
        rows += chunk
    with open(GOLDEN) as f:
        golden = f.read().splitlines()
    parity_ok = rows == golden
    log(f"bench: parity {parity_ok} ({len(fixture)} reads) "
        f"{time.perf_counter() - t0:.3f} s")

    # ---- phases 2 and 3: unpaired and paired throughput, the median of
    # the trials; launches counted from here on
    t0 = time.perf_counter()
    reads = tiled(simulated(SIM_BATCHES * batch, False, SEED_READS),
                  N_STREAM_BATCHES * batch)
    pairs = tiled(simulated(SIM_BATCHES * pb, True, SEED_PAIRS),
                  N_STREAM_BATCHES * pb)
    log(f"bench: simulated reads and pairs ready in "
        f"{time.perf_counter() - t0:.3f} s")
    _cuda.reset_launches()
    phase_launches = {}
    runs = b.trials(reads, False, batch, args.trials)
    phase_launches["unpaired"] = _cuda.LAUNCHES["search"]
    pruns = b.trials(pairs, True, pb, args.trials)
    phase_launches["paired"] = (_cuda.LAUNCHES["search"]
                                - phase_launches["unpaired"])

    # ---- phase 4: device-only search time (K1 alone, CUDA events) ----
    pipe = b.pipe()
    units = pipe._prep_unpaired(reads[:batch])
    lane_seqs = prof.lane_seqs(units, [True] * len(units))
    device_ms = None
    if device.type == "cuda":
        before = _cuda.LAUNCHES["search"]
        device_ms, _ = prof.device_only_ms(pipe, lane_seqs, presolve=False)
        phase_launches["device_only"] = _cuda.LAUNCHES["search"] - before
        log(f"bench: K1 alone {device_ms:.4f} ms over "
            f"{pipe.engine.lane_bucket_lo} lanes; peak device memory "
            f"{torch.cuda.max_memory_allocated(device)} bytes")
    log(f"bench: K1 launches by phase {phase_launches} (each stream phase "
        f"a warm-up batch and {args.trials} x {N_STREAM_BATCHES} batches)")

    rps = statistics.median(runs)
    pps = statistics.median(pruns)
    return emit({
        "metric": "reads_per_sec_e2e_synth",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
        "vs_ref_cpu_local": round(rps / REF_CPU_LOCAL, 3),
        "runs": [round(r, 1) for r in runs],
        "reads": len(reads),
        "device_search_ms_per_batch": device_ms,
        "device_batch_lanes": 2 * batch,
        "paired_pairs_per_sec": round(pps, 1),
        "paired_runs": [round(r, 1) for r in pruns],
        "parity_ok": parity_ok,
        "native_engine": pipe.native is not None,
        "native_pack": _pack_load() is not None,
        "native_fmwalk": _fmwalk_load() is not None,
        "native_ok": (pipe.native is not None and _pack_load() is not None
                      and _fmwalk_load() is not None),
        "native_fallbacks": native_fallbacks(),
        "device": device.type,
        "card": prof.card_line() if device.type == "cuda" else None,
        "launches": dict(_cuda.LAUNCHES),
    })


if __name__ == "__main__":
    sys.exit(main())
