"""The wide regime (indexes of 2^31 bases or more: int64 rows, 64-bit occ
checkpoints) end to end on the card.

    python -m centrifuge_tpu_torch.evaluation.widebench [index_base reads]
        [--reads2 MATES2] [--ref-tsv TSV | --ref-binary BIN]
        [--reads-count N] [--batch B] [--out FILE] [--device cpu]

With no index given it builds (or reuses) the 2.2 Gbp database of
evaluation/bigdb.py ensure_widedb under .chip_smoke_cache/wide/ (550 x 4
Mbp random genomes, built by the in-memory SA-IS, whose host peak is
near 50 GB), simulates 131,072 reads of 150 bp from it (0.2%
substitutions, seed 23) and 16,384 pairs (seed 17), and streams those:
the reads as `reads`, the pairs as `reads` and `--reads2`.

Then it loads the index (it must hold 2^31 bases or more), builds one
device index (wide layout, the depth-12 ftab) and
  * streams the reads three times in `--batch`-read batches, each
    through a fresh pipeline on that index, the SA rows resolved by the
    host walk (the default path): reads/s of each stream, the median as
    `value`; the rows are written to <index_base>.widebench.tsv, the
    --ref-tsv that parallel/shardscale.py takes for the same index;
  * streams them once more with the SA rows resolved on the card
    (PipelineConfig(host_resolve=False): K5 and K3), byte-equal to the
    host-resolve stream;
  * classifies the first ORACLE_READS reads with the host oracle
    (classify/pipeline.py ClassificationPipeline over ops/fm_numpy
    FMOracle), byte-equal to the stream's rows;
  * compares the stream with --ref-tsv, or with the reference binary's
    output (--ref-binary, run with --reorder so rows keep read order,
    centrifuge.cpp:2806-2814), as the JAX package's widebench does;
  * with mate files, the paired leg: three streams of pairs, once more
    with device resolve, and the reference binary's paired output.
One JSON line: the JAX widebench's keys, the card's name and power
limit, load and build times, device index bytes, peak device and host
memory, each stream's kernel launches and the parity checks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time

import torch

BATCH = 32768
# the paired leg of the default run: its 16,384 pairs in 4 batches, so
# the overlap pipeline reaches its steady state
PAIRED_BATCH = 4096
STREAMS = 3
# the host oracle's sample: about 2 ms a read on the synth index
ORACLE_READS = 1000
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKDIR = os.path.join(REPO, ".chip_smoke_cache", "wide")
# the reads simulated from widedb.fa: (file prefix, SimConfig fields)
SIM_READS = ("wide_reads_131k", dict(num_fragments=131072, seed=23))
SIM_PAIRS = ("wide_pairs_16k", dict(num_fragments=16384, seed=17,
                                    paired=True))


# ---- the streams ----

def streams(idx, items, batch: int, dfm, runs: int = 1, cfg=None,
            device="cuda", paired: bool = False):
    """(output text, items/s of each stream): `runs` streams of the reads
    (or pairs) in `batch`-item batches, each through a fresh
    GPUClassificationPipeline on the shared device index `dfm`, the text
    a TSV (header and rows) of the last; every stream's rows must be
    equal."""
    from ..classify.gpu_pipeline import GPUClassificationPipeline
    rates, text = [], None
    for _ in range(runs):
        pipe = GPUClassificationPipeline(idx, cfg, device=device, dfm=dfm)
        stream = pipe.classify_stream_paired if paired \
            else pipe.classify_stream_unpaired
        t0 = time.perf_counter()
        rows = [pipe.formatter.header()]
        for chunk in stream(items[i: i + batch]
                            for i in range(0, len(items), batch)):
            rows += chunk
        rates.append(len(items) / (time.perf_counter() - t0))
        got = "\n".join(rows) + "\n"
        if text is not None and got != text:
            raise RuntimeError("two streams of the same reads differ")
        text = got
    return text, rates


def _device_resolve(idx, items, batch, dfm, device, paired):
    """(output text, items/s, kernel launches) of one stream with the SA
    rows resolved on the card."""
    from .. import _cuda
    from ..classify.pipeline import PipelineConfig
    _cuda.reset_launches()
    text, rates = streams(idx, items, batch, dfm,
                          cfg=PipelineConfig(host_resolve=False),
                          device=device, paired=paired)
    return text, rates[0], dict(_cuda.LAUNCHES)


def oracle_rows(idx, reads) -> list:
    """The host oracle's rows for the reads (unpaired)."""
    from ..classify.pipeline import ClassificationPipeline, PipelineConfig
    from ..ops.fm_numpy import FMOracle
    orc = ClassificationPipeline(idx, FMOracle(idx), PipelineConfig())
    rows = []
    for r in reads:
        rows += orc.classify_unpaired(r)
    return rows


def _run_ref(args, out, count, mates):
    """Seconds the reference binary takes for `count` reads or pairs of
    `mates` (["-U", f] or ["-1", f1, "-2", f2]), its TSV written to
    `out`."""
    t0 = time.time()
    r = subprocess.run(
        [args.ref_binary, "-x", args.index_base, *mates, "-u", str(count),
         "-p", "4", "--reorder", "-S", out, "--report-file", "/dev/null"],
        capture_output=True, text=True)
    print(f"reference rc: {r.returncode} ({time.time() - t0:.1f}s)",
          flush=True)
    return time.time() - t0


def _paired_leg(args, idx, dfm):
    """The paired leg: 3 timed classify_stream_paired streams over the
    mate files, one more with device resolve, and byte parity with the
    reference binary run with -1/-2 --reorder (paired scoring:
    classifier.h:226,530-535, a pair is one unit). A dict for the JSON
    line."""
    from ..io.fastx import read_batch
    B = args.batch
    m1 = read_batch([args.reads])
    m2 = read_batch([args.reads2])
    n_pairs = min(len(m1), len(m2), args.reads_count)
    n_pairs = (n_pairs // B) * B
    pairs = list(zip(m1[:n_pairs], m2[:n_pairs]))
    print(f"paired leg: {n_pairs} pairs, batch {B}", flush=True)
    t0 = time.time()
    streams(idx, pairs[:B], B, dfm, device=args.device, paired=True)
    print(f"paired warm-up: {time.time() - t0:.1f}s", flush=True)
    ours, runs = streams(idx, pairs, B, dfm, runs=STREAMS,
                         device=args.device, paired=True)
    print(f"paired runs: {[round(x, 1) for x in runs]} pairs/s", flush=True)
    dev_text, dev_rate, dev_launches = _device_resolve(
        idx, pairs, B, dfm, args.device, True)
    parity = ref_t = None
    if args.ref_binary:
        ref_out = args.index_base + ".refparity.paired.tsv"
        ref_t = _run_ref(args, ref_out, n_pairs,
                         ["-1", args.reads, "-2", args.reads2])
        with open(ref_out) as f:
            parity = f.read() == ours
    return {
        "pairs_per_sec": round(statistics.median(runs), 1),
        "mates_per_sec": round(2 * statistics.median(runs), 1),
        "runs": [round(x, 1) for x in runs],
        "pairs": n_pairs,
        "device_resolve_identical": dev_text == ours,
        "device_resolve_pairs_per_sec": round(dev_rate, 1),
        "device_resolve_launches": dev_launches,
        "parity_vs_reference_binary": parity,
        "ref_cpu_total_seconds": round(ref_t, 1) if ref_t else None,
    }


def ensure_inputs(workdir: str = WORKDIR):
    """(index base, reads, mates 1, mates 2, seconds): the 2.2 Gbp
    database (bigdb.ensure_widedb) and the reads simulated from it, built
    where missing."""
    from . import bigdb
    from .simulate import SimConfig, simulate
    t0 = time.time()
    base = bigdb.ensure_widedb(workdir, verbose=True)
    out = []
    for prefix, fields in (SIM_READS, SIM_PAIRS):
        # simulate gives each genome round(n / genomes) reads: ask for
        # enough to keep n
        n = fields["num_fragments"]
        cfg = dict(fields, num_fragments=bigdb.WIDE_N_GENOMES * math.ceil(
            n / bigdb.WIDE_N_GENOMES))
        path = os.path.join(workdir, prefix)
        names = [path + "_1.fq", path + "_2.fq"] if fields.get("paired") \
            else [path + ".fq"]
        if not all(os.path.exists(p) for p in names):
            print(f"simulating {prefix} ...", flush=True)
            simulate(os.path.join(workdir, "widedb.fa"),
                     os.path.join(workdir, "wconv.dmp"), path,
                     SimConfig(read_length=150, error_rate=0.002, **cfg))
        out += names
    return base, out[0], out[1], out[2], time.time() - t0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("index_base", nargs="?", default=None,
                    help="a wide index (>= 2^31 bases); default: build the "
                         "2.2 Gbp database and its reads under "
                         ".chip_smoke_cache/wide/")
    ap.add_argument("reads", nargs="?", default=None)
    ap.add_argument("--reads2", default=None,
                    help="mate-2 FASTQ: adds the paired leg (reads holds "
                         "mate 1)")
    ap.add_argument("--ref-binary", default=None,
                    help="reference centrifuge-class for the parity leg")
    ap.add_argument("--ref-tsv", default=None,
                    help="a reference TSV (centrifuge-class --reorder on "
                         "the same index and reads) to byte-compare")
    ap.add_argument("--reads-count", type=int, default=4 * BATCH)
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="reads per device batch")
    ap.add_argument("--out", default=None, help="write the JSON line here too")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from .. import _cuda
    from ..classify.gpu_pipeline import GPUClassificationPipeline
    from ..index.cf_io import load_cf_index
    from ..io.fastx import read_batch
    from ..ops.fm_torch import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    db_s = None
    paired_reads = None
    if args.index_base is None:
        base, reads, m1, m2, db_s = ensure_inputs()
        args.index_base, args.reads = base, reads
        paired_reads = (m1, m2)
    elif args.reads is None:
        ap.error("reads is required with index_base")

    t0 = time.time()
    idx = load_cf_index(args.index_base)
    load_s = time.time() - t0
    print(f"index loaded: bwt_len={idx.bwt_len} ({load_s:.1f}s)", flush=True)
    if idx.bwt_len < (1 << 31):
        raise SystemExit(f"widebench: {idx.bwt_len} rows is not the wide "
                         "regime (>= 2^31)")

    B = args.batch
    reads = read_batch([args.reads], limit=args.reads_count)
    reads = reads[: (len(reads) // B) * B]
    if not reads:
        raise SystemExit(f"widebench: fewer than {B} reads")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launches()
    t0 = time.time()
    pipe = GPUClassificationPipeline(idx, device=dev)
    if not pipe.dfm.wide:
        raise RuntimeError("the device index is not on the wide path")
    dfm = pipe.dfm
    index_s = time.time() - t0
    print(f"device index built ({index_s:.1f}s, {dfm.nbytes} bytes)",
          flush=True)

    t0 = time.time()
    streams(idx, reads[:B], B, dfm, device=dev)
    print(f"warm-up: {time.time() - t0:.1f}s", flush=True)
    ours, runs = streams(idx, reads, B, dfm, runs=STREAMS, device=dev)
    launches = dict(_cuda.LAUNCHES)
    print(f"runs: {[round(x, 1) for x in runs]} reads/s", flush=True)
    tsv = args.index_base + ".widebench.tsv"
    with open(tsv, "w") as f:
        f.write(ours)

    dev_text, dev_rate, dev_launches = _device_resolve(
        idx, reads, B, dfm, dev, False)
    print(f"device resolve: {dev_rate:.1f} reads/s, identical "
          f"{dev_text == ours}", flush=True)

    t0 = time.time()
    want = oracle_rows(idx, reads[:ORACLE_READS])
    oracle_s = time.time() - t0
    oracle_ok = ours.splitlines()[1: 1 + len(want)] == want
    print(f"oracle: {len(want)} rows, identical {oracle_ok} "
          f"({oracle_s:.1f}s)", flush=True)

    parity = ref_t = ref_marginal = None
    if args.ref_tsv:
        with open(args.ref_tsv) as f:
            parity = f.read() == ours
    elif args.ref_binary:
        ref_out = args.index_base + ".refparity.tsv"
        ref_t = _run_ref(args, ref_out, len(reads), ["-U", args.reads])
        with open(ref_out) as f:
            parity = f.read() == ours
        # the warm marginal rate: a second run at a third of the reads
        # cancels the index load (BASELINE.md:45-65)
        n_small = max(1, len(reads) // 3)
        ref_t_small = _run_ref(args, ref_out + ".small", n_small,
                               ["-U", args.reads])
        if ref_t > ref_t_small:
            ref_marginal = (len(reads) - n_small) / (ref_t - ref_t_small)

    paired = None
    if args.reads2 or paired_reads:
        if paired_reads:
            args.reads, args.reads2 = paired_reads
            args.reads_count = SIM_PAIRS[1]["num_fragments"]
            args.batch = PAIRED_BATCH
        paired = _paired_leg(args, idx, dfm)

    line = {
        "metric": "wide_reads_per_sec_e2e",
        "value": round(statistics.median(runs), 1),
        "unit": "reads/s",
        "runs": [round(x, 1) for x in runs],
        "reads": len(reads),
        "batch": B,
        "bwt_len": int(idx.bwt_len),
        "deep_ftab": dfm.ftab12_rows is not None,
        "parity_vs_reference_binary": parity,
        "ref_cpu_total_seconds": round(ref_t, 1) if ref_t else None,
        "ref_cpu_marginal_reads_per_sec":
            round(ref_marginal, 1) if ref_marginal else None,
        "paired": paired,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_line() if on_card else None,
        "launches": launches,
        "host_resolve_tsv": tsv,
        "device_resolve_identical": dev_text == ours,
        "device_resolve_reads_per_sec": round(dev_rate, 1),
        "device_resolve_launches": dev_launches,
        "oracle_reads": len(want),
        "oracle_identical": oracle_ok,
        "oracle_seconds": round(oracle_s, 3),
        "db_build_s": round(db_s, 1) if db_s is not None else None,
        "cf_load_s": round(load_s, 3),
        "index_to_device_s": round(index_s, 3),
        "index_bytes": int(dfm.nbytes),
        "max_memory_allocated":
            int(torch.cuda.max_memory_allocated(dev)) if on_card else None,
        # ru_maxrss is in KiB on Linux
        "host_peak_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    ok = [parity is not False, line["device_resolve_identical"], oracle_ok]
    if paired:
        ok += [paired["parity_vs_reference_binary"] is not False,
               paired["device_resolve_identical"]]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
