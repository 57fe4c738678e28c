"""Sharded-engine measurement harness (SHARDBENCH).

Three legs on the synth index (tests/fixtures/synth), each printing one
JSON line:

1. --real: what the sharded path costs end to end. The same simulated
   reads stream through GPUClassificationPipeline twice, the plain
   engine (K1) against the sharded engine on a (1, 1) mesh (K6 over one
   shard), the median of 3 streams each; the rows must be identical.
2. --device: the same comparison without the host: the search launch
   alone, K1 against K6 on the same packed lanes, by CUDA events on the
   engine's stream (evaluation/prof.py device_only_ms and event_ms).
   Needs the card.
3. --cpu: the census of the table reads behind a sharded search on a
   (1, 8) mesh of CPU devices, through the plain sharded search
   (sharded_search_plain, whose ShardTableReads sends each read to the
   shard that owns it): the reads per search step by owning shard, the
   share of them owned by a shard other than the lane's row lead (the
   reads K6 makes to another shard's tables: over peer mappings when that
   shard sits on another card), and K6's launches per batch (0 here: a
   CPU mesh runs the plain version).

    python -m centrifuge_tpu_torch.parallel.shardbench --real [--device]
        [--cpu] [--out F] [--on cpu]

--on picks the device the --real leg runs on (cuda by default).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "synth")
BATCH = 8192
STREAMS = 3
CENSUS_FM = 8


def _index():
    from ..index.cf_io import load_cf_index
    return load_cf_index(os.path.join(FIXDIR, "synth"))


def _mk_reads(n: int):
    """n simulated 150 bp reads of the synth genomes (0.2% substitutions,
    seed 42), written to a temporary directory."""
    from ..evaluation.simulate import SimConfig, simulate
    from ..io.fastx import read_batch
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "sim")
        simulate(os.path.join(FIXDIR, "db.fa"),
                 os.path.join(FIXDIR, "conv.dmp"), prefix,
                 SimConfig(num_fragments=n, read_length=150,
                           error_rate=0.002, seed=42))
        return read_batch([prefix + ".fq"])[:n]


def _run_pipe(pipe, reads, batch, trials=STREAMS):
    rates, rows = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        rows = []
        for chunk in pipe.classify_stream_unpaired(
                reads[i: i + batch] for i in range(0, len(reads), batch)):
            rows += chunk
        rates.append(len(reads) / (time.perf_counter() - t0))
    return statistics.median(rates), rates, rows


def _pipes(idx, dev, batch):
    """The plain pipeline and the (1, 1)-mesh pipeline on `dev`, their
    lane buckets set to the batch's lanes."""
    from ..classify.gpu_pipeline import GPUClassificationPipeline
    from .sharded import make_mesh
    plain = GPUClassificationPipeline(idx, device=dev)
    shard = GPUClassificationPipeline(idx, device=dev,
                                      mesh=make_mesh(1, 1, [dev]))
    for p in (plain, shard):
        p.engine.lane_bucket_lo = 2 * batch
    return plain, shard


def leg_real(device="cuda", n_reads: int = 2 * BATCH,
             batch: int = BATCH) -> dict:
    from .. import _cuda
    from ..ops.fm_torch import resolve_device
    dev = resolve_device(device)
    idx = _index()
    reads = _mk_reads(n_reads)
    _cuda.reset_launches()
    plain, shard = _pipes(idx, dev, batch)
    out = {}
    for name, pipe in (("plain", plain), ("sharded", shard)):
        for _ in pipe.classify_stream_unpaired([reads[:batch]]):
            pass                                  # warm-up
        out[name] = _run_pipe(pipe, reads, batch)
    (p_rate, p_runs, p_rows), (s_rate, s_runs, s_rows) = (out["plain"],
                                                          out["sharded"])
    return {
        "metric": "shard_abstraction_overhead",
        "device": str(dev),
        "plain_reads_per_sec": round(p_rate, 1),
        "plain_runs": [round(x, 1) for x in p_runs],
        "sharded_1x1_reads_per_sec": round(s_rate, 1),
        "sharded_runs": [round(x, 1) for x in s_runs],
        "overhead_pct": round(100 * (1 - s_rate / p_rate), 1),
        "rows_identical": p_rows == s_rows,
        "reads": len(reads),
        "batch": batch,
        "launches": dict(_cuda.LAUNCHES),
        "note": "(1, 1) mesh: K6 runs K1's lane loop over one shard, "
                "without the depth-12 prime (the synth index has none) "
                "and at one thread a lane",
    }


def leg_device(device="cuda") -> dict:
    """K1 and K6 ((1, 1) mesh) on the same lanes (BATCH reads), the
    launch alone by CUDA events on each engine's stream."""
    from ..evaluation.prof import EVENT_REPS, device_only_ms, event_ms
    from ..classify import engine as em
    from ..ops.fm_torch import resolve_device
    from .sharded import sharded_search
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the --device leg times the card (CUDA events)")
    idx = _index()
    reads = _mk_reads(BATCH)
    plain, shard = _pipes(idx, dev, BATCH)
    units = plain._prep_unpaired(reads)
    seqs = [s for unit in units for fw, rc in unit for s in (fw, rc)]
    t_plain, _ = device_only_ms(plain, seqs, presolve=False)
    eng = shard.engine
    lmax = em._bucket_len(max(len(s) for s in seqs), lo=eng.lmax_lo)
    nlanes = em._bucket(len(seqs), lo=eng.lane_bucket_lo)
    rseqp, lengths = eng.pack_transport(seqs, lmax, nlanes)
    stream = eng._streams[dev]
    with eng.dev_lock, torch.cuda.stream(stream):
        args = [torch.from_numpy(a).to(dev) for a in
                (rseqp, lengths, np.zeros(nlanes, np.int32))]
        t_shard = event_ms(lambda: sharded_search(
            shard.mesh_index, *args, min(eng.FIRST_MAX_HITS, lmax),
            eng.min_hitlen, eng.increment, False), EVENT_REPS, stream)
    return {
        "metric": "shard_abstraction_overhead_device_only",
        "device": torch.cuda.get_device_name(dev),
        "plain_ms_per_batch": round(t_plain, 4),
        "sharded_1x1_ms_per_batch": round(t_shard, 4),
        "overhead_pct": round(100 * (t_shard / t_plain - 1), 1),
        "lanes": nlanes,
        "method": f"the search launch alone (K1; K6 on a (1, 1) mesh), "
                  f"{EVENT_REPS} launches between two CUDA events on the "
                  "engine's stream after a warm-up, inputs uploaded once",
    }


def census(index, stats: dict) -> dict:
    """The table reads a plain sharded search recorded (`stats` of
    sharded_search_plain: the rank rows, BWT rows and ftab entries of
    each lockstep step), by the shard that owns them: block rows by
    row >> 9, ftab entries by entry, each over the per-shard count."""
    n = index.n_fm
    by = np.zeros(n, np.int64)
    for key, per, shift in (("rank_rows", index.nblk_per, 9),
                            ("bwt_rows", index.nblk_per, 9),
                            ("ftab", index.nftab_per, 0)):
        for keys in stats.get(key, []):
            own = (keys.to(torch.int64) >> shift) // per
            by += np.bincount(own.numpy(), minlength=n)[:n]
    return {"reads_by_shard": by.tolist(), "reads": int(by.sum()),
            "steps": len(stats.get("ftab", []))}


def leg_cpu(n_reads: int = BATCH) -> dict:
    """The census on a (1, CENSUS_FM) mesh of CPU devices."""
    from .. import _cuda
    from ..classify.engine import _bucket_len
    from .sharded import (MeshIndex, ShardedFMArrays, ShardedSearchEngine,
                          make_mesh, sharded_search, sharded_search_plain)
    idx = _index()
    mesh = make_mesh(1, CENSUS_FM, ["cpu"] * CENSUS_FM)
    index = MeshIndex(ShardedFMArrays.build(idx, CENSUS_FM), mesh)
    eng = ShardedSearchEngine(index)
    reads = _mk_reads(n_reads)
    seqs = [s for r in reads for s in (r.seq, r.revcomp())]
    lmax = _bucket_len(max(len(s) for s in seqs), lo=eng.lmax_lo)
    rseqp, lengths = eng.pack_transport(seqs, lmax, len(seqs))
    args = (torch.from_numpy(rseqp), torch.from_numpy(lengths),
            torch.zeros(len(seqs), dtype=torch.int32),
            min(eng.FIRST_MAX_HITS, lmax), eng.min_hitlen, eng.increment,
            False)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    sharded_search(index, *args)
    wall = time.perf_counter() - t0
    launches = _cuda.LAUNCHES["sharded_search"]
    stats = {}
    sharded_search_plain(index, *args, stats=stats)
    c = census(index, stats)
    lead = c["reads_by_shard"][0]
    return {
        "metric": "shard_cpu_census",
        "n_fm": CENSUS_FM,
        "lanes": len(seqs),
        "search_wall_s": round(wall, 3),
        **c,
        "reads_per_step_by_shard": [round(x / c["steps"], 2)
                                    for x in c["reads_by_shard"]],
        "share_off_row_lead": round(1 - lead / c["reads"], 4),
        "k6_launches_per_batch": launches,
        "note": "a CPU mesh runs the plain version: no launch; on a CUDA "
                "mesh K6 is one search launch per dp row per batch",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="the device-only leg (the card, CUDA events)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--on", default="cuda",
                    help="the --real leg's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    lines = []
    if args.real:
        lines.append(leg_real(args.on))
    if args.device:
        lines.append(leg_device())
    if args.cpu:
        lines.append(leg_cpu())
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out and lines:
        with open(args.out, "a") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0 if all(ln.get("rows_identical", True) for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
