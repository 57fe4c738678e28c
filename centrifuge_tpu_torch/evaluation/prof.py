"""Cost breakdown of the GPU pipeline's main path (the counterpart of the
JAX package's evaluation/prof.py), in one process, on the same batches:

  1. the search of each batch: search_async -> search_collect by the host
     clock, and the search launch alone (K1; with the device resolve also
     the K5 + K3 launches each dispatch carries) by CUDA events on the
     engine's stream, with no device-to-host copy
  2. one dispatch (packing, upload, launch) against its block (the wait
     for the output copy, the overflow re-run)
  3. the host tail alone: the tail worker's function replayed on one
     batch's collected arrays (native process_rows; on the device-resolve
     path it launches K3 and K1 itself under engine.dev_lock)
  4. the main thread's host work, split by step: the per-batch steps of
     GPUClassificationPipeline._stream_overlap replayed on the batches,
     each timed by the host clock; the tail is not run, so no step
     contends with it
  5. streams end to end, serial and with the tail thread
  6. the device's idle share over one more threaded stream:
     1 - (union of the card's kernel and copy intervals) / (the stream's
     wall window), from torch.profiler's device records, cross-checked by
     CUDA events around each engine dispatch (upload start to the end of
     the output copy: a window that also holds the host's enqueue work
     between the two, and misses the tail's K3 on the resolver's stream,
     so a cross-check, not the measure)
  7. steps per lane of the plain search loop on the first batch

It prints readable lines, then one JSON line (metric
"e2e_cost_breakdown"). On the CPU (--device cpu, the kernels' plain
versions) the device timings are null.

Usage:
    python -m centrifuge_tpu_torch.evaluation.prof [--index BASE]
        [--reads FQ [--reads2 FQ2]] [--paired] [--batch N] [--batches N]
        [--runs N] [--no-host-resolve] [--no-steps] [--device DEV]
        [--out FILE]

Without --reads it simulates reads from the synth fixture's database
into a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "synth")
BATCH = 32768                  # reads a batch: 65,536 lanes
SURVIVOR_FRACTIONS = (0.5, 0.25, 0.125, 0.0625, 1 / 64, 1 / 256)
TOP_DEVICE_OPS = 10
TOP_IDLE_GAPS = 5
EVENT_REPS = 5                 # launches a CUDA-event time averages
WINDOW = "prof_threaded_stream"   # the profiler range of the window

# the leaves of the main thread's split: their sum is the replayed loop
UNPAIRED_STEPS = ("flat_seqs", "revcomp", "filters", "tally_outer",
                  "lane_map", "pack_transport", "h2d_launch", "seeds",
                  "fetch_wait")
PAIRED_STEPS = ("filters", "revcomp", "tally_outer", "pair_units",
                "lane_map", "pack_transport", "h2d_launch", "seeds",
                "fetch_wait")


class StepClock:
    """Host-clock seconds per named step, summed over its calls."""

    def __init__(self):
        self.secs: Dict[str, float] = {}

    @contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.secs[name] = (self.secs.get(name, 0.0)
                               + time.perf_counter() - t0)

    @contextmanager
    def wrapping(self, obj, attr: str, name: str):
        """Time every call of obj.attr as step `name` for the block."""
        fn = getattr(obj, attr)

        def timed(*a, **k):
            with self.step(name):
                return fn(*a, **k)

        with patched(obj, attr, timed):
            yield


@contextmanager
def patched(obj, attr: str, value):
    """obj.attr = value for the block; the old value (or, for a method
    found on the class, none) restored after."""
    own = attr in vars(obj)
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        if own:
            setattr(obj, attr, old)
        else:
            delattr(obj, attr)


def _ms(sec: float) -> float:
    return sec * 1e3


def _median_ms(secs: List[float]) -> float:
    return _ms(statistics.median(secs))


def lane_seqs(units, active) -> List[np.ndarray]:
    """The lanes _dispatch_units builds: both strands of every mate of
    every active unit."""
    return [s for unit, ok in zip(units, active) if ok
            for fw, rc in unit for s in (fw, rc)]


def event_ms(fn: Callable, reps: int, stream) -> float:
    """ms per call of fn by CUDA events on `stream`, after one warm-up
    call; fn launches on the current stream, which the caller sets."""
    fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record(stream)
    for _ in range(reps):
        fn()
    e.record(stream)
    e.synchronize()
    return s.elapsed_time(e) / reps


def device_only_ms(pipe, seqs, presolve: bool):
    """(search ms, presolve ms or None) by CUDA events: the lanes packed
    and uploaded once, then the search launch alone (K1) and, with the
    presolve, the K5 + K3 launches on its first-pass hit buffers, on the
    engine's stream; no output leaves the card (the counterpart of the
    JAX profile's _time_device_only)."""
    from ..classify import engine as em
    eng, fm = pipe.engine, pipe.engine.fm
    lmax = em._bucket_len(max(len(s) for s in seqs), lo=eng.lmax_lo)
    nlanes = em._bucket(len(seqs), lo=eng.lane_bucket_lo)
    rseqp, lengths = eng.pack_transport(seqs, lmax, nlanes)
    dev = eng.device
    with eng.dev_lock, torch.cuda.stream(eng._stream):
        reads = torch.from_numpy(rseqp).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        start = torch.zeros(nlanes, dtype=torch.int32, device=dev)
        args = (fm, reads, lens, start, min(eng.FIRST_MAX_HITS, lmax),
                eng.min_hitlen, eng.increment, False, eng._deep(lmax))
        search_ms = event_ms(lambda: em.search_lanes(*args), EVENT_REPS,
                             eng._stream)
        if not presolve:
            return search_ms, None
        out = em.search_lanes(*args)
        khits = pipe.cfg.classifier.khits
        pre = (fm, out[0], out[1], out[3], khits, pipe.classifier.ihits,
               eng.min_hitlen, em.presolve_rk(khits))
        return search_ms, event_ms(lambda: em.presolve_lanes(*pre),
                                   EVENT_REPS, eng._stream)


def prepare(pipe, batch, paired: bool):
    """The main thread's prep of one batch (_stream_overlap's steps):
    (units, active flags, the tail's arguments before the handle,
    seeds)."""
    from ..classify.pipeline import batch_flat_seqs, batch_read_passes
    from ..utils.rng import gen_read_seeds_batch
    if paired:
        prep = pipe._prep_paired(batch)
        return prep[0], prep[2], (batch, prep), \
            pipe._paired_seeds(batch, prep[1])
    flat3 = batch_flat_seqs(batch)
    units = pipe._prep_unpaired(batch, flat3=flat3)
    passes = batch_read_passes(batch, pipe.cfg, flat3=flat3)
    pipe._tally_outer(batch, passes, flat3=flat3)
    return units, passes, (batch, passes, units), \
        gen_read_seeds_batch(batch, pipe.cfg.seed, flat3=flat3)


def replay_main_thread(pipe, batches, paired: bool) -> Dict[str, float]:
    """The main thread's loop of _stream_overlap over the batches, the
    tail left out: each step timed by the host clock. Returns seconds
    per step (the leaves of UNPAIRED_STEPS or PAIRED_STEPS) and "total",
    the whole loop."""
    from ..classify import gpu_pipeline as gp
    from ..classify.pipeline import batch_flat_seqs, batch_read_passes
    from ..utils.rng import gen_read_seeds_batch
    eng = pipe.engine
    clock = StepClock()
    pending = deque()

    def fetch_one():
        handle = pending.popleft()
        if handle is not None:
            with clock.step("fetch_wait"):
                eng.search_fetch(handle)

    t0 = time.perf_counter()
    for b in batches:
        if paired:
            with clock.step("prep_paired"), \
                    clock.wrapping(gp, "batch_read_passes", "filters"), \
                    clock.wrapping(gp, "batch_revcomp", "revcomp"), \
                    clock.wrapping(pipe, "_tally_outer", "tally_outer"):
                prep = pipe._prep_paired(b)
            units, active = prep[0], prep[2]
        else:
            with clock.step("flat_seqs"):
                flat3 = batch_flat_seqs(b)
            with clock.step("revcomp"):
                units = pipe._prep_unpaired(b, flat3=flat3)
            with clock.step("filters"):
                active = batch_read_passes(b, pipe.cfg, flat3=flat3)
            with clock.step("tally_outer"):
                pipe._tally_outer(b, active, flat3=flat3)
        with clock.step("dispatch"), \
                clock.wrapping(eng, "pack_transport", "pack_transport"), \
                clock.wrapping(eng, "_launch", "h2d_launch"):
            fut = pipe._dispatch_units(units, active)
        with clock.step("seeds"):
            if paired:
                pipe._paired_seeds(b, prep[1])
            else:
                gen_read_seeds_batch(b, pipe.cfg.seed, flat3=flat3)
        pending.append(fut[2])
        if len(pending) > 2:
            fetch_one()
    while pending:
        fetch_one()
    out = dict(clock.secs, total=time.perf_counter() - t0)
    out.setdefault("fetch_wait", 0.0)
    for k in ("pack_transport", "h2d_launch"):
        out.setdefault(k, 0.0)
    out["lane_map"] = (out.pop("dispatch") - out["pack_transport"]
                       - out["h2d_launch"])
    if paired:
        out["pair_units"] = (out.pop("prep_paired") - out["filters"]
                             - out["revcomp"] - out["tally_outer"])
    return out


def merge_intervals(spans, lo: float, hi: float):
    """The union of (start, end) spans clipped to [lo, hi], sorted and
    merged."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_summary(spans, lo: float, hi: float, unit_ms: float) -> dict:
    """Idle share of the window [lo, hi] given the busy spans (in a unit
    of unit_ms milliseconds), and its longest idle gaps (start offset
    into the window and length, ms)."""
    busy = merge_intervals(spans, lo, hi)
    window = hi - lo
    busy_t = sum(e - s for s, e in busy)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i] - lo)
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    return dict(value=1.0 - busy_t / window if window > 0 else None,
                window_ms=window * unit_ms, busy_ms=busy_t * unit_ms,
                longest_idle_gaps=[dict(start_ms=g[1] * unit_ms,
                                        ms=g[0] * unit_ms)
                                   for g in gaps[:TOP_IDLE_GAPS]])


def profiled_stream(pipe, batches, paired: bool):
    """One threaded stream under torch.profiler (CPU and CUDA records),
    with CUDA events around each engine dispatch. Returns (stream
    seconds, the profiler's idle summary or None, its top device ops,
    the events' idle summary, dispatches)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = pipe.engine
    launch = eng._launch
    windows = []

    def timed_launch(handle, start, first_hit_only):
        # the start before the upload, the end after the output copies,
        # both on the engine's stream under its lock
        with eng.dev_lock:
            s = torch.cuda.Event(enable_timing=True)
            s.record(eng._stream)
            out = launch(handle, start, first_hit_only)
            e = torch.cuda.Event(enable_timing=True)
            e.record(eng._stream)
        windows.append((s, e))
        return out

    stream = pipe.classify_stream_paired if paired \
        else pipe.classify_stream_unpaired
    ref = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, patched(eng, "_launch", timed_launch):
        with record_function(WINDOW):
            t0 = time.perf_counter()
            ref.record(eng._stream)
            for _ in stream(batches):
                pass
            end.record(eng._stream)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    ev = idle_summary([(ref.elapsed_time(s), ref.elapsed_time(e))
                       for s, e in windows], 0.0, ref.elapsed_time(end),
                      1.0)
    events = prof.events()
    cuda_type = torch.autograd.DeviceType.CUDA
    # the card's kernels, copies and sets; not the range's own device
    # annotation, which spans the window
    dev = [e for e in events if e.device_type == cuda_type
           and e.name != WINDOW and not getattr(e, "is_user_annotation",
                                                False)
           and e.time_range.end > e.time_range.start]
    win = [e for e in events if e.name == WINDOW
           and e.device_type != cuda_type]
    if not dev or not win:
        return secs, None, [], ev, len(windows)
    lo, hi = win[0].time_range.start, win[0].time_range.end
    prof_idle = idle_summary([(e.time_range.start, e.time_range.end)
                              for e in dev], lo, hi, 1e-3)
    ops: Dict[str, list] = {}
    for e in dev:
        o = ops.setdefault(e.name, [0, 0.0])
        o[0] += 1
        o[1] += e.time_range.end - e.time_range.start
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP_DEVICE_OPS]
    return secs, prof_idle, [dict(name=k, calls=c, total_ms=t * 1e-3)
                             for k, (c, t) in top], ev, len(windows)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def profile(idx, batches, *, paired: bool = False, host_resolve: bool = True,
            device="cuda", dfm=None, runs: int = 3, steps: bool = True,
            log: Callable[[str], None] = print) -> dict:
    """The breakdown of one resolve path on `batches` (lists of ReadRec,
    or of (mate 1, mate 2) with paired) of a loaded CFIndex, as a dict
    (metric "e2e_cost_breakdown"). dfm: a DeviceFMIndex of idx to reuse
    (else the first pipeline builds one). runs: streams of each kind, and
    replays of the host tail."""
    from ..classify import engine as em
    from ..classify.gpu_pipeline import GPUClassificationPipeline as Pipe
    from ..classify.pipeline import PipelineConfig
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card")
    nreads = sum(len(b) for b in batches)
    art = {"metric": "e2e_cost_breakdown", "device": str(dev),
           "nvidia_smi": card_line() if on_card else None,
           "card": torch.cuda.get_device_name(dev) if on_card else None,
           "host_resolve": host_resolve, "paired": paired,
           "batch_reads": len(batches[0]), "batches": len(batches),
           "reads": nreads}
    cfg = PipelineConfig(host_resolve=host_resolve)
    pipe = Pipe(idx, cfg, device=dev, dfm=dfm)
    dfm = pipe.dfm
    eng = pipe.engine
    presolve = pipe.native is not None and pipe.presolve
    kw = dict(presolve=presolve, khits=cfg.classifier.khits,
              ihits=pipe.classifier.ihits)
    art.update(resolver=type(pipe.resolver).__name__, presolve=presolve)
    stream = pipe.classify_stream_paired if paired \
        else pipe.classify_stream_unpaired
    t0 = time.perf_counter()
    for _ in stream(batches[:1]):
        pass
    log(f"{nreads} reads in {len(batches)} batches on {dev}, index "
        f"bwt_len={idx.bwt_len}; warm-up stream "
        f"{time.perf_counter() - t0:.2f} s; resolver={art['resolver']} "
        f"presolve={presolve}")

    # ---- 1. the search per batch: host clock, and the launch alone
    # (device timings: on the card only) ----
    fetch_s, search_ms, presolve_ms = [], [], []
    for b in batches if on_card else batches[-1:]:
        units, active, _, _ = prepare(pipe, b, paired)
        seqs = lane_seqs(units, active)
        if on_card:
            t0 = time.perf_counter()
            h = eng.search_async(seqs, **kw)
            eng.search_collect(h, len(seqs))
            fetch_s.append(time.perf_counter() - t0)
            s_ms, p_ms = device_only_ms(pipe, seqs, presolve)
            search_ms.append(s_ms)
            if p_ms is not None:
                presolve_ms.append(p_ms)
    art["lanes"] = len(seqs)   # of the last batch
    art["device_search_fetch_ms"] = _median_ms(fetch_s) if fetch_s \
        else None
    art["device_search_fetch_runs_ms"] = [_ms(t) for t in fetch_s] or None
    art["device_compute_ms"] = statistics.median(search_ms) \
        if search_ms else None
    art["device_compute_runs_ms"] = search_ms or None
    art["device_presolve_ms"] = statistics.median(presolve_ms) \
        if presolve_ms else None
    if on_card:
        log(f"search+fetch per batch (host clock): "
            f"{[f'{_ms(t):.1f}' for t in fetch_s]} ms; search launch "
            f"alone (CUDA events): {[f'{t:.3f}' for t in search_ms]} ms; "
            f"K5+K3: {[f'{t:.3f}' for t in presolve_ms]} ms")

    # ---- 2. dispatch against block, on the last batch ----
    t0 = time.perf_counter()
    h = eng.search_async(seqs, **kw)
    art["dispatch_ms"] = _ms(time.perf_counter() - t0)
    t0 = time.perf_counter()
    eng.search_collect(h, len(seqs))
    art["transfer_block_ms"] = _ms(time.perf_counter() - t0)
    log(f"dispatch {art['dispatch_ms']:.2f} ms + block "
        f"{art['transfer_block_ms']:.2f} ms")

    # ---- 3. the host tail alone, replayed on the last batch ----
    units, active, item, seeds = prepare(pipe, batches[-1], paired)
    fut = pipe._dispatch_units(units, active)
    collected = pipe._collect(fut[2], len(fut[0]))
    finish = pipe._finish_paired if paired else pipe._finish_batch
    tail_s = []
    for _ in range(runs):
        t0 = time.perf_counter()
        finish(*item, fut, seeds, collected=collected)
        tail_s.append(time.perf_counter() - t0)
    art["host_tail_ms"] = _median_ms(tail_s)
    art["host_tail_runs_ms"] = [_ms(t) for t in tail_s]
    log(f"host tail per batch: {[f'{_ms(t):.1f}' for t in tail_s]} ms")

    # ---- 4. the main thread's host work, split by step ----
    split = replay_main_thread(pipe, batches, paired)
    nb = len(batches)
    art["host_prep_ms"] = _ms(split.pop("total")) / nb
    names = PAIRED_STEPS if paired else UNPAIRED_STEPS
    art["host_prep_split_ms"] = {k: _ms(split[k]) / nb for k in names}
    log("main thread per batch: " + ", ".join(
        f"{k} {v:.2f}" for k, v in art["host_prep_split_ms"].items())
        + f" ms; total {art['host_prep_ms']:.2f} ms")

    # ---- 5. streams end to end, serial and threaded ----
    for label, threaded in (("serial", False), ("threaded", True)):
        rates = []
        for _ in range(runs):
            p2 = Pipe(idx, replace(cfg, threaded_stream=threaded),
                      device=dev, dfm=dfm)
            go = p2.classify_stream_paired if paired \
                else p2.classify_stream_unpaired
            t0 = time.perf_counter()
            for _ in go(batches):
                pass
            rates.append(nreads / (time.perf_counter() - t0))
        m = p2.metrics
        art[f"e2e_{label}_reads_per_sec"] = statistics.median(rates)
        art[f"e2e_{label}_runs"] = rates
        art[f"e2e_{label}_collect_wait_s"] = m.collect_wait_secs
        art[f"e2e_{label}_tail_wait_s"] = m.tail_wait_secs
        art[f"e2e_{label}_tail_run_s"] = m.tail_run_secs
        art[f"e2e_{label}_batches"] = m.batches
        log(f"e2e {label}: {[f'{x:.0f}' for x in rates]} reads/s; "
            f"collect_wait {m.collect_wait_secs:.3f} s tail_wait "
            f"{m.tail_wait_secs:.3f} s tail_run {m.tail_run_secs:.3f} s")
    nbat = max(m.batches, 1)
    art["upload_mb_per_batch"] = m.upload_bytes / 1e6 / nbat
    art["download_mb_per_batch"] = m.download_bytes / 1e6 / nbat
    art["resolve_rows_per_batch"] = m.resolve_rows / nbat

    # ---- 6. the device's idle share over a threaded stream ----
    if on_card:
        p3 = Pipe(idx, cfg, device=dev, dfm=dfm)
        secs, prof_idle, ops, ev_idle, ndisp = profiled_stream(
            p3, batches, paired)
        ev_idle["dispatches"] = ndisp
        if prof_idle is not None:
            share = dict(value=prof_idle["value"],
                         method="torch.profiler: 1 - union of the card's "
                                "kernel and copy records / the stream's "
                                "wall window", profiler=prof_idle)
        else:
            share = dict(value=ev_idle["value"],
                         method="CUDA events around each engine dispatch "
                                "(upload start to output copy end); "
                                "torch.profiler recorded no device time",
                         profiler=None)
            log("torch.profiler recorded no device time: the idle share "
                "is the CUDA-event one")
        share["events"] = ev_idle
        share["stream_reads_per_sec"] = nreads / secs
        art["device_idle_share"] = share
        art["device_ops"] = ops
        log(f"device idle share {share['value']:.4f} ({share['method']}); "
            f"by events {ev_idle['value']:.4f} over {ndisp} dispatches")
        for op in ops:
            log(f"  {op['total_ms']:9.3f} ms {op['calls']:5d}x {op['name']}")
        gaps = (share["profiler"] or ev_idle)["longest_idle_gaps"]
        log("longest idle gaps (ms into the window: ms): " + ", ".join(
            f"{g['start_ms']:.1f}: {g['ms']:.1f}" for g in gaps))
    else:
        art["device_idle_share"] = dict(value=None,
                                        method="not measured: no card")
        art["device_ops"] = None

    # ---- 7. steps per lane of the plain search loop ----
    if steps:
        units, active, _, _ = prepare(pipe, batches[0], paired)
        seqs = lane_seqs(units, active)
        lmax = em._bucket_len(max(len(s) for s in seqs), lo=eng.lmax_lo)
        rseqp, lengths = eng.pack_transport(seqs, lmax, len(seqs))
        stats = {}
        t0 = time.perf_counter()
        em.search_plain(dfm, torch.from_numpy(rseqp).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        torch.zeros(len(seqs), dtype=torch.int32,
                                    device=dev),
                        min(eng.FIRST_MAX_HITS, lmax), eng.min_hitlen,
                        eng.increment, False, eng._deep(lmax), stats=stats)
        live = torch.cat(stats["steps"]).cpu().numpy()[lengths > 0]
        mx = int(live.max())
        art["lockstep_mean_steps"] = float(live.mean())
        art["lockstep_max_steps"] = mx
        art["lockstep_survivors"] = [
            dict(fraction=f, step=int(np.quantile(live, 1 - f)))
            for f in SURVIVOR_FRACTIONS]
        log(f"steps per lane: mean {live.mean():.1f} max {mx} "
            f"(plain loop {time.perf_counter() - t0:.2f} s)")
        for s in art["lockstep_survivors"]:
            log(f"  {s['fraction'] * 100:5.1f}% of lanes still active at "
                f"step {s['step']} ({s['step'] / mx * 100:.0f}% of max)")
    art["index_bwt_len"] = int(idx.bwt_len)
    return art


def _reads(args, tmp: str, need: int):
    """The reads (or pairs) to profile: --reads/--reads2, else reads
    simulated from the synth database into tmp."""
    from ..io.fastx import read_batch, read_fastx
    if args.reads is None:
        from .simulate import SimConfig, simulate
        prefix = os.path.join(tmp, "sim")
        simulate(os.path.join(FIXDIR, "db.fa"),
                 os.path.join(FIXDIR, "conv.dmp"), prefix,
                 SimConfig(num_fragments=need, read_length=150,
                           paired=args.paired, error_rate=0.002, seed=42))
        if args.paired:
            args.reads, args.reads2 = prefix + "_1.fq", prefix + "_2.fq"
        else:
            args.reads = prefix + ".fq"
    if args.paired:
        return list(zip(read_fastx(args.reads), read_fastx(args.reads2)))
    return read_batch([args.reads])


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m centrifuge_tpu_torch.evaluation.prof",
        description="Cost breakdown of the GPU pipeline's main path")
    p.add_argument("--index", default=os.path.join(FIXDIR, "synth"))
    p.add_argument("--reads", default=None,
                   help="FASTQ/FASTA reads (mate 1 with --paired); "
                        "default: simulated from the synth database")
    p.add_argument("--reads2", default=None, help="mate 2 with --paired")
    p.add_argument("--paired", action="store_true")
    p.add_argument("--batch", type=int, default=BATCH,
                   help=f"reads (pairs) a batch (default {BATCH})")
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--runs", type=int, default=3,
                   help="streams of each kind end to end")
    p.add_argument("--no-host-resolve", action="store_true",
                   help="resolve SA rows on the card (K5 + K3)")
    p.add_argument("--no-steps", action="store_true",
                   help="skip the plain loop's steps per lane")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions; device timings null)")
    p.add_argument("--out", default=None,
                   help="also write the JSON line to this file")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if args.paired and args.reads is not None and args.reads2 is None:
        print("prof: --paired with --reads needs --reads2", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print(f"prof: no CUDA card for --device {args.device}",
              file=sys.stderr)
        return 2
    from ..index.cf_io import load_cf_index
    idx = load_cf_index(args.index)
    with tempfile.TemporaryDirectory(prefix="cftorch_prof_") as tmp:
        reads = _reads(args, tmp, args.batches * args.batch)
    n = min(len(reads), args.batches * args.batch) // args.batch * args.batch
    if n == 0:
        print(f"prof: fewer than {args.batch} reads", file=sys.stderr)
        return 2
    batches = [reads[i: i + args.batch] for i in range(0, n, args.batch)]
    art = profile(idx, batches, paired=args.paired,
                  host_resolve=not args.no_host_resolve, device=args.device,
                  runs=args.runs, steps=not args.no_steps,
                  log=lambda s: print(s, flush=True))
    line = json.dumps(art)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
