"""Multi-process scaling harness.

Run one copy per process:

    python -m centrifuge_tpu_torch.parallel.scaling_bench \
        --coordinator localhost:12555 --nprocs N --procid I \
        -x IDX -U READS.fq [--n-fm F] [--batch B] [--local-devices D] \
        [--limit N] [--out SHARD.tsv] [--device cpu]

Each process joins a gloo group (parallel/multihost.py initialize),
builds its pipeline over its own mesh of D local devices, n_fm shards a
dp row (make_multihost_pipeline), and classifies its contiguous share of
the reads; process 0 prints one JSON line with the aggregate reads/s and
each process its kernel launches. Weak-scaling efficiency at N processes
= throughput(N) / (N * throughput(1)).

The mesh is D entries of cuda:0, or the first D cards where there are
that many; --device cpu runs it on CPU devices (the plain versions).

    python -m centrifuge_tpu_torch.parallel.scaling_bench --virtual-dp \
        --dp P -x IDX -U READS.fq [--per-device-batch B] [--batches K]

classifies B reads per mesh row over a (P, 1) mesh of cuda:0 (one point
of a dp curve), and

    python -m centrifuge_tpu_torch.parallel.scaling_bench --sweep \
        [-x IDX] [-U READS.fq] [--with-dp-curve] [--trials T] [--out F]

runs the legs at 1 and 2 processes (and, with --with-dp-curve, dp = 1,
2, 4, 8) and writes the curves; without -U it simulates SWEEP_READS
reads from the synth genomes into a temporary directory and times
SWEEP_READS / 2 reads a process. What this measures depends on the
machine, and the artifact says which: on a machine with one card every
process and every mesh row shares that card, so the curves measure how
the card and the host are shared, not how the system scales across
cards or hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

SWEEP_PROCS = (1, 2)
CORES_PER_PROCESS = 2
# the sweep's default reads: bench.py's throughput set (196,608 reads of
# 150 bp simulated from the synth genomes, 0.2% substitutions, seed 42),
# so each process of the widest leg times SWEEP_READS // max(SWEEP_PROCS)
# reads: a timed region of seconds, not of a few batches
SWEEP_READS = 196_608
SWEEP_BATCH = 1024
SWEEP_DP_BATCHES = 24          # batches of each dp point
SYNTH = os.path.join("tests", "fixtures", "synth")


def _devices(n: int, device: str):
    """n mesh entries: the first n cards, or cuda:0 repeated where there
    are fewer; CPU devices for device "cpu"."""
    import torch
    from ..ops.fm_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def hardware() -> dict:
    """What the machine offers the processes: its cards and cores."""
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"cards": cards,
            "card": torch.cuda.get_device_name(0) if cards else None,
            "cores": len(os.sched_getaffinity(0))}


def caveat(hw: dict) -> str:
    if hw["cards"] == 1:
        return (f"one card ({hw['card']}) shared by every process and every "
                "mesh row: the curves measure how the card and the host's "
                f"{hw['cores']} cores are shared, not scaling across cards "
                "or hosts")
    if hw["cards"] == 0:
        return (f"no card: CPU devices on {hw['cores']} cores; the curves "
                "measure the plain versions on a shared host")
    return (f"{hw['cards']} cards on one host: a process's mesh takes the "
            "first --local-devices cards, so every process shares them")


def _virtual_dp_leg(argv):
    """One dp point: classify a fixed read count per mesh row over a
    (dp, 1) mesh of cuda:0; prints one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, required=True)
    ap.add_argument("-x", dest="index", required=True)
    ap.add_argument("-U", dest="reads", required=True)
    ap.add_argument("--per-device-batch", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..classify.gpu_pipeline import GPUClassificationPipeline
    from ..index.cf_io import load_cf_index
    from ..io.fastx import read_batch
    from ..ops.fm_torch import resolve_device
    from .sharded import make_mesh

    dev = resolve_device(args.device)
    idx = load_cf_index(args.index)
    pipe = GPUClassificationPipeline(
        idx, device=dev, mesh=make_mesh(args.dp, 1, [dev] * args.dp))
    B = args.per_device_batch * args.dp       # weak scaling: fixed a row
    n = B * args.batches
    reads = read_batch([args.reads])
    while len(reads) < n:                     # tile if the file is short
        reads = reads + reads
    reads = reads[:n]
    for _ in pipe.classify_stream_unpaired([reads[:B]]):
        pass                                  # warm-up
    t0 = time.perf_counter()
    for _ in pipe.classify_stream_unpaired(
            reads[i: i + B] for i in range(0, n, B)):
        pass
    dt = time.perf_counter() - t0
    print(json.dumps({"dp": args.dp, "reads": n,
                      "reads_per_sec": round(n / dt, 1),
                      "seconds": round(dt, 3), "device": str(dev)}))
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _sweep(argv):
    """The 1- and 2-process weak-scaling legs (and, with --with-dp-curve,
    the dp = 1, 2, 4, 8 points), each process pinned to its own
    CORES_PER_PROCESS cores with taskset when the host has them, so the
    legs compare equal per-process host resources; the artifact says when
    it could not pin. Reference analog: pthread scaling,
    MANUAL.markdown:1000-1010."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-x", dest="index", default=os.path.join(SYNTH, "synth"))
    ap.add_argument("-U", dest="reads", default=None,
                    help="default: SWEEP_READS reads simulated from the "
                         "synth genomes")
    ap.add_argument("--per-device-batch", type=int, default=2048)
    ap.add_argument("--out", default=None)
    ap.add_argument("--with-dp-curve", action="store_true",
                    help="also run the dp = 1, 2, 4, 8 points")
    ap.add_argument("--trials", type=int, default=3,
                    help="repeats of each multi-process leg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.reads is None:
        with tempfile.TemporaryDirectory(prefix="cftorch_sweep_") as tmp:
            from ..evaluation.simulate import SimConfig, simulate
            prefix = os.path.join(tmp, "sweep")
            simulate(os.path.join(SYNTH, "db.fa"),
                     os.path.join(SYNTH, "conv.dmp"), prefix,
                     SimConfig(num_fragments=SWEEP_READS, read_length=150,
                               error_rate=0.002, seed=42))
            args.reads = prefix + ".fq"
            return _run_sweep(args, f"{SWEEP_READS} reads of 150 bp "
                              "simulated from the synth genomes (0.2% "
                              "substitutions, seed 42)")
    return _run_sweep(args, args.reads)


def _run_sweep(args, read_set: str):
    hw = hardware()
    cores = sorted(os.sched_getaffinity(0))
    pin = shutil.which("taskset") is not None \
        and len(cores) >= CORES_PER_PROCESS * max(SWEEP_PROCS)
    me = [sys.executable, "-m", "centrifuge_tpu_torch.parallel.scaling_bench"]

    dp_curve = None
    if args.with_dp_curve:
        dp_curve = []
        for dp in (1, 2, 4, 8):
            r = subprocess.run(
                me + ["--virtual-dp", "--dp", str(dp), "-x", args.index,
                      "-U", args.reads, "--device", args.device,
                      "--per-device-batch", str(args.per_device_batch),
                      "--batches", str(SWEEP_DP_BATCHES)],
                capture_output=True, text=True, timeout=900)
            if r.returncode:
                print(r.stdout, r.stderr, file=sys.stderr)
                raise RuntimeError(f"dp={dp} leg failed")
            rec = _json_line(r.stdout)
            rec["weak_efficiency"] = (
                round(rec["reads_per_sec"]
                      / (dp * dp_curve[0]["reads_per_sec"]), 3)
                if dp_curve else 1.0)
            dp_curve.append(rec)
            print(f"dp={dp}: {rec['reads_per_sec']} reads/s "
                  f"eff={rec['weak_efficiency']}", flush=True)

    host_curve = []
    for nprocs in SWEEP_PROCS:
        runs = []
        for trial in range(args.trials):
            port = _free_port()
            procs = []
            try:
                for pid in range(nprocs):
                    own = cores[CORES_PER_PROCESS * pid:
                                CORES_PER_PROCESS * (pid + 1)]
                    cmd = (["taskset", "-c", ",".join(map(str, own))]
                           if pin else []) + me + [
                        "--coordinator", f"localhost:{port}",
                        "--nprocs", str(nprocs), "--procid", str(pid),
                        "--local-devices", "2", "-x", args.index,
                        "-U", args.reads, "--batch", str(SWEEP_BATCH),
                        "--limit", str(SWEEP_READS // max(SWEEP_PROCS)
                                       * nprocs),
                        "--device", args.device]
                    procs.append(subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True))
                outs = [(p.communicate(timeout=900), p.returncode)
                        for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(rc for _, rc in outs):
                for (out, err), rc in outs:
                    print(rc, out[-500:], err[-1000:], file=sys.stderr)
                raise RuntimeError(f"nprocs={nprocs} leg failed")
            runs.append(_json_line(outs[0][0][0]))
            print(f"nprocs={nprocs} trial {trial}: "
                  f"{runs[-1]['aggregate_reads_per_sec']} reads/s",
                  flush=True)
        rates = sorted(r["aggregate_reads_per_sec"] for r in runs)
        rec = {k: runs[0][k] for k in
               ("metric", "nprocs", "n_fm", "per_process_reads")}
        rec["aggregate_reads_per_sec"] = rates[len(rates) // 2]
        rec["trial_rates"] = rates
        rec["trial_spread_pct"] = round(
            100 * (rates[-1] - rates[0]) / rates[len(rates) // 2], 1)
        rec["pinned_cores_per_process"] = CORES_PER_PROCESS if pin else None
        rec["weak_efficiency"] = (
            round(rec["aggregate_reads_per_sec"]
                  / (nprocs * host_curve[0]["aggregate_reads_per_sec"]), 3)
            if host_curve else 1.0)
        host_curve.append(rec)
        print(f"nprocs={nprocs}: median {rec['aggregate_reads_per_sec']} "
              f"aggregate reads/s eff={rec['weak_efficiency']} "
              f"spread={rec['trial_spread_pct']}%", flush=True)

    artifact = {
        "metric": "scaling_efficiency",
        "weak_scaling_multiprocess_curve": host_curve,
        "dp_curve": dp_curve,
        "read_set": read_set,
        "hardware": hw,
        "pinning": (f"{CORES_PER_PROCESS} cores a process (taskset)" if pin
                    else f"not pinned: the host gives this process "
                         f"{len(cores)} cores, the legs need "
                         f"{CORES_PER_PROCESS * max(SWEEP_PROCS)}, or "
                         "taskset is missing"),
        "hardware_caveat": caveat(hw),
    }
    text = json.dumps(artifact, indent=1)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sweep" in argv:
        argv.remove("--sweep")
        return _sweep(argv)
    if "--virtual-dp" in argv:
        argv.remove("--virtual-dp")
        return _virtual_dp_leg(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True,
                    help="host:port of the gloo group's TCP store")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--procid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="this process's mesh size, dp x n_fm (default: "
                         "every card; 1 with --device cpu)")
    ap.add_argument("-x", dest="index", required=True)
    ap.add_argument("-U", dest="reads", required=True)
    ap.add_argument("--n-fm", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write this process's TSV rows here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import _cuda
    from . import multihost
    from ..index.cf_io import load_cf_index
    from ..io.fastx import read_batch

    import torch
    n_dev = args.local_devices or (
        1 if args.device == "cpu" else torch.cuda.device_count())
    devices = _devices(n_dev, args.device)
    multihost.initialize(args.coordinator, args.nprocs, args.procid)
    idx = load_cf_index(args.index)
    pipe = multihost.make_multihost_pipeline(idx, n_fm=args.n_fm,
                                             devices=devices)
    reads = read_batch([args.reads], limit=args.limit or None)
    # equal shares, so every process runs the same batch count
    per = len(reads) // args.nprocs
    mine = reads[args.procid * per: (args.procid + 1) * per]

    B = args.batch
    rows = []
    for _ in pipe.classify_stream_unpaired([mine[:B]]):
        pass                                  # warm-up
    t0 = time.perf_counter()
    for chunk in pipe.classify_stream_unpaired(
            mine[i: i + B] for i in range(0, per - per % B, B)):
        rows += chunk
    dt = time.perf_counter() - t0
    n_done = per - per % B
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(rows) + "\n")
    multihost.sync_max(n_done)                # all processes finished
    line = {"procid": args.procid, "launches": dict(_cuda.LAUNCHES),
            "mesh": [len(devices) // args.n_fm, args.n_fm],
            "devices": [str(d) for d in devices]}
    if args.procid == 0:
        line = {
            "metric": "multihost_reads_per_sec",
            "nprocs": args.nprocs,
            "n_fm": args.n_fm,
            "per_process_reads": n_done,
            "per_process_seconds": round(dt, 3),
            "aggregate_reads_per_sec": round(args.nprocs * n_done / dt, 1),
            "hardware_caveat": caveat(hardware()),
            **line,
        }
    print(json.dumps(line), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
