"""SHARDSCALE: the fm (BWT-range) sharding axis at multi-GB scale.

The reference's headline regime is one host classifying 4.2-64 GB
indexes (64-bit index: btypes.h:24-31). The port's answer to an index
larger than one card's memory is BWT-range sharding over the fm axis of
a (dp, fm) mesh (parallel/sharded.py, K6). This harness runs the whole
sharded pipeline (search, extension, SA resolve, native assignment) on
an index over a (dp, fm) mesh, byte-compares the TSV with a reference
TSV (or the reference binary's output), counts K6's launches per batch,
and prints the per-shard memory budget table that says which index
sizes fit one card per shard.

    python -m centrifuge_tpu_torch.parallel.shardscale <index_base> \
        <reads.fq> [--dp 2] [--fm 4] [--reads-count 2048] [--batch 1024] \
        [--ref-tsv golden.tsv | --ref-binary /path/centrifuge-class] \
        [--out SHARDSCALE.json] [--device cpu]

On the card the mesh repeats cuda:0 dp x fm times (make_mesh): one card
holds every shard, so the run checks the sharded path at scale, not
reads between cards. --device cpu runs the plain versions on a CPU mesh.

No collective census: the JAX harness counts the all-reduces of the
compiled sharded search; K6 has none (each read goes to the shard that
owns it, in place), so the line counts its launches per batch instead
(_cuda.LAUNCHES: one search launch per dp row per batch on a CUDA mesh;
0 on a CPU mesh, where the plain version runs).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# one H100 80GB HBM3's memory as torch reports it
# (torch.cuda.get_device_properties(0).total_memory on that card; the data
# sheet's 80 GB, less what CUDA keeps), so the CPU's table judges fits
# against the same size as the card's; on the card the budget reads the
# device's own total instead
H100_MEMORY_BYTES = 85_017_493_504
# a shard fits when its tables take under this share of the card's
# memory, leaving room for lane state and hit buffers
FIT_SHARE = 0.85
PROJECTIONS = ((None, "this_index"), (12_000_000_000, "12Gbp_pc_class"),
               (64_000_000_000, "64Gbp_nt_class"))
FM_SIZES = (1, 2, 4, 8, 16)


def budget(index, card_bytes: float) -> dict:
    """The per-shard memory budget of a MeshIndex, from its own tables:
    the block rows and SA samples of dp row 0's shards (linear in bases),
    the ftab pairs (constant: 4^ftab_chars entries), the replicated
    arrays on the row's lead (fchr, boundary rows and refs: one boundary
    row per genome, not per base, so the projections keep this index's),
    then per index size and fm: one shard's bytes and whether it fits."""
    row = index.rows[0]
    lin = sum(s.blocks.nbytes + s.offs.nbytes for s in row.shards)
    const = sum(s.ftab_tb.nbytes for s in row.shards)
    repl = row.fchr.nbytes + row.brows.nbytes + row.brefs.nbytes
    # an index of 2^31 bases or more is in the wide layout (40 words a
    # block row, 36 narrow): scale a narrow index's blocks to project it
    blk = sum(s.blocks.nbytes for s in row.shards)
    lin_wide = lin if index.wide else lin + blk * 4 // 36
    per_base = lin_wide / index.bwt_len
    table = {}
    for bases, label in PROJECTIONS:
        bases = bases or index.bwt_len
        tot = per_base * bases + const + repl
        entry = {"total_gb": round(tot / 1e9, 2)}
        for nf in FM_SIZES:
            shard = (per_base * bases + const) / nf + repl
            entry[f"fm{nf}_per_shard_gb"] = round(shard / 1e9, 2)
            entry[f"fm{nf}_fits_card"] = bool(shard < FIT_SHARE * card_bytes)
        table[label] = entry
    return {
        "measured_linear_sharded_bytes": int(lin),
        "measured_const_sharded_bytes": int(const),
        "measured_replicated_bytes": int(repl),
        "bytes_per_base_sharded": round(per_base, 3),
        "narrow_to_wide_adjusted": not index.wide,
        "card_bytes": int(card_bytes),
        "fit_share": FIT_SHARE,
        "table": table,
    }


def run(args) -> dict:
    """The harness's JSON line for parsed arguments."""
    import torch

    from .. import _cuda
    from ..classify.gpu_pipeline import GPUClassificationPipeline
    from ..index.cf_io import load_cf_index
    from ..io.fastx import read_batch
    from ..ops.fm_torch import resolve_device
    from .sharded import make_mesh

    dev = resolve_device(args.device)
    t0 = time.time()
    idx = load_cf_index(args.index_base)
    wide = idx.bwt_len >= (1 << 31)
    print(f"index: bwt_len={idx.bwt_len} wide={wide} "
          f"({time.time() - t0:.0f}s)", flush=True)
    reads = read_batch([args.reads], limit=args.reads_count)
    B = args.batch

    _cuda.reset_launches()
    t0 = time.time()
    mesh = make_mesh(args.dp, args.fm, [dev] * (args.dp * args.fm))
    pipe = GPUClassificationPipeline(idx, device=dev, mesh=mesh)
    up_s = time.time() - t0
    print(f"sharded pipeline up on (dp={args.dp}, fm={args.fm}) mesh "
          f"({up_s:.0f}s); resolver={type(pipe.resolver).__name__}",
          flush=True)

    t0 = time.time()
    rows = [pipe.formatter.header()]
    batches = [reads[i: i + B] for i in range(0, len(reads), B)]
    for chunk in pipe.classify_stream_unpaired(batches):
        rows += chunk
    wall = time.time() - t0
    ours = "\n".join(rows) + "\n"
    launches = dict(_cuda.LAUNCHES)
    print(f"classified {len(reads)} reads over the mesh in {wall:.1f}s",
          flush=True)

    parity = None
    if args.ref_tsv:
        with open(args.ref_tsv) as f:
            parity = f.read() == ours
    elif args.ref_binary:
        ref_out = args.index_base + ".shardscale.ref.tsv"
        r = subprocess.run(
            [args.ref_binary, "-x", args.index_base, "-U", args.reads,
             "-u", str(len(reads)), "-p", "4", "--reorder", "-S", ref_out,
             "--report-file", "/dev/null"], capture_output=True, text=True)
        print(f"reference rc: {r.returncode}", flush=True)
        with open(ref_out) as f:
            parity = f.read() == ours
    print(f"parity: {parity}", flush=True)

    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_properties(dev).total_memory if on_card \
        else H100_MEMORY_BYTES
    return {
        "metric": "shardscale_fm_axis_at_scale",
        "index_base": args.index_base,
        "bwt_len": int(idx.bwt_len),
        "wide": wide,
        "mesh": {"dp": args.dp, "fm": args.fm},
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "reads": len(reads),
        "batches": len(batches),
        "wall_s": round(wall, 3),
        "reads_per_sec": round(len(reads) / wall, 1),
        "mesh_index_s": round(up_s, 3),
        "parity_vs_reference_binary": parity,
        "resolver": type(pipe.resolver).__name__,
        "k6_launches": {k: launches[k]
                        for k in ("sharded_search", "sharded_resolve")},
        "k6_search_launches_per_batch":
            launches["sharded_search"] / len(batches),
        "mesh_index_bytes": int(pipe.mesh_index.nbytes),
        "max_memory_allocated":
            int(torch.cuda.max_memory_allocated(dev)) if on_card else None,
        "memory_budget": budget(pipe.mesh_index, card),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("index_base")
    ap.add_argument("reads")
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--fm", type=int, default=4)
    ap.add_argument("--reads-count", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ref-tsv", default=None)
    ap.add_argument("--ref-binary", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    line = run(args)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    return 1 if line["parity_vs_reference_binary"] is False else 0


if __name__ == "__main__":
    sys.exit(main())
