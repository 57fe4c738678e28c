"""`centrifuge-build` CLI (centrifuge_build.cpp:554 + Python wrapper)."""

from __future__ import annotations

import argparse
import sys
from typing import List


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="centrifuge-build", allow_abbrev=False,
        description="Build a Centrifuge-compatible .cf index (TPU-native "
        "builder: native SA-IS + vectorized BWT emission)")
    p.add_argument("--conversion-table", required=True, metavar="<file>",
                   help="seqID to taxID conversion table")
    p.add_argument("--taxonomy-tree", required=True, metavar="<file>",
                   help="taxonomy tree (nodes.dmp)")
    p.add_argument("--name-table", default="", metavar="<file>",
                   help="names file (names.dmp)")
    p.add_argument("--size-table", default="", metavar="<file>",
                   help="table of contig/genome sizes")
    p.add_argument("-o", "--offrate", type=int, default=4, metavar="<int>",
                   help="SA sample rate: sample 1 row per 2^<int> (default 4)")
    p.add_argument("-t", "--ftabchars", type=int, default=10, metavar="<int>",
                   help="# of chars consumed by the initial lookup (default 10)")
    p.add_argument("--linerate", type=int, default=7, metavar="<int>",
                   help="line rate: 2^<int> bytes per side (default 7)")
    p.add_argument("-p", "--threads", type=int, default=1, metavar="<int>",
                   help="accepted for compatibility")
    p.add_argument("--bmax", type=int, default=None, metavar="<int>",
                   help="max suffixes per blockwise-sort block; setting "
                   "this (or --bmaxdivn) selects the bounded-memory "
                   "blockwise builder")
    p.add_argument("--bmaxdivn", type=int, default=None, metavar="<int>",
                   help="max suffixes per block as a fraction of the "
                   "total length (reference default 4)")
    p.add_argument("--dcv", type=int, default=1024, metavar="<int>",
                   help="difference-cover period for the blockwise "
                   "builder (power of 2, default 1024)")
    p.add_argument("--noauto", action="store_true",
                   help="accepted for compatibility")
    p.add_argument("--nodc", action="store_true",
                   help="accepted for compatibility")
    p.add_argument("--kmer-count", type=int, default=0, metavar="<int>",
                   help="print distinct k-mer counts up to <int>")
    p.add_argument("--seed", type=int, default=0, metavar="<int>")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("reference_in", metavar="<reference_in>",
                   help="comma-separated FASTA files")
    p.add_argument("cf_index_base", metavar="<cf_index_base>",
                   help="base name for the output index files")
    return p


def run(argv: List[str]) -> int:
    args = make_parser().parse_args(argv)
    from ..build.builder import build_index
    fastas = [f for f in args.reference_in.split(",") if f]
    bmax = args.bmax
    blockwise = None
    if bmax is None and args.bmaxdivn is not None:
        # resolved against the scanned length inside the blockwise path
        bmax = -args.bmaxdivn  # sentinel: divide-by-n
        blockwise = True
    build_index(
        fastas, args.cf_index_base,
        conversion_table=args.conversion_table,
        taxonomy_tree=args.taxonomy_tree,
        name_table=args.name_table,
        size_table=args.size_table,
        offrate=args.offrate,
        ftab_chars=args.ftabchars,
        line_rate=args.linerate,
        verbose=not args.quiet,
        bmax=bmax, dcv=args.dcv, blockwise=blockwise,
        nthreads=args.threads,
    )
    if args.kmer_count > 0:
        from ..build.ref_read import scan_fastas
        import numpy as np
        codes, szs, _, _ = scan_fastas(fastas)
        counts = _distinct_kmers(codes, szs, args.kmer_count)
        for k, c in enumerate(counts):
            print(f"Number of distinct {k+1}-mers is {c}", file=sys.stderr)
    return 0


def _distinct_kmers(codes, szs, max_k: int):
    """Distinct k-mer counts per k, not crossing fragment boundaries
    (bt2_idx.h:3482-3502,3621-3639)."""
    import numpy as np
    # fragment end offsets in the joined string
    ends = []
    total = 0
    for r in szs:
        if r.length > 0:
            total += r.length
            ends.append(total)
    ends = np.asarray(ends, dtype=np.int64)
    counts = []
    vals = codes.astype(np.int64)
    packed = np.zeros_like(vals)
    for k in range(1, max_k + 1):
        if vals.shape[0] < k:
            counts.append(0)
            continue
        packed = (packed[: vals.shape[0] - k + 1] << 2) + vals[k - 1:]
        # positions whose k-mer stays inside one fragment
        pos = np.arange(packed.shape[0])
        frag = np.searchsorted(ends, pos, side="right")
        ok = pos + k <= ends[np.minimum(frag, ends.shape[0] - 1)]
        counts.append(int(np.unique(packed[ok]).shape[0]))
    return counts


def main() -> None:
    sys.exit(run(sys.argv[1:]))
