"""`centrifuge-kreport` CLI (the reference's Perl script, byte-parity).

Streams classification TSVs (files or stdin), LCA-merges multi-assigned
reads (or fractional counts with --no-lca), rolls counts up the clade
tree and prints the Kraken-style report.
"""

from __future__ import annotations

import argparse
import sys
from typing import List


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-kreport", allow_abbrev=False)
    p.add_argument("-x", dest="index", required=True, metavar="<index>",
                   help="Centrifuge index prefix")
    p.add_argument("--no-lca", action="store_true",
                   help="Report count fractions instead of per-read LCA")
    p.add_argument("--show-zeros", action="store_true",
                   help="Show clades with zero reads")
    p.add_argument("--is-count-table", action="store_true",
                   help="Input is 'taxID<tab>COUNT' lines")
    p.add_argument("--min-score", type=int, default=None, metavar="SCORE")
    p.add_argument("--min-length", type=int, default=None, metavar="LENGTH")
    p.add_argument("files", nargs="*", help="Centrifuge output files "
                   "(default: stdin)")
    return p


def run(argv: List[str]) -> int:
    args = make_parser().parse_args(argv)
    from ..index.cf_io import load_cf_index
    from ..report.writers import kreport_lines

    print("Loading taxonomy ...", file=sys.stderr)
    idx = load_cf_index(args.index, load_sa_sample=False)

    def lines():
        if not args.files:
            print("Reading centrifuge out file from STDIN ... ",
                  file=sys.stderr)
            yield from sys.stdin
        else:
            for path in args.files:
                with open(path) as f:
                    yield from f

    precounted = None
    pre_total = None
    if args.is_count_table:
        # mirror the Perl exactly (centrifuge-kreport:72-77): duplicate
        # taxID rows OVERWRITE the per-taxon count (last row wins) while
        # seq_count accumulates every row; non-numeric keys (e.g. dotted
        # lo.hi ids) never match a numeric tree node, so they count only
        # toward the total
        precounted = {}
        pre_total = 0.0
        for line in lines():
            parts = line.split()
            if len(parts) < 2:
                continue
            count = float(parts[1])
            pre_total += count
            if parts[0].isdigit():
                precounted[int(parts[0])] = count
        src = iter(())
    else:
        src = lines()

    for line in kreport_lines(idx, src, no_lca=args.no_lca,
                              min_score=args.min_score,
                              min_length=args.min_length,
                              show_zeros=args.show_zeros,
                              precounted=precounted,
                              precount_total=pre_total):
        print(line)
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))
