"""`centrifuge-promote` CLI (the reference's Perl script, byte-parity).

Re-maps each read's assignments to the requested rank (walking up the
taxonomy), dedupes same-target rows per read, rewrites the seqID column
to the target's rank string, and refreshes numMatches; rank 'lca'
collapses each read's rows to their LCA (centrifuge-promote:43-175).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-promote", allow_abbrev=False)
    p.add_argument("index", metavar="<index>")
    p.add_argument("input", metavar="<classification.tsv>",
                   help="Centrifuge output file ('-' for stdin)")
    p.add_argument("rank", metavar="<rank>",
                   help="Target rank (e.g. species, genus) or 'lca'")
    return p


def run(argv: List[str]) -> int:
    args = make_parser().parse_args(argv)
    from ..index.cf_io import load_cf_index
    from ..index.taxonomy import rank_string

    idx = load_cf_index(args.index, load_sa_sample=False)
    # the Perl script builds these from `centrifuge-inspect
    # --taxonomy-tree` output: tid -> rank string, tid -> parent
    tax_level: Dict[int, str] = {}
    tax_parent: Dict[int, int] = {}
    for tid, node in idx.taxonomy.tree.items():
        tax_level[tid] = rank_string(node.rank)
        tax_parent[tid] = node.parent

    level = args.rank

    def promote(tid: int) -> int:
        seen = set()
        while True:
            if tid <= 0 or tid not in tax_level:
                return 0
            if tax_level[tid] == level:
                return tid
            if tid <= 1 or tid in seen:
                return 0
            seen.add(tid)
            tid = tax_parent.get(tid, 0)

    def lca(a: int, b: int) -> int:
        if a == 0:
            return b
        if b == 0:
            return a
        if a == b:
            return a
        apath = set()
        t = a
        while t >= 1:
            apath.add(t)
            if t not in tax_parent or t == tax_parent[t]:
                break
            t = tax_parent[t]
        t = b
        while t > 1:
            if t in apath:
                return t
            if t not in tax_parent or t == tax_parent[t]:
                break
            t = tax_parent[t]
        return 1

    out = sys.stdout
    f = sys.stdin if args.input == "-" else open(args.input)
    header = f.readline()
    out.write(header)

    def flush(lines: List[str]) -> None:
        if not lines:
            return
        new_lines: List[List[str]] = []
        if level != "lca":
            showed = set()
            for line in lines:
                cols = line.split("\t")
                tid = int(cols[2].split(".")[0])
                new_tid = promote(tid)
                if new_tid <= 1:
                    new_tid = tid
                new_level = cols[1]
                if new_tid >= 1 and new_tid in tax_level:
                    new_level = tax_level[new_tid]
                if new_tid in showed:
                    continue
                showed.add(new_tid)
                cols[2] = str(new_tid)
                cols[1] = new_level
                new_lines.append(cols)
        else:
            t = int(lines[0].split("\t")[2].split(".")[0])
            for line in lines[1:]:
                t = lca(t, int(line.split("\t")[2].split(".")[0]))
            cols = lines[0].split("\t")
            if str(t) != cols[2] and t in tax_level:
                cols[1] = tax_level[t]
            cols[2] = str(t)
            new_lines.append(cols)
        nmatches = len(new_lines)
        for cols in new_lines:
            cols[-1] = str(nmatches)
            out.write("\t".join(cols) + "\n")

    prev = ""
    group: List[str] = []
    for line in f:
        line = line.rstrip("\n")
        rid = line.split("\t", 1)[0]
        if rid == prev:
            group.append(line)
        else:
            prev = rid
            flush(group)
            group = [line]
    flush(group)
    if f is not sys.stdin:
        f.close()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))
