"""`centrifuge-inspect` CLI (centrifuge_inspect.cpp:369-674).

Default: reconstruct the reference FASTA from the index (gaps restored
as Ns, 60 chars/line). -n prints sequence names; -s a summary;
--conversion-table/--taxonomy-tree/--name-table/--size-table dump the
taxonomy payload in the exact formats the kreport/promote tooling parses.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-inspect", allow_abbrev=False)
    p.add_argument("-n", "--names", action="store_true",
                   help="Print reference sequence names only")
    p.add_argument("-s", "--summary", action="store_true",
                   help="Print summary incl. index flags and sequence info")
    p.add_argument("--conversion-table", action="store_true",
                   help="Print the seqID to taxID conversion table")
    p.add_argument("--taxonomy-tree", action="store_true",
                   help="Print the taxonomy tree")
    p.add_argument("--name-table", action="store_true",
                   help="Print the taxID to name table")
    p.add_argument("--size-table", action="store_true",
                   help="Print the taxID to genome-size table")
    p.add_argument("-a", "--across", type=int, default=60, metavar="<int>",
                   help="Number of characters across in FASTA output")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("cf_base", metavar="<cf_base>",
                   help="index filename prefix (minus .X.cf)")
    return p


def _fmt_tid(tid: int) -> str:
    lo = tid & 0xFFFFFFFF
    hi = tid >> 32
    return f"{lo}.{hi}" if hi > 0 else str(lo)


def run(argv: List[str]) -> int:
    args = make_parser().parse_args(argv)
    from ..index.cf_io import load_cf_index
    from ..index.taxonomy import rank_string

    idx = load_cf_index(args.cf_base)
    out = sys.stdout

    if args.names:
        for name in idx.refnames:
            out.write(name + "\n")
        return 0
    if args.summary:
        out.write(f"Flags\t{1}\n")
        out.write(f"SA-Sample\t1 in {1 << idx.offrate}\n")
        out.write(f"FTab-Chars\t{idx.ftab_chars}\n")
        for i, name in enumerate(idx.refnames):
            out.write(f"Sequence-{i+1}\t{name}\t{int(idx.plen[i])}\n")
        return 0
    if args.conversion_table:
        for uid, tid in idx.uid_to_tid:
            out.write(f"{uid}\t{_fmt_tid(tid)}\n")
        return 0
    if args.taxonomy_tree:
        for tid in sorted(idx.taxonomy.tree):
            node = idx.taxonomy.tree[tid]
            out.write(f"{tid}\t|\t{node.parent}\t|\t{rank_string(node.rank)}\n")
        return 0
    if args.name_table:
        for tid in sorted(idx.taxonomy.names):
            out.write(f"{_fmt_tid(tid)}\t{idx.taxonomy.names[tid]}\n")
        return 0
    if args.size_table:
        for tid in sorted(idx.taxonomy.sizes):
            out.write(f"{_fmt_tid(tid)}\t{idx.taxonomy.sizes[tid]}\n")
        return 0

    # default: FASTA reconstruction (centrifuge_inspect.cpp:369-432)
    from ..ops.fm_numpy import FMOracle
    fm = FMOracle(idx)
    text = fm.restore_text()
    rstarts = idx.rstarts.astype(np.int64)
    for seq_i, name in enumerate(idx.refnames):
        buf = np.full(int(idx.plen[seq_i]), ord("N"), dtype=np.uint8)
        frags = rstarts[rstarts[:, 1] == seq_i]
        for joined_off, _, text_off in frags:
            # fragment length = distance to next fragment start (or len)
            nxt = rstarts[rstarts[:, 0] > joined_off][:, 0]
            upper = int(nxt.min()) if nxt.shape[0] else idx.length
            fl = upper - int(joined_off)
            chars = text[int(joined_off): int(joined_off) + fl]
            buf[int(text_off): int(text_off) + fl] = \
                np.frombuffer(b"ACGT", np.uint8)[chars]
        seq = buf.tobytes().decode()
        out.write(">" + name + "\n")
        if args.across > 0:
            for i in range(0, len(seq), args.across):
                out.write(seq[i: i + args.across] + "\n")
        else:
            out.write(seq + "\n")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))
