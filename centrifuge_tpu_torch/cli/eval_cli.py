"""`simulate` / `evaluate` CLI entries (evaluation/ harness).

  python -m centrifuge_tpu simulate -x db.fa --conversion-table c.dmp \\
      -o sim --num 10000 [--paired] [--error-rate 0.002]
  python -m centrifuge_tpu evaluate -x idx classification.tsv \\
      [--truth sim.truth]
"""

from __future__ import annotations

import argparse
import sys
from typing import List


def make_sim_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-simulate", allow_abbrev=False)
    p.add_argument("-x", dest="fasta", required=True, metavar="<fasta>",
                   help="database FASTA to sample fragments from")
    p.add_argument("--conversion-table", required=True, metavar="<file>")
    p.add_argument("-o", dest="out_prefix", required=True, metavar="<prefix>")
    p.add_argument("--num", type=int, default=10000, metavar="<int>",
                   help="number of fragments")
    p.add_argument("--read-length", type=int, default=100, metavar="<int>")
    p.add_argument("--paired", action="store_true")
    p.add_argument("--error-rate", type=float, default=0.0, metavar="<float>")
    p.add_argument("--expr-profile", default="uniform",
                   choices=["uniform", "dna"])
    p.add_argument("--seed", type=int, default=0)
    return p


def run_simulate(argv: List[str]) -> int:
    args = make_sim_parser().parse_args(argv)
    from ..evaluation.simulate import SimConfig, simulate
    simulate(args.fasta, args.conversion_table, args.out_prefix,
             SimConfig(num_fragments=args.num, read_length=args.read_length,
                       paired=args.paired, error_rate=args.error_rate,
                       expr_profile=args.expr_profile, seed=args.seed))
    print(f"wrote {args.out_prefix}"
          + ("_1.fq/_2.fq" if args.paired else ".fq")
          + f" and {args.out_prefix}.truth", file=sys.stderr)
    return 0


def make_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="centrifuge-evaluate", allow_abbrev=False)
    p.add_argument("-x", dest="index", required=True, metavar="<cf-idx>")
    p.add_argument("--truth", default=None, metavar="<file>",
                   help=".truth table (else truth is parsed from read names)")
    p.add_argument("--sql-db", default=None, metavar="<path>",
                   help="append results to a sqlite DB with the "
                   "reference's Classification table schema "
                   "(centrifuge_evaluate.py:180-230)")
    p.add_argument("--read-base", default="", metavar="<str>")
    p.add_argument("--read-type", default="single", metavar="<str>")
    p.add_argument("classification", metavar="<tsv>",
                   help="Centrifuge classification output ('-' for stdin)")
    return p


def run_evaluate(argv: List[str]) -> int:
    args = make_eval_parser().parse_args(argv)
    from ..evaluation.evaluate import evaluate_classification, parse_truth
    from ..index.cf_io import load_cf_index

    idx = load_cf_index(args.index, load_sa_sample=False)
    truth = parse_truth(args.truth) if args.truth else {}
    f = sys.stdin if args.classification == "-" else open(args.classification)
    rows = f.read().splitlines()
    if f is not sys.stdin:
        f.close()
    res = evaluate_classification(idx.taxonomy, rows, truth)
    print(f"reads\t{res.reads}")
    print(f"unclassified\t{res.unclassified}")
    for name, sc in res.levels():
        print(f"{name}\t{sc.correct}/{sc.total}\t{sc.accuracy:.4f}")
    if args.sql_db:
        from ..evaluation.evaluate import log_result_sql
        from .. import __version__
        log_result_sql(args.sql_db, args.index, args.read_base,
                       args.read_type, res, 0.0,
                       cmd=" ".join(["centrifuge-evaluate"] + argv),
                       version=__version__)
    return 0
