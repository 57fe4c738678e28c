"""Reads simulated from the synth fixture's genomes
(tests/fixtures/synth/db.fa): 150 bp, 0.2% substitutions, through
evaluation/simulate.py, and kept on disk under a caller's prefix.

    synth_reads(n, paired, seed, prefix) -> n reads, or n (mate 1, mate 2)
                                            pairs

The files are simulated only where missing: written under a temporary
prefix and renamed, the one the check reads last, so a killed run leaves
no short file behind. A file with fewer records than asked raises
SystemExit.
"""

from __future__ import annotations

import math
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "synth")
READ_LEN = 150
ERROR_RATE = 0.002


def n_genomes(fasta: str) -> int:
    with open(fasta) as f:
        return sum(line.startswith(">") for line in f)


def synth_reads(n: int, paired: bool, seed: int, prefix: str) -> list:
    """n reads (or pairs) of the synth genomes, simulated into prefix's
    files where they are missing."""
    from ..io.fastx import read_batch
    from .simulate import SimConfig, simulate
    suffixes = ("_2.fq", ".truth", "_1.fq") if paired else (".truth", ".fq")
    if not os.path.exists(prefix + suffixes[-1]):
        fasta = os.path.join(FIXDIR, "db.fa")
        # simulate gives each genome round(n / genomes) records: ask for
        # enough to keep n
        g = n_genomes(fasta)
        tmp = f"{prefix}.{os.getpid()}.tmp"
        simulate(fasta, os.path.join(FIXDIR, "conv.dmp"), tmp,
                 SimConfig(num_fragments=g * math.ceil(n / g),
                           read_length=READ_LEN, error_rate=ERROR_RATE,
                           seed=seed, paired=paired))
        for s in suffixes:
            os.replace(tmp + s, prefix + s)
    if paired:
        recs = list(zip(read_batch([prefix + "_1.fq"]),
                        read_batch([prefix + "_2.fq"])))[:n]
    else:
        recs = read_batch([prefix + ".fq"])[:n]
    if len(recs) < n:
        # a truncated file must fail loudly, not hang a caller's tiling
        raise SystemExit(
            f"{prefix + suffixes[-1]} has {len(recs)} "
            f"{'pairs' if paired else 'reads'}, expected {n}; delete it "
            f"and rerun")
    return recs
