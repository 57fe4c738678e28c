"""Accuracy scoring against simulated ground truth.

Mirrors evaluation/centrifuge_evaluate.py's compare_scm (lines 26-115):
per-read classification is scored at strain/species/genus level -- a read
is correct at a level if any of its reported taxIDs maps (walking up the
taxonomy) to the same taxon as the truth taxID at that level; and
compare_abundance (lines 117-163): sum of squared residuals between
estimated and true abundance.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..index.taxonomy import (RANK_CLASS, RANK_FAMILY, RANK_GENUS,
                              RANK_ORDER, RANK_PHYLUM, RANK_SPECIES,
                              Taxonomy)


def taxid_at_rank(tax: Taxonomy, tid: int, rank: int) -> int:
    """Walk up from tid to the ancestor at `rank` (0 if none);
    taxonomy.h:307-324 semantics."""
    seen = set()
    while tid not in seen:
        seen.add(tid)
        node = tax.tree.get(tid)
        if node is None:
            return 0
        if node.rank == rank:
            return tid
        if node.rank != 0 and node.rank > rank:
            return 0
        if node.parent == tid:
            return 0
        tid = node.parent
    return 0


@dataclass
class LevelScore:
    correct: int = 0
    total: int = 0

    @property
    def accuracy(self) -> float:
        return self.correct / self.total if self.total else 0.0


@dataclass
class EvalResult:
    strain: LevelScore = field(default_factory=LevelScore)
    species: LevelScore = field(default_factory=LevelScore)
    genus: LevelScore = field(default_factory=LevelScore)
    family: LevelScore = field(default_factory=LevelScore)
    order: LevelScore = field(default_factory=LevelScore)
    clazz: LevelScore = field(default_factory=LevelScore)
    phylum: LevelScore = field(default_factory=LevelScore)
    unclassified: int = 0
    reads: int = 0

    def levels(self):
        return [("strain", self.strain), ("species", self.species),
                ("genus", self.genus), ("family", self.family),
                ("order", self.order), ("class", self.clazz),
                ("phylum", self.phylum)]


def parse_truth(path: str) -> Dict[str, int]:
    truth: Dict[str, int] = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                truth[parts[0]] = int(parts[2].split(".")[0])
    return truth


def evaluate_classification(tax: Taxonomy, classification_rows: List[str],
                            truth_by_read: Dict[str, int]) -> EvalResult:
    """Score a classification TSV against read-name-encoded truth.

    Reads are named '<uid>|<tid>|<pos>_<n>'; the readID column therefore
    carries its own truth (like the reference's simulated sets).
    """
    res = EvalResult()
    per_read: Dict[str, List[int]] = {}
    header = None
    col = {}
    for line in classification_rows:
        line = line.rstrip("\n")
        if header is None:
            header = line.split("\t")
            col = {c: i for i, c in enumerate(header)}
            continue
        parts = line.split("\t")
        rid = parts[col["readID"]]
        tid_s = parts[col["taxID"]]
        tid = int(tid_s.split(".")[0])
        per_read.setdefault(rid, []).append(tid)

    for rid, tids in per_read.items():
        # recover truth from the read name ('uid|tid|pos_n')
        true_tid = None
        if rid in truth_by_read:
            true_tid = truth_by_read[rid]
        else:
            fields = rid.split("|")
            if len(fields) >= 2:
                try:
                    true_tid = int(fields[1])
                except ValueError:
                    pass
        if true_tid is None:
            continue
        res.reads += 1
        if tids == [0]:
            res.unclassified += 1
        # strain level: exact taxID match
        res.strain.total += 1
        if true_tid in tids:
            res.strain.correct += 1
        for rank, score in ((RANK_SPECIES, res.species),
                            (RANK_GENUS, res.genus),
                            (RANK_FAMILY, res.family),
                            (RANK_ORDER, res.order),
                            (RANK_CLASS, res.clazz),
                            (RANK_PHYLUM, res.phylum)):
            want = taxid_at_rank(tax, true_tid, rank)
            if want == 0:
                continue
            score.total += 1
            if any(taxid_at_rank(tax, t, rank) == want for t in tids if t):
                score.correct += 1
    return res


def compare_abundance(estimated: Dict[int, float],
                      true_fracs: Dict[int, float]) -> float:
    """Sum of squared residuals over the union of taxa
    (centrifuge_evaluate.py:117-163)."""
    ssr = 0.0
    for tid in set(estimated) | set(true_fracs):
        ssr += (estimated.get(tid, 0.0) - true_fracs.get(tid, 0.0)) ** 2
    return ssr


# ---------------------------------------------------------------------------
# sqlite result logging (the reference's create_sql_db / sql insert,
# evaluation/centrifuge_evaluate.py:180-260): same Classification table
# schema so existing analysis queries keep working.
# ---------------------------------------------------------------------------

_SQL_COLUMNS = (
    "centrifutgeIndex", "readBase", "readType", "program", "version",
    "numFragments",
    "strain_classified", "strain_uniqueclassified", "strain_unclassified",
    "species_classified", "species_uniqueclassified", "species_unclassified",
    "genus_classified", "genus_uniqueclassified", "genus_unclassified",
    "family_classified", "family_uniqueclassified", "family_unclassified",
    "order_classified", "order_uniqueclassified", "order_unclassified",
    "class_classified", "class_uniqueclassified", "class_unclassified",
    "phylum_classified", "phylum_uniqueclassified", "phylum_unclassified",
    "time", "host", "created", "cmd",
)


def create_sql_db(path: str) -> None:
    """CREATE TABLE Classification with the reference's exact columns
    (including its 'centrifutgeIndex' typo, kept for query compat)."""
    import sqlite3
    con = sqlite3.connect(path)
    cols = ["id integer primary key autoincrement"]
    for c in _SQL_COLUMNS:
        if c == "numFragments" or c.endswith("classified"):
            cols.append(f'"{c}" integer')
        elif c == "time":
            cols.append(f'"{c}" real')
        else:
            cols.append(f'"{c}" text')
    con.execute("CREATE TABLE IF NOT EXISTS Classification (%s);"
                % ", ".join(cols))
    con.commit()
    con.close()


def log_result_sql(path: str, index_name: str, read_base: str,
                   read_type: str, res: "EvalResult", elapsed: float,
                   cmd: str, n_unique: Optional[Dict[str, int]] = None,
                   program: str = "centrifuge-tpu",
                   version: str = "") -> None:
    """Insert one evaluation row (reference's sql_insert usage)."""
    import socket
    import sqlite3
    import time as _time
    create_sql_db(path)
    vals: Dict[str, object] = {
        "centrifutgeIndex": index_name,
        "readBase": read_base,
        "readType": read_type,
        "program": program,
        "version": version,
        "numFragments": res.reads,
        "time": elapsed,
        "host": socket.gethostname(),
        "created": _time.strftime("%F %T"),
        "cmd": cmd,
    }
    for name, score in res.levels():
        uniq = (n_unique or {}).get(name, score.correct)
        vals[f"{name}_classified"] = score.correct
        vals[f"{name}_uniqueclassified"] = uniq
        vals[f"{name}_unclassified"] = res.reads - score.correct
    con = sqlite3.connect(path)
    names = ", ".join(f'"{c}"' for c in _SQL_COLUMNS)
    q = ", ".join("?" for _ in _SQL_COLUMNS)
    con.execute(f"INSERT INTO Classification ({names}) VALUES ({q});",
                [vals[c] for c in _SQL_COLUMNS])
    con.commit()
    con.close()


def simulate_reads_mason(fasta: str, out_prefix: str, num: int,
                         read_length: int, seed: int = 0) -> Optional[str]:
    """Mason-based read simulation when the mason binary is available
    (evaluation/test/centrifuge_evaluate_mason.py uses mason; this
    sandbox has no mason, so callers fall back to our simulator)."""
    import shutil
    import subprocess
    mason = shutil.which("mason") or shutil.which("mason_simulator")
    if mason is None:
        return None
    out = out_prefix + ".fq"
    if os.path.basename(mason) == "mason":
        cmd = [mason, "illumina", "-N", str(num), "-n", str(read_length),
               "-s", str(seed), "-o", out, fasta]
    else:
        cmd = [mason, "-ir", fasta, "-n", str(num),
               "--illumina-read-length", str(read_length),
               "--seed", str(seed), "-o", out]
    subprocess.run(cmd, check=True, capture_output=True)
    return out

