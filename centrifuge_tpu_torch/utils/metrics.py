"""Interval performance metrics: the reference's --met surface.

The reference emits a TSV of counters every N seconds
(PerfMetrics::reportInterval, centrifuge.cpp:1807-2186), with
--met-file/--met-stderr/--met N and per-read records (--met-read,
centrifuge.cpp:2742-2748). This module reproduces that surface exactly:

* the header line carries the full 134 bowtie2-heritage column names
  (centrifuge.cpp:1818-1967), ending in a trailing tab, exactly as the
  reference prints it;
* each value row carries the 30 values the reference actually emits --
  columns 11-28, 35-120 and the per-family DP counters are `#if 0`'d or
  never incremented in centrifuge (centrifuge.cpp:2043-2096), so the
  emitted row is NARROWER than the header. That misalignment is a
  reference quirk; we replicate the row shape rather than "fix" it;
* periodic rows are INCREMENTAL (since the previous row,
  centrifuge.cpp:2483 total=false), the final row is the job TOTAL
  (centrifuge.cpp:2817 total=true), per-read rows are that read's own
  counters prefixed with "Name\t" (centrifuge.cpp:2742-2748).

Counter mapping (documented in PARITY.md; ours come from batched device
work rather than per-thread structs):

| Reference column | Source here |
|---|---|
| Read/Base | reads/bases entering the outer loop |
| SameRead/SameReadBase | reads whose sequence equals the previous
|   read's (the reference counts its skip-rerun optimization hits) |
| UnfilteredRead/Base | reads (bases) surviving the N/len/qc filters |
| Paired/Unpaired | read units dispatched as pairs / singles |
| AlConUni | pairs with >=1 reported assignment (aln_sink.h:1726) |
| ResBWOp | LF steps taken by the SA-resolve walk (native host walker
|   counts exactly; device-walk steps are not counted -> 0 there) |
| ResBWBranch | 0 (our per-row walk never splits ranges) |
| ResResolve/ResReport | SA rows resolved / served to the classifier |
| MemPeak | host peak RSS, MB |
| EbwtMemPeak | device index arrays, MB |
| GlobalGenomeCoords | SA elements handed to resolution
|   (classifier.h:595 adds bot-top per resolved hit) |
| everything else | 0 (structurally absent: no seed cache, no DP/SW) |
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, TextIO

REF_COLUMNS = [
    "Time", "Read", "Base", "SameRead", "SameReadBase",
    "UnfilteredRead", "UnfilteredBase",
    "Paired", "Unpaired", "AlConUni", "AlConRep", "AlConFail", "AlDis",
    "AlConFailUni", "AlConFailRep", "AlConFailFail", "AlConRepUni",
    "AlConRepRep", "AlConRepFail", "AlUnpUni", "AlUnpRep", "AlUnpFail",
    "SeedSearch", "IntraSCacheHit", "InterSCacheHit", "OutOfMemory",
    "AlBWOp", "AlBWBranch", "ResBWOp", "ResBWBranch", "ResResolve",
    "ResReport", "RedundantSHit",
    "BestMinEdit0", "BestMinEdit1", "BestMinEdit2",
    "ExactAttempts", "ExactSucc", "ExactRanges", "ExactRows", "ExactOOMs",
    "1mmAttempts", "1mmSucc", "1mmRanges", "1mmRows", "1mmOOMs",
    "UngappedSucc", "UngappedFail", "UngappedNoDec",
    "DPExLt10Gaps", "DPExLt5Gaps", "DPExLt3Gaps",
    "DPMateLt10Gaps", "DPMateLt5Gaps", "DPMateLt3Gaps",
] + [
    f"DP16Ex{s}" for s in
    ("Dps", "DpSat", "DpFail", "DpSucc", "Col", "Cell", "Inner", "Fixup",
     "GathSol", "Bt", "BtFail", "BtSucc", "BtCell", "CoreRej", "NRej")
] + [
    f"DP8Ex{s}" for s in
    ("Dps", "DpSat", "DpFail", "DpSucc", "Col", "Cell", "Inner", "Fixup",
     "GathSol", "Bt", "BtFail", "BtSucc", "BtCell", "CoreRej", "NRej")
] + [
    f"DP16Mate{s}" for s in
    ("Dps", "DpSat", "DpFail", "DpSucc", "Col", "Cell", "Inner", "Fixup",
     "GathSol", "Bt", "BtFail", "BtSucc", "BtCell", "CoreRej", "NRej")
] + [
    f"DP8Mate{s}" for s in
    ("Dps", "DpSat", "DpFail", "DpSucc", "Col", "Cell", "Inner", "Fixup",
     "GathSol", "Bt", "BtFail", "BtSucc", "BtCell", "CoreRej", "NRej")
] + [
    "DPBtFiltStart", "DPBtFiltScore", "DpBtFiltDom",
    "MemPeak", "UncatMemPeak", "EbwtMemPeak", "CacheMemPeak",
    "ResolveMemPeak", "AlignMemPeak", "DPMemPeak", "MiscMemPeak",
    "DebugMemPeak",
    "LocalSearch", "AnchorSearch", "LocalIndexSearch", "LocalExtSearch",
    "LocalSearchRecur", "GlobalGenomeCoords", "LocalGenomeCoords",
]


@dataclass
class PerfMetrics:
    # outer loop (OuterLoopMetrics)
    reads: int = 0
    bases: int = 0
    srreads: int = 0         # same-as-previous reads
    srbases: int = 0
    ureads: int = 0          # unfiltered reads
    ubases: int = 0
    filtered: int = 0
    # reporting (ReportingMetrics)
    paired: int = 0          # read units dispatched as pairs
    unpaired: int = 0
    pairs_classified: int = 0    # nconcord_uni (aln_sink.h:1726)
    # resolve walk (WalkMetrics)
    wl_bwops: int = 0        # LF steps in the SA-resolve walk
    wl_resolves: int = 0     # rows resolved
    wl_reports: int = 0      # rows served to the classifier
    resolve_rows: int = 0    # SA elements handed to resolution
    resolve_miss_rows: int = 0
    # native/internal counters (not part of the --met surface; kept for
    # bench/prof observability through engine.stats)
    batches: int = 0
    lanes: int = 0
    device_dispatches: int = 0
    ext_searches: int = 0
    ext_lanes: int = 0
    upload_bytes: int = 0
    staged_upload_bytes: int = 0   # of upload_bytes, from page-locked memory
    download_bytes: int = 0
    pooled_download_bytes: int = 0  # of download_bytes, K1's hit pool
    pool_spills: int = 0     # pool copies that needed a second copy
    collect_wait_secs: float = 0.0
    tail_wait_secs: float = 0.0    # main thread blocked on worker tails
    tail_run_secs: float = 0.0     # worker-thread tail occupancy
    pair_prep_secs: float = 0.0    # main thread in the paired prep
    pair_seed_secs: float = 0.0    # main thread in the paired seeds
    reads_classified: int = 0
    reads_unclassified: int = 0
    assignments: int = 0
    ebwt_bytes: int = 0      # device index arrays (EbwtMemPeak); not
                             # additive -- carried, not merged

    def merge(self, other: "PerfMetrics") -> None:
        eb = max(self.ebwt_bytes, other.ebwt_bytes)
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.ebwt_bytes = eb

    def minus(self, other: "PerfMetrics") -> "PerfMetrics":
        d = PerfMetrics()
        for f in self.__dataclass_fields__:
            setattr(d, f, getattr(self, f) - getattr(other, f))
        d.ebwt_bytes = self.ebwt_bytes
        return d

    def snapshot(self) -> "PerfMetrics":
        d = PerfMetrics()
        for f in self.__dataclass_fields__:
            setattr(d, f, getattr(self, f))
        return d


def _peak_rss_mb() -> int:
    """Host peak RSS in MB (the reference's MemPeak column,
    centrifuge.cpp:2113-2115 via gMemTally.peak())."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10
    except Exception:
        return 0


def _row_values(m: PerfMetrics) -> list:
    """The 30 values the reference emits, in its order
    (centrifuge.cpp:1995-2186)."""
    return [
        int(time.time()),
        m.reads, m.bases, m.srreads, m.srbases, m.ureads, m.ubases,
        m.paired, m.unpaired, m.pairs_classified,
        m.wl_bwops, 0, m.wl_resolves, m.wl_reports,
        _peak_rss_mb(), 0, m.ebwt_bytes >> 20, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, m.resolve_rows, 0,
    ]


class MetricsEmitter:
    """Writes the reference-format interval TSV to a file and/or stderr.

    Periodic rows are incremental (since the previous row); close()
    emits the job-total row, mirroring reportInterval's total flag
    usage (centrifuge.cpp:2483, 2817)."""

    def __init__(self, met_file: Optional[str], met_stderr: bool,
                 interval_secs: int = 1, per_read: bool = False):
        self.fh: Optional[TextIO] = open(met_file, "w") if met_file else None
        self.met_stderr = met_stderr
        self.interval = interval_secs
        self.per_read = per_read
        self.t0 = time.time()
        self.last_emit = self.t0
        self.header_written = False
        self._last = PerfMetrics()

    @property
    def active(self) -> bool:
        return self.fh is not None or self.met_stderr

    def _write(self, line: str) -> None:
        if self.fh is not None:
            self.fh.write(line + "\n")
            self.fh.flush()
        if self.met_stderr:
            import sys
            print(line, file=sys.stderr)

    def _header(self) -> None:
        if self.header_written:
            return
        pre = "Name\t" if self.per_read else ""
        # the reference header line ends with a trailing tab
        self._write(pre + "\t".join(REF_COLUMNS) + "\t")
        self.header_written = True

    def _emit_row(self, m: PerfMetrics, name: Optional[str]) -> None:
        self._header()
        vals = "\t".join(str(v) for v in _row_values(m))
        self._write((name + "\t" + vals) if name is not None else vals)

    def maybe_emit(self, m: PerfMetrics, force: bool = False) -> None:
        if not self.active:
            return
        now = time.time()
        if not force and now - self.last_emit < self.interval:
            return
        self.last_emit = now
        self._emit_row(m.minus(self._last), None)
        self._last = m.snapshot()

    def close(self, m: PerfMetrics) -> None:
        if self.active:
            # final row: job totals (reportInterval(..., total=true))
            self._emit_row(m, None)
        if self.fh is not None:
            self.fh.close()
            self.fh = None


class PerReadMetricsWriter:
    """--met-read: one reference-format row per read, prefixed with the
    read name (centrifuge.cpp:2742-2748 passes the name and resets the
    per-read struct, so values are that read's own counters)."""

    def __init__(self, path: str = "", stream: Optional[TextIO] = None):
        # bare --met-read (reference arity, centrifuge.cpp:546-547)
        # borrows the --met-file/stderr sink; a path owns its own file
        self._owns = stream is None
        self.fh = open(path, "w") if stream is None else stream
        self.em = MetricsEmitter(None, False, per_read=True)
        self.em.fh = self.fh
        self.t0 = time.time()

    def emit_row(self, name: str, m: PerfMetrics) -> None:
        self.em._emit_row(m, name)

    def emit(self, read_id: str, length: int, filtered: bool,
             n_assignments: int) -> None:
        """Per-read record from the read's own counters."""
        m = PerfMetrics()
        m.reads = 1
        m.bases = length
        if not filtered:
            m.ureads, m.ubases = 1, length
        m.filtered = 1 if filtered else 0
        m.unpaired = 1
        m.assignments = n_assignments
        m.reads_classified = 1 if n_assignments > 0 else 0
        self.emit_row(read_id, m)

    def close(self) -> None:
        if self._owns:
            self.fh.close()
