"""Batched classification pipeline on one GPU.

Device side: the FM search kernel over all (read, strand) lanes of a
batch (classify/engine.py, csrc/search.cu) over the index built at load
(ops/fm_torch.py, with the depth-12 ftab kernels on large indexes). Host
side: the native assignment engine (native/engine.py), then row
formatting and species metrics. Per batch:

  1. one batched full-scan search over all (read, strand) lanes
  2. the cross-strand extension fixpoint
  3. one batched SA resolution for all candidate ranges
  4. host assignment + row formatting (byte parity with the oracle)

Two ways to resolve, with the same rows out. host_resolve=True (the
default): the native host walk (native/fmwalk.py) resolves SA rows and
searches extension misses. host_resolve=False, or when the host walk
cannot be built: the search dispatch also presolves the predicted rows
on the card (K5 + K3), the tail serves rows from that prefetch, resolves
the rest with the device resolver (K3) and searches extension misses
with the engine's first-hit search (K1).

With a mesh (parallel/sharded.py), the search runs data-parallel over
the mesh's dp rows and BWT-range-sharded over its fm axis (K6), and the
device resolver is K6's sharded walk; the host tail is the same, so the
rows are too. parallel/multihost.py wires the same engine into a
pipeline per process, with a cross-process max (`sync`) that fixes the
padded shapes and the number of extension rounds.

The JAX package's counterpart is classify/tpu_pipeline.py.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from torch.profiler import record_function

from ..index.cf_io import CFIndex
from ..io.fastx import ReadRec
from ..ops.fm_torch import DeviceFMIndex, make_resolver
from ..utils.rng import LCG, gen_read_seed, gen_read_seeds_batch
from .algo import (OFF_MASK, Classifier, PartialHit, StrandState,
                   extend_and_filter, select_results)
from .engine import BatchSearchEngine
from .pipeline import (DEFAULT_COLUMNS, PipelineConfig, ResultFormatter,
                       SpeciesMetrics, batch_flat_seqs, batch_read_passes,
                       batch_revcomp, format_read_id)


def _states_from_arrays(h_top, h_bot, h_off, h_len, nhits, sums, lane,
                        length) -> Tuple[StrandState, int]:
    st = StrandState(length)
    st.cur = length
    st.done = True
    k = int(nhits[lane])
    for j in range(k):
        t = int(h_top[lane, j])
        b = int(h_bot[lane, j])
        st.hits.append(PartialHit(
            OFF_MASK if t < 0 else t, OFF_MASK if b < 0 else b,
            int(h_off[lane, j]), int(h_len[lane, j])))
    return st, int(sums[lane])


class GPUClassificationPipeline:
    """Classify batches of reads with the GPU search and the native host
    tail; SA rows resolve on the host or on the card
    (PipelineConfig.host_resolve)."""

    def __init__(self, idx: CFIndex, cfg: Optional[PipelineConfig] = None,
                 device="cuda", wide=None,
                 dfm: Optional[DeviceFMIndex] = None, mesh=None,
                 n_fm: int = None, sharded=None):
        """device: where the index and the search run ("cuda" by default;
        "cpu" runs the plain PyTorch versions). A prebuilt `dfm` skips the
        packing and upload, so several pipelines can share one index.

        mesh: a parallel.sharded.Mesh (make_mesh) of devices of the type of
        `device`: the search and the device resolve run over it, the index
        split n_fm ways (default: the mesh's fm axis). With host_resolve
        the host walk reads the sharded arrays' blocks. A prebuilt
        `sharded` (ShardedFMArrays of idx, split as the mesh's fm axis)
        skips the split (n_fm and wide are its own), so several mesh
        pipelines can share one, as they share a dfm."""
        cfg = cfg or PipelineConfig()
        if mesh is not None:
            self._init_mesh(idx, cfg, device, mesh, n_fm, wide, sharded)
            return
        if dfm is None:
            dfm = DeviceFMIndex.build(idx, device=device, wide=wide,
                                      keep_host_blocks=cfg.host_resolve)
        engine = BatchSearchEngine(dfm, cfg.classifier.min_hitlen)
        self._init_with_engine(idx, cfg, engine, make_resolver(dfm),
                               dfm=dfm)
        if cfg.host_resolve and dfm.host_blocks is not None:
            try:
                from ..native.fmwalk import HostResolver
                # pipelines sharing a prebuilt dfm share one resolver
                hr = getattr(dfm, "_host_resolver", None)
                if hr is None:
                    hr = HostResolver(dfm.host_blocks, idx, dfm.wide)
                    dfm._host_resolver = hr
                self.resolver = hr
                # rows resolve on the host: no presolve in the dispatch
                self.presolve = False
            except (ImportError, OSError, RuntimeError) as e:
                # the native walk cannot load: keep the device resolver
                from ..utils.fallback import warn_fallback
                warn_fallback("fmwalk.cpp (HostResolver)", e)

    def _init_mesh(self, idx, cfg, device, mesh, n_fm, wide,
                   sharr=None) -> None:
        """The mesh branch of tpu_pipeline.py:54-88."""
        import torch
        from ..parallel.sharded import (MeshIndex, ShardedFMArrays,
                                        ShardedSearchEngine,
                                        make_sharded_resolver)
        kind = torch.device(device).type
        if any(d.type != kind for row in mesh.devices for d in row):
            raise ValueError(f"the mesh's devices are not {kind} devices")
        if sharr is None:
            sharr = ShardedFMArrays.build(idx, n_fm or mesh.n_fm, wide=wide)
        index = MeshIndex(sharr, mesh)
        engine = ShardedSearchEngine(index, cfg.classifier.min_hitlen)
        self._init_with_engine(idx, cfg, engine, make_sharded_resolver(index))
        self.metrics.ebwt_bytes = int(index.nbytes)
        self.mesh_index = index
        # the sharded engine does not presolve
        self.presolve = False
        if cfg.host_resolve:
            try:
                from ..native.fmwalk import HostResolver
                # the fm-padded blocks: HostResolver counts the real ones;
                # pipelines sharing the arrays share one resolver
                hr = getattr(sharr, "_host_resolver", None)
                if hr is None:
                    hr = HostResolver(sharr.blocks, idx, sharr.wide)
                    sharr._host_resolver = hr
                self.resolver = hr
            except (ImportError, OSError, RuntimeError) as e:
                from ..utils.fallback import warn_fallback
                warn_fallback("fmwalk.cpp (sharded HostResolver)", e)

    def _init_with_engine(self, idx, cfg, engine, resolver, dfm=None,
                          sync=None):
        """Wire the (engine, resolver) pair into the shared host pipeline.
        `sync` is the cross-process max of a host scalar (multihost.py):
        with it, every process runs the same number of extension rounds
        and resolve calls, and batches run without the tail thread."""
        self.idx = idx
        self.cfg = cfg
        self.dfm = dfm
        self.engine = engine
        self.resolver = resolver
        self.sync = sync
        # the in-dispatch presolve (K5 + K3); off once a host resolver
        # takes over (__init__)
        self.presolve = True
        # host-side classifier: algorithm only, no FM oracle needed
        self.classifier = Classifier(idx, None, self.cfg.classifier)
        self.formatter = ResultFormatter(idx, self.cfg)
        self.spm = SpeciesMetrics()
        from ..utils.metrics import PerfMetrics
        self.metrics = PerfMetrics()
        self._last_seq = None   # same-read (srreads) comparison carry
        if dfm is not None:
            self.metrics.ebwt_bytes = int(dfm.nbytes)
        self.met_read = None
        if self.cfg.met_read:
            from ..utils.metrics import PerReadMetricsWriter
            self.met_read = PerReadMetricsWriter(self.cfg.met_read)
        self.native = None
        # the native engine caps stored read positions (kmer counting
        # needs them all), so kmer mode uses the Python path
        if self.cfg.use_native and not self.cfg.count_kmers:
            from ..native.engine import NativeAssigner
            self.native = NativeAssigner(idx, self.cfg.classifier,
                                         self.classifier)

    # ---- species metrics (native flat path keeps them in C++) ----

    @property
    def spm(self) -> SpeciesMetrics:
        """The species-metrics accumulator. The native flat row path
        accumulates in C++ (ctx spm state); reading the property drains
        that state into the Python object first, so Python-path emits and
        report writers always see the merged, up-to-date metrics."""
        if getattr(self, "_spm_dirty", False):
            self.native.spm_drain(self._spm)
            self._spm_dirty = False
        return self._spm

    @spm.setter
    def spm(self, value: SpeciesMetrics) -> None:
        if getattr(self, "native", None) is not None:
            self.native.spm_reset()
        self._spm_dirty = False
        self._spm = value

    def _flat_eligible(self) -> bool:
        """The all-native row path covers exactly the default-column
        output with no per-read extras (kmer sketches, --met-read)."""
        return (self.native is not None
                and self.cfg.columns == DEFAULT_COLUMNS
                and not self.cfg.count_kmers
                and self.met_read is None)

    def _tally_flat(self, passes, qlens, unit_nres,
                    paired_flags=None) -> None:
        m = self.metrics
        n = len(qlens)
        m.reads += n
        m.bases += int(sum(qlens))
        nclass = int(np.count_nonzero(unit_nres))
        m.reads_classified += nclass
        m.reads_unclassified += n - nclass
        m.assignments += int(unit_nres.sum())
        m.filtered += sum(1 for ok in passes if not ok)
        if paired_flags is not None:
            # AlConUni: pairs with a reported assignment (aln_sink.h:1726)
            m.pairs_classified += sum(
                1 for pf, nr in zip(paired_flags, unit_nres)
                if pf and nr > 0)
        m.batches += 1

    def _tally_outer(self, recs, passes, flat3=None) -> None:
        """OuterLoopMetrics counters: SameRead(Base) counts reads whose
        sequence equals the previous read's (the reference's skip-rerun
        optimization hits, centrifuge.cpp srreads), Unfiltered counts
        filter survivors. reads/bases totals are tallied per path.

        With flat3 and a uniform read length (the overwhelmingly common
        batch shape) this is one vectorized row-compare; the per-read
        np.array_equal loop cost ~8 us/read = ~130 ms per 16k-read batch
        ON THE MAIN THREAD of the overlap pipeline."""
        m = self.metrics
        n = len(recs)
        if n == 0:
            return
        if flat3 is not None:
            flat, lens, _off = flat3
            L = int(lens[0])
            if np.all(lens == L) and flat.shape[0] == n * L:
                ok = np.asarray(passes, bool)
                m.ureads += int(ok.sum())
                m.ubases += int(lens[ok].sum())
                mat = flat.reshape(n, L)
                eq = np.zeros(n, bool)
                if n > 1:
                    eq[1:] = (mat[1:] == mat[:-1]).all(axis=1)
                prev = self._last_seq
                if prev is not None and prev.shape[0] == L:
                    eq[0] = bool(np.array_equal(mat[0], prev))
                ns = int(eq.sum())
                m.srreads += ns
                m.srbases += ns * L
                self._last_seq = recs[-1].seq
                return
        prev = self._last_seq
        for rec, ok in zip(recs, passes):
            sq = rec.seq
            if prev is not None and sq.shape == prev.shape \
                    and np.array_equal(sq, prev):
                m.srreads += 1
                m.srbases += len(sq)
            prev = sq
            if ok:
                m.ureads += 1
                m.ubases += len(sq)
        self._last_seq = prev

    def _flat_seed_spm(self) -> None:
        # move pending Python-side state (cur_ids carry-over + per-taxon
        # float partials) into the native accumulator so a path switch
        # keeps both the aln_sink carry-over quirk and the float
        # accumulation order bit-exact
        if self._spm.cur_ids or self._spm.species_counts:
            self.native.spm_seed(self._spm)
        self._spm_dirty = True

    # ---- batched units ----

    def _collect(self, handle, n_lanes):
        """search_collect with the blocked-on-device time + engine
        transfer counters folded into PerfMetrics. A handle already
        fetched by the overlap's main thread (search_fetch) holds numpy
        arrays and touches no device here, so only unfetched handles add
        to collect_wait -- also avoiding a two-thread += race on the same
        field."""
        import time as _t
        fetched = handle.fetched
        t0 = _t.perf_counter()
        out = self.engine.search_collect(handle, n_lanes)
        if not fetched:
            self.metrics.collect_wait_secs += _t.perf_counter() - t0
        st = getattr(self.engine, "stats", None)
        if st is not None:
            self.metrics.upload_bytes = st["upload_bytes"]
            self.metrics.staged_upload_bytes = st["staged_upload_bytes"]
            self.metrics.download_bytes = st["download_bytes"]
            self.metrics.ext_searches = st["ext_searches"]
            self.metrics.ext_lanes = st["ext_lanes"]
        bw = getattr(self.resolver, "bwops", None)
        if bw is not None:
            self.metrics.wl_bwops = bw
        return out

    def _prep_unpaired(self, recs, flat3=None):
        """[[(seq, revcomp)]] per read with ONE batched complement."""
        rcs = batch_revcomp(recs, flat3=flat3)
        return [[(r.seq, rc)] for r, rc in zip(recs, rcs)]

    def _emit_rows(self, recs, passes, results) -> List[str]:
        rows: List[str] = []
        m = self.metrics
        for rec, ok, res in zip(recs, passes, results):
            rnd = LCG(gen_read_seed(rec.seq, rec.qual, rec.name,
                                    self.cfg.seed))
            chosen, secbest = select_results(
                res, self.cfg.classifier.khits, rnd) if ok else ([], 0)
            m.reads += 1
            m.bases += len(rec.seq)
            if not ok:
                m.filtered += 1
            if chosen:
                m.reads_classified += 1
                m.assignments += len(chosen)
            else:
                m.reads_unclassified += 1
            rows.extend(self.formatter.rows_for_read(
                rec.name, len(rec.seq), chosen, secbest, self.spm,
                unclassified=not chosen, reads=(rec,)))
            if self.met_read is not None:
                self.met_read.emit(format_read_id(rec.name), len(rec.seq),
                                   not ok, len(chosen))
        m.batches += 1
        return rows

    def classify_batch_unpaired(self, recs: Sequence[ReadRec]) -> List[str]:
        flat3 = batch_flat_seqs(recs)
        units = self._prep_unpaired(recs, flat3=flat3)
        passes = batch_read_passes(recs, self.cfg, flat3=flat3)
        self._tally_outer(recs, passes, flat3=flat3)
        if self.native is not None:
            fut = self._dispatch_units(units, passes)
            return self._finish_batch(recs, passes, units, fut)
        results = self._classify_units(units, passes, paired=False)
        return self._emit_rows(recs, passes, results)

    def classify_stream_unpaired(self, batches) -> "Iterator[List[str]]":
        """Pipelined streaming: the device searches batch N+1 while the
        host finishes batch N (kernel launches are asynchronous; only
        the fetch blocks). With the native engine, batches run through
        the tail-thread overlap instead (_stream_overlap): the main
        thread launches the searches, ONE worker runs the host tail
        FIFO, so output order and the species state remain
        deterministic."""
        if self.native is not None and self.cfg.threaded_stream \
                and self.sync is None:
            yield from self._stream_overlap(batches, paired=False)
            return
        from collections import deque
        pending = deque()  # (recs, passes, units, device_future, seeds)
        for recs in batches:
            flat3 = batch_flat_seqs(recs)
            units = self._prep_unpaired(recs, flat3=flat3)
            passes = batch_read_passes(recs, self.cfg, flat3=flat3)
            self._tally_outer(recs, passes, flat3=flat3)
            fut = self._dispatch_units(units, passes)
            # seeds depend only on inputs: hash them now so the work
            # overlaps the device instead of sitting after the collect
            seeds = gen_read_seeds_batch(recs, self.cfg.seed, flat3=flat3)
            pending.append((recs, passes, units, fut, seeds))
            # keep 3 batches in flight: upload/compute/download of later
            # batches overlap host assignment work on batch N
            if len(pending) > 3:
                yield self._finish_batch(*pending.popleft())
        while pending:
            yield self._finish_batch(*pending.popleft())

    def _stream_overlap(self, batches, paired) -> "Iterator[List[str]]":
        """Tail-thread overlap: the main thread launches every search and
        fetches its outputs (search_fetch waits on the copy's event and
        re-runs overflowing lanes); the one worker thread runs the host
        tail. With the host resolver the tail never touches the device;
        without it the tail launches K3 for the rows the prefetch missed
        and K1 for extension misses, each under engine.dev_lock (K3 on
        the resolver's stream, K1 on the engine's) and synchronised
        before it returns. Steady
        state per batch ~= max(device compute + transfer, host tail)
        instead of their sum. Tails run FIFO on one worker, so the
        native spm accumulation order (byte parity) is unchanged."""
        import time as _t
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = deque()   # dispatched, not yet collected
            tails = deque()     # host-tail futures, FIFO

            def timed_fin(fin, *a):
                t0 = _t.perf_counter()
                out = fin(*a)
                self.metrics.tail_run_secs += _t.perf_counter() - t0
                return out

            def result(f):
                t0 = _t.perf_counter()
                out = f.result()
                self.metrics.tail_wait_secs += _t.perf_counter() - t0
                return out

            def drain_one():
                item = pending.popleft()
                fut = item[-2]
                lane_seqs, lane_map, handle = fut
                if lane_seqs:
                    # block on the device transfer here; the tail worker
                    # then reads the fetched host arrays
                    t0 = _t.perf_counter()
                    handle = self.engine.search_fetch(handle)
                    self.metrics.collect_wait_secs += _t.perf_counter() - t0
                    item = item[:-2] + ((lane_seqs, lane_map, handle),
                                        item[-1])
                fin = self._finish_paired if paired else self._finish_batch
                tails.append(ex.submit(timed_fin, fin, *item, None))

            for b in batches:
                if paired:
                    pending.append(self._paired_main(b))
                else:
                    flat3 = batch_flat_seqs(b)
                    units = self._prep_unpaired(b, flat3=flat3)
                    passes = batch_read_passes(b, self.cfg, flat3=flat3)
                    self._tally_outer(b, passes, flat3=flat3)
                    fut = self._dispatch_units(units, passes)
                    seeds = gen_read_seeds_batch(b, self.cfg.seed,
                                                 flat3=flat3)
                    pending.append((b, passes, units, fut, seeds))
                if len(pending) > 2:
                    drain_one()
                while len(tails) > 1:
                    yield result(tails.popleft())
            while pending:
                drain_one()
            while tails:
                yield result(tails.popleft())

    def _dispatch_units(self, units, active):
        """Launch the device search for a batch; returns an opaque handle.

        lane_map is an (L, 3) int32 ndarray of (unit, mate, strand) per
        lane -- built vectorized (a 32k-lane batch paid ~8 ms in Python
        tuple building + re-parsing); rows still unpack like tuples for
        the Python fallback path."""
        lane_seqs: List[np.ndarray] = []
        for unit, ok in zip(units, active):
            if not ok:
                continue
            for fw, rc in unit:
                lane_seqs.append(fw)
                lane_seqs.append(rc)
        nu = len(units)
        act = np.fromiter((bool(ok) for ok in active), np.bool_, nu) \
            if nu else np.zeros(0, np.bool_)
        nm = np.fromiter((len(u) for u in units), np.int64, nu) \
            if nu else np.zeros(0, np.int64)
        ui_act = np.flatnonzero(act)
        nm_act = nm[ui_act]
        tot_m = int(nm_act.sum())
        lane_unit = np.repeat(ui_act, 2 * nm_act).astype(np.int32)
        # mate index within unit: global mate counter minus the unit's
        # first-mate offset (strand alternates fastest)
        mate_ctr = np.arange(2 * tot_m, dtype=np.int64) // 2
        first = np.repeat(np.cumsum(nm_act) - nm_act, 2 * nm_act)
        lane_mate = (mate_ctr - first).astype(np.int32)
        lane_strand = np.tile(np.array([0, 1], np.int32), tot_m)
        lane_map = np.stack([lane_unit, lane_mate, lane_strand], axis=1) \
            if tot_m else np.zeros((0, 3), np.int32)
        handle = None
        if lane_seqs:
            handle = self.engine.search_async(
                lane_seqs,
                presolve=self.native is not None and self.presolve,
                khits=self.cfg.classifier.khits,
                ihits=self.classifier.ihits)
        self.metrics.lanes += len(lane_seqs)
        self.metrics.device_dispatches += 1
        m = self.metrics
        for unit, ok in zip(units, active):
            if not ok:
                continue
            if len(unit) == 2:
                m.paired += 1
            elif len(unit) == 1:
                m.unpaired += 1
        return lane_seqs, lane_map, handle

    def _finish_batch(self, recs, passes, units, fut,
                      seeds=None, collected=None) -> List[str]:
        lane_seqs, lane_map, handle = fut
        if self.native is not None and lane_seqs:
            arrays, prefetch = collected if collected is not None \
                else self._collect(handle, len(lane_seqs))
            if seeds is None:
                seeds = gen_read_seeds_batch(recs, self.cfg.seed)
            if self._flat_eligible():
                # all-native tail: classification + selection + row
                # formatting + species metrics in C++; no AlnResult
                # objects and no per-read Python emit loop
                self._flat_seed_spm()
                qlens = [len(r.seq) for r in recs]
                # unpaired: mate 0's length IS the query length; passing
                # it skips the native tail's per-unit Python loop
                ml = np.zeros((len(recs), 2), np.int32)
                ml[:, 0] = qlens
                rows, unit_nres, secbest = self.native.process_rows(
                    arrays, lane_map, lane_seqs, units,
                    [False] * len(units), seeds, self.engine,
                    self.resolver, [r.name for r in recs], qlens,
                    self.metrics, prefetch=prefetch, round_sync=self.sync,
                    mate_len=ml)
                self._tally_flat(passes, qlens, unit_nres)
                return rows
            per_unit, secbest = self.native.process(
                arrays, lane_map, lane_seqs, units,
                [False] * len(units), seeds, self.engine, self.resolver,
                self.metrics, prefetch=prefetch, round_sync=self.sync)
            return self._emit_rows_preselected(recs, passes, per_unit,
                                               secbest)
        results = self._classify_units(
            units, passes, paired=False,
            prefetched=(lane_seqs, lane_map, handle))
        return self._emit_rows(recs, passes, results)

    def _emit_rows_preselected(self, recs, passes, per_unit,
                               secbest) -> List[str]:
        """Emit rows when selection already happened (native engine)."""
        rows: List[str] = []
        m = self.metrics
        for ui, (rec, ok) in enumerate(zip(recs, passes)):
            chosen = per_unit[ui] if ok else []
            sb = secbest[ui] if ok else 0
            m.reads += 1
            m.bases += len(rec.seq)
            if not ok:
                m.filtered += 1
            if chosen:
                m.reads_classified += 1
                m.assignments += len(chosen)
            else:
                m.reads_unclassified += 1
            rows.extend(self.formatter.rows_for_read(
                rec.name, len(rec.seq), chosen, sb, self.spm,
                unclassified=not chosen, reads=(rec,)))
            if self.met_read is not None:
                self.met_read.emit(format_read_id(rec.name), len(rec.seq),
                                   not ok, len(chosen))
        m.batches += 1
        return rows

    def classify_stream_paired(self, batches) -> "Iterator[List[str]]":
        """Pipelined streaming for pairs (native engine only; falls back
        to sequential batches otherwise)."""
        if self.native is None:
            for pairs in batches:
                yield self.classify_batch_paired(pairs)
            return
        if self.cfg.threaded_stream and self.sync is None:
            yield from self._stream_overlap(batches, paired=True)
            return
        from collections import deque
        pending = deque()
        for pairs in batches:
            pending.append(self._paired_main(pairs))
            if len(pending) > 3:
                yield self._finish_paired(*pending.popleft())
        while pending:
            yield self._finish_paired(*pending.popleft())

    def _paired_main(self, pairs):
        """The streams' main-thread work on a batch of pairs: the prep,
        the dispatch, then the seeds while the device searches. The two
        host steps add their wall time to `metrics.pair_prep_secs` and
        `pair_seed_secs`, each under a profiler range of its own
        (`pipeline.pair_prep`, `pipeline.pair_seeds`)."""
        m = self.metrics
        t0 = time.perf_counter()
        with record_function("pipeline.pair_prep"):
            prep = self._prep_paired(pairs)
        m.pair_prep_secs += time.perf_counter() - t0
        fut = self._dispatch_units(prep[0], prep[2])
        t0 = time.perf_counter()
        with record_function("pipeline.pair_seeds"):
            seeds = self._paired_seeds(pairs, prep[1])
        m.pair_seed_secs += time.perf_counter() - t0
        return pairs, prep, fut, seeds

    def _prep_paired(self, pairs):
        units = []
        passes = []
        paired_flags = []
        mate_len = np.zeros((len(pairs), 2), np.int32)
        m1 = [r1 for r1, _ in pairs]
        m2 = [r2 for _, r2 in pairs if r2 is not None]
        pass1 = batch_read_passes(m1, self.cfg)
        rc1 = batch_revcomp(m1)
        pass2_it = iter(batch_read_passes(m2, self.cfg))
        rc2_it = iter(batch_revcomp(m2))
        for i, (r1, r2) in enumerate(pairs):
            p1 = pass1[i]
            c1 = rc1[i]
            if r2 is not None:
                p2 = next(pass2_it)
                c2 = next(rc2_it)
            else:
                p2 = False
                c2 = None
            passes.append((p1, p2))
            if p1 and p2:
                units.append([(r1.seq, c1), (r2.seq, c2)])
                paired_flags.append(True)
                mate_len[i, 0] = len(r1.seq)
                mate_len[i, 1] = len(r2.seq)
            elif p1:
                units.append([(r1.seq, c1)])
                paired_flags.append(False)
                mate_len[i, 0] = len(r1.seq)
            elif p2:
                units.append([(r2.seq, c2)])
                paired_flags.append(False)
                mate_len[i, 0] = len(r2.seq)
            else:
                units.append([])
                paired_flags.append(False)
        active = [bool(u) for u in units]
        flat_recs, flat_ok = [], []
        for (r1, r2), (p1, p2) in zip(pairs, passes):
            flat_recs.append(r1)
            flat_ok.append(p1)
            if r2 is not None:
                flat_recs.append(r2)
                flat_ok.append(p2)
        self._tally_outer(flat_recs, flat_ok)
        return units, passes, active, paired_flags, mate_len

    def _paired_seeds(self, pairs, passes) -> np.ndarray:
        """Per-pair tie-break seeds, matching the oracle exactly: mate 1's
        seed is always the base (even when only mate 2 passed the
        filters), xor'd with mate 2's when both pass
        (pipeline.py classify_paired / centrifuge.cpp:2503)."""
        n = len(pairs)
        s1 = gen_read_seeds_batch([r1 for r1, _ in pairs], self.cfg.seed)
        m2 = [r2 for _, r2 in pairs if r2 is not None]
        s2_it = iter(gen_read_seeds_batch(m2, self.cfg.seed))
        seeds = np.zeros(n, dtype=np.uint32)
        for ui, ((r1, r2), (p1, p2)) in enumerate(zip(pairs, passes)):
            s2 = next(s2_it) if r2 is not None else 0
            if not (p1 or p2):
                continue
            s = s1[ui]
            if p1 and p2:
                s = s ^ s2
            seeds[ui] = s
        return seeds

    def _emit_rows_paired(self, pairs, passes, per_unit, secbest) -> List[str]:
        rows: List[str] = []
        m = self.metrics
        for ui, ((r1, r2), (p1, p2)) in enumerate(zip(pairs, passes)):
            qlen = len(r1.seq) + (len(r2.seq) if r2 is not None else 0)
            chosen = per_unit[ui] if (p1 or p2) else []
            sb = secbest[ui] if (p1 or p2) else 0
            m.reads += 1
            m.bases += qlen
            if not (p1 or p2):
                m.filtered += 1
            if chosen:
                m.reads_classified += 1
                m.assignments += len(chosen)
                if p1 and p2:
                    m.pairs_classified += 1
            else:
                m.reads_unclassified += 1
            rows.extend(self.formatter.rows_for_read(
                r1.name, qlen, chosen, sb, self.spm,
                unclassified=not chosen, reads=(r1, r2)))
            if self.met_read is not None:
                self.met_read.emit(format_read_id(r1.name), qlen,
                                   not (p1 or p2), len(chosen))
        m.batches += 1
        return rows

    def _finish_paired(self, pairs, prep, fut, seeds=None,
                       collected=None) -> List[str]:
        units, passes, active, paired_flags, mate_len = prep
        lane_seqs, lane_map, handle = fut
        if not lane_seqs:
            return self._emit_rows_paired(
                pairs, passes, [[] for _ in pairs], [0] * len(pairs))
        arrays, prefetch = collected if collected is not None \
            else self._collect(handle, len(lane_seqs))
        if seeds is None:
            seeds = self._paired_seeds(pairs, passes)
        if self._flat_eligible():
            self._flat_seed_spm()
            qlens = [len(r1.seq) + (len(r2.seq) if r2 is not None else 0)
                     for r1, r2 in pairs]
            rows, unit_nres, secbest = self.native.process_rows(
                arrays, lane_map, lane_seqs, units, paired_flags, seeds,
                self.engine, self.resolver, [r1.name for r1, _ in pairs],
                qlens, self.metrics, prefetch=prefetch, round_sync=self.sync,
                mate_len=mate_len)
            self._tally_flat([p1 or p2 for p1, p2 in passes], qlens,
                             unit_nres, paired_flags=paired_flags)
            return rows
        per_unit, secbest = self.native.process(
            arrays, lane_map, lane_seqs, units, paired_flags, seeds,
            self.engine, self.resolver, self.metrics, prefetch=prefetch,
            round_sync=self.sync, mate_len=mate_len)
        return self._emit_rows_paired(pairs, passes, per_unit, secbest)

    def classify_batch_paired(self, pairs: Sequence[Tuple[ReadRec, ReadRec]]
                              ) -> List[str]:
        prep = self._prep_paired(pairs)
        units, passes, active, paired_flags, _mate_len = prep
        if self.native is not None and any(active):
            fut = self._dispatch_units(units, active)
            return self._finish_paired(pairs, prep, fut)
        results = self._classify_units(units, active,
                                       paired=None, paired_flags=paired_flags)
        rows: List[str] = []
        m = self.metrics
        for (r1, r2), (p1, p2), res in zip(pairs, passes, results):
            qlen = len(r1.seq) + (len(r2.seq) if r2 is not None else 0)
            if p1 or p2:
                seed1 = gen_read_seed(r1.seq, r1.qual, r1.name, self.cfg.seed)
                if p1 and p2:
                    seed2 = gen_read_seed(r2.seq, r2.qual, r2.name, self.cfg.seed)
                    rnd = LCG(seed1 ^ seed2)
                else:
                    rnd = LCG(seed1)
                chosen, secbest = select_results(
                    res, self.cfg.classifier.khits, rnd)
            else:
                chosen, secbest = [], 0
            m.reads += 1
            m.bases += qlen
            if not (p1 or p2):
                m.filtered += 1
            if chosen:
                m.reads_classified += 1
                m.assignments += len(chosen)
                if p1 and p2:
                    m.pairs_classified += 1
            else:
                m.reads_unclassified += 1
            rows.extend(self.formatter.rows_for_read(
                r1.name, qlen, chosen, secbest, self.spm,
                unclassified=not chosen, reads=(r1, r2)))
        return rows

    # ---- core batch machinery ----

    def _classify_units(self, units, active, paired, paired_flags=None,
                        prefetched=None):
        """units: per read/pair a list of (seq_fw, seq_rc) mates."""
        cls = self.classifier
        cfg = self.cfg.classifier
        # 1. batched full search over all lanes
        if prefetched is not None:
            lane_seqs, lane_map, handle = prefetched
            if not lane_seqs:
                return [[] for _ in units]
            arrays, _ = self.engine.search_collect(handle, len(lane_seqs))
        else:
            lane_seqs = []
            lane_map: List[Tuple[int, int, int]] = []  # (unit, mate, strand)
            for ui, (unit, ok) in enumerate(zip(units, active)):
                if not ok:
                    continue
                for mi, (fw, rc) in enumerate(unit):
                    lane_seqs.append(fw)
                    lane_map.append((ui, mi, 0))
                    lane_seqs.append(rc)
                    lane_map.append((ui, mi, 1))
            if not lane_seqs:
                return [[] for _ in units]
            arrays = self.engine.search(lane_seqs)

        pristine: Dict[Tuple[int, int], Tuple[list, list]] = {}
        for li, (ui, mi, si) in enumerate(lane_map):
            st, total = _states_from_arrays(*arrays, li, len(lane_seqs[li]))
            key = (ui, mi)
            if key not in pristine:
                pristine[key] = ([None, None], [0, 0])
            pristine[key][0][si] = st
            pristine[key][1][si] = total

        # 2. extension fixpoint: run extend_and_filter per mate against a
        # cache of single-search results; batch the misses and retry
        cache: Dict[Tuple[int, int, int, int], PartialHit] = {}
        final_states: Dict[Tuple[int, int], List[StrandState]] = {}
        todo = list(pristine.keys())
        for _round in range(64):
            misses: List[Tuple[int, int, int, int]] = []
            still: List[Tuple[int, int]] = []
            for key in todo:
                ui, mi = key
                states = [st.clone() for st in pristine[key][0]]
                sums = pristine[key][1]
                seqs = units[ui][mi]

                local_miss: List[Tuple[int, int, int, int]] = []

                def do_search(si, off, _ui=ui, _mi=mi):
                    # on a miss, record the key and return a harmless
                    # empty hit (never adopted: its length can't match)
                    # so the whole attempt's misses batch in one round
                    k = (_ui, _mi, si, off)
                    hit = cache.get(k)
                    if hit is not None:
                        return hit
                    local_miss.append(k)
                    return PartialHit(OFF_MASK, OFF_MASK, OFF_MASK, 0)

                extend_and_filter(do_search, len(seqs[0]), states, sums,
                                  cfg.min_hitlen, cls.ihits)
                if local_miss:
                    misses.extend(local_miss)
                    still.append(key)
                else:
                    final_states[key] = states
            if not misses:
                break
            mseqs = [units[ui][mi][si] for (ui, mi, si, off) in misses]
            moffs = np.array([off for (_, _, _, off) in misses], dtype=np.int32)
            mh = self.engine.search_first_hits(mseqs, moffs)
            for i, k in enumerate(misses):
                t = int(mh[0][i, 0])
                b = int(mh[1][i, 0])
                cache[k] = PartialHit(
                    OFF_MASK if t < 0 else t, OFF_MASK if b < 0 else b,
                    int(mh[2][i, 0]), int(mh[3][i, 0]))
            todo = still
        else:
            raise RuntimeError("extension fixpoint did not converge")

        # 3. pass A: record resolution requests per unit
        requests: List[Tuple[int, int]] = []  # (top, nelt)

        def make_recorder():
            def rec(top, bot, nelt):
                requests.append((top, nelt))
                return [0] * nelt  # dummy values, never reported
            return rec

        unit_mates = {}
        for ui, (unit, ok) in enumerate(zip(units, active)):
            if not ok:
                continue
            mates = unit
            mstates = [final_states[(ui, mi)] for mi in range(len(unit))]
            unit_mates[ui] = (mates, mstates)
            is_paired = paired if paired is not None else paired_flags[ui]
            cls.classify_with_states(mates, mstates, is_paired, make_recorder())

        # one batched host resolve of all requested SA elements
        values: List[List[int]] = []
        if requests:
            rdt = np.int64 if getattr(self.resolver, "wide", False) \
                else np.int32
            rows = np.concatenate([
                np.arange(top, top + nelt, dtype=np.int64)
                for top, nelt in requests]).astype(rdt)
            nrows = rows.shape[0]
            self.metrics.resolve_rows += nrows
            self.metrics.wl_resolves += nrows
            self.metrics.wl_reports += nrows
            tidx = np.asarray(self.resolver(rows))
            pos = 0
            for top, nelt in requests:
                values.append([int(v) for v in tidx[pos:pos + nelt]])
                pos += nelt

        # 4. pass B: consume values
        out = [[] for _ in units]
        cursor = [0]

        def make_consumer():
            def con(top, bot, nelt):
                v = values[cursor[0]]
                cursor[0] += 1
                return v
            return con

        for ui in sorted(unit_mates.keys()):
            mates, mstates = unit_mates[ui]
            # states were mutated by pass A?  classify_with_states does not
            # mutate StrandStates, so reuse is safe
            is_paired = paired if paired is not None else paired_flags[ui]
            out[ui] = cls.classify_with_states(mates, mstates, is_paired,
                                               make_consumer())
        return out
