"""Multi-process classification: one pipeline per process, each over its
own local mesh, joined by torch.distributed for host scalars only.

The JAX package's counterpart (parallel/multihost.py) joins the
processes' devices into one global SPMD mesh. Its fm groups are
process-local (multihost.py:85-88), so the port keeps that split: each
process drives K6 on its own (dp, fm) mesh of local devices and
classifies its own shard of the reads (shard_reads, the --file-parallel
analog). The process group (gloo, over a TCP store at the coordinator's
address) carries only `sync_max`, the global max of a host scalar. The
syncs stay where the JAX package has them: they fix the padded shapes
(read length bucket, lane bucket, overflow re-run, first-hit chunks,
resolve bucket) and the number of extension rounds, and no row depends
on them. The port packs reads in one transport mode (two codes per
byte), so the JAX package's global-min transport mode has nothing to
choose.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..classify.engine import SearchHandle, _bucket
from .sharded import (MeshIndex, ShardedFMArrays, ShardedSearchEngine,
                      make_mesh, make_sharded_resolver)


def initialize(coordinator: str, num_processes: int,
               process_id: int) -> None:
    """Join the process group: gloo over a TCP store at `coordinator`
    ("host:port", e.g. "localhost:29511"); call once per process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def sync_max(value: int) -> int:
    """The max of a host-side scalar over the processes (an all_reduce of
    an int64 CPU tensor); the value itself without a process group."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


class MultihostSearchEngine(ShardedSearchEngine):
    """ShardedSearchEngine with the multi-process syncs: globally bucketed
    dims, the overflow re-run whenever any process overflowed (with
    synced shapes), and first-hit searches padded to the global count."""

    def __init__(self, index: MeshIndex, min_hitlen: int = 22):
        super().__init__(index, min_hitlen)
        self.nproc = _world_size()
        self.local_dp = self.n_dp   # each process drives its own mesh

    def _dims(self, seqs):
        lmax = _bucket(max((len(s) for s in seqs), default=1),
                       lo=self.lmax_lo)
        nlocal = _bucket(max(len(seqs), 1),
                         lo=max(self.lane_bucket_lo // self.nproc,
                                self.local_dp))
        return sync_max(lmax), sync_max(nlocal)

    def search_async(self, seqs, presolve: bool = False, khits: int = 5,
                     ihits: int = 200) -> SearchHandle:
        lmax, nlocal = self._dims(seqs)
        reads, lengths = self._pack_lanes(seqs, lmax, nlocal)
        mh = min(self.FIRST_MAX_HITS, lmax)
        h = SearchHandle(reads, lengths, mh, lmax, nlocal)
        return self._launch(h, None, False)

    def _handle_overflow(self, out, rseqp, lengths, mh, lmax, nlanes):
        over = np.nonzero(out[4] > mh)[0]
        mh2 = 2 * mh if over.shape[0] == 0 else min(
            _bucket(int(out[4].max()), lo=2 * mh), lmax)
        nover = _bucket(max(int(over.shape[0]), 1),
                        lo=max(32, self.local_dp))
        # every process re-runs when any process overflowed
        if sync_max(int(over.shape[0])) == 0:
            return out
        return self._rerun_overflow(out, over, sync_max(nover),
                                    sync_max(mh2), rseqp, lengths, lmax,
                                    nlanes)

    def search_first_hits(self, seqs, offsets: np.ndarray):
        L = len(seqs)
        g_L = sync_max(L)
        if g_L == 0:
            return [np.zeros((0, 1), np.int32)] * 4 + [
                np.zeros(0, np.int32)] * 2
        seqs = list(seqs) + [np.zeros(0, np.uint8)] * (g_L - L)
        offsets = np.concatenate(
            [np.asarray(offsets), np.zeros(g_L - L, np.int64)])
        out = super().search_first_hits(seqs, offsets)
        return [a[:L] for a in out]


def make_multihost_resolver(index: MeshIndex, engine: MultihostSearchEngine):
    """make_sharded_resolver with its rows padded to a globally synced
    bucket."""
    base = make_sharded_resolver(index)

    def resolve(rows) -> np.ndarray:
        rows = np.asarray(rows)
        cap = sync_max(_bucket(max(rows.shape[0], 1),
                               lo=max(256, engine.local_dp)))
        padded = np.zeros(cap, rows.dtype)
        padded[: rows.shape[0]] = rows
        return base(padded)[: rows.shape[0]]

    resolve.wide = index.wide
    return resolve


def make_multihost_pipeline(idx, cfg=None, n_fm: int = 1, wide=None,
                            devices: List = None):
    """This process's pipeline over a mesh of its local `devices` (default:
    every CUDA device), n_fm shards per dp row. Every process calls it and
    then classifies the same number of batches; shard_reads splits the
    input."""
    from ..classify.gpu_pipeline import GPUClassificationPipeline
    from ..classify.pipeline import PipelineConfig
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = make_mesh(len(devices) // n_fm, n_fm, devices)
    cfg = cfg or PipelineConfig()
    index = MeshIndex(ShardedFMArrays.build(idx, n_fm, wide=wide), mesh)
    engine = MultihostSearchEngine(index, cfg.classifier.min_hitlen)
    pipe = GPUClassificationPipeline.__new__(GPUClassificationPipeline)
    pipe._init_with_engine(idx, cfg, engine,
                           make_multihost_resolver(index, engine),
                           sync=sync_max)
    pipe.metrics.ebwt_bytes = int(index.nbytes)
    pipe.presolve = False
    return pipe


def shard_reads(reads, process_id: int, num_processes: int):
    """Contiguous equal shards (the --file-parallel analog)."""
    per = (len(reads) + num_processes - 1) // num_processes
    return reads[process_id * per: (process_id + 1) * per]
