"""Data-parallel reads over a (dp, fm) mesh, the index sharded by BWT row
range over its fm axis: K6 and its host wrapper.

The JAX package's counterpart is parallel/sharded.py. Its two mesh axes
keep their meaning here:

  * dp: the lanes of a batch split into n_dp contiguous chunks, one per
    mesh row; each row's search runs on the row's lead device (its first
    device).
  * fm: the packed BWT block rows, the ftab entries and the SA samples
    split by range into n_fm shards, one per device of the row: the
    regime of an index too large for one device's memory (the wide
    layout, >= 2^31 bases). Every table read of a step is answered by
    the shard that owns the row, entry or sample; each shard writes its
    owner-masked partial and the sum over the shards gives the value.

A mesh is an (n_dp, n_fm) grid of torch devices, and a device may appear
more than once: `make_mesh(1, 4, ["cuda:0"] * 4)` puts four shards on one
card, `make_mesh(2, 2, ["cpu"] * 4)` runs the plain versions on the CPU.
A repeated device still holds one table per shard.

K6 is two CUDA kernels (csrc/sharded.cu), the search and the resolve
walk, each one launch per dp row on the row's lead device and its
current stream, with no host step loop and no device-to-host sync. One
thread runs one lane (or row) to its own end through the lane loops that
K1 and K3 run (csrc/fm_common.cuh search_lane, resolve_row), over the
row's shards: every table read goes to the shard that owns its key, in
registers. The ranges are disjoint, so that read is the JAX package's
owner-masked psum over the fm axis (parallel/sharded.py _shard_kernels,
_sharded_try_offset), including its 0 where no shard owns the key. The
shards' pointers and bases are described once per dp row when the mesh
index is placed (shard_descriptor); a shard on another card is read
through a peer mapping over NVLink, enabled then, and a pair of cards
without peer access is refused there. The bound is K1's and K3's: each
32-byte sector of the tables the lanes touch, once, over the card's
memory rate; each lane's chain of dependent row reads makes the kernels
latency-bound.

On the CPU the plain versions run: the lockstep search of
classify/engine.search_steps and a lockstep resolve walk, with every
table read the sum over the shards of the owner-masked local read. They
are independent of the kernels' design and are the tests' yardstick.

ShardedSearchEngine keeps the surface of the single-device
BatchSearchEngine that the pipeline and the native tail call, without
the presolve (the JAX sharded engine returns no prefetch). The TPU
transports (the dense hit pool, lockstep survivor segments, the unified
ftab+blocks table) are not copied: they change no output.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import _cuda
from ..classify.engine import BatchSearchEngine, search_steps
from ..index.cf_io import CFIndex
from ..ops.fm_torch import pack_bwt_blocks, resolve_device, walk_budget
from ..ops.rank import bwt_at_plain, rank_plain, word_counts

# the JAX sharded resolver runs 4 LF steps per while-loop iteration and
# tests its step count once per iteration (sharded.py:406-440): it gives
# up after walk_budget(max_steps, 4) steps
SHARDED_RESOLVE_UNROLL = 4
SHARDED_RESOLVE_MAX_STEPS = 4096
# the most shards K6's kernel parameter describes (csrc/fm_common.cuh
# kMaxShards)
MAX_SHARDS = 8


def _pad_to(arr: np.ndarray, mult: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + mult - 1) // mult) * mult
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


@dataclass
class ShardedFMArrays:
    """Host-side index arrays padded for the fm axis, and the geometry."""

    blocks: np.ndarray          # uint32 [nblk_pad, 36|40]
    fchr: np.ndarray            # row dtype [5] (replicated)
    ftab_tb: np.ndarray         # row dtype [4^ftab_chars, 2] (top, bot)
    offs: np.ndarray            # int32 [offs_pad]
    boundary_rows: np.ndarray   # row dtype [nb] (replicated)
    boundary_refs: np.ndarray   # int32 [nb]
    zoff: int
    bwt_len: int
    offrate: int
    npat: int
    n_fm: int
    wide: bool
    ftab_chars: int = 10

    # the fields ShardedFMArrays.from_jax reads
    JAX_FIELDS = ("blocks", "fchr", "ftab_tb", "offs", "boundary_rows",
                  "boundary_refs", "zoff", "bwt_len", "offrate", "npat",
                  "n_fm", "wide", "ftab_chars")

    @property
    def row_dtype(self):
        return np.int64 if self.wide else np.int32

    @property
    def nblk_per(self) -> int:
        return self.blocks.shape[0] // self.n_fm

    @property
    def nftab_per(self) -> int:
        return self.ftab_tb.shape[0] // self.n_fm

    @property
    def noffs_per(self) -> int:
        return self.offs.shape[0] // self.n_fm

    @staticmethod
    def build(idx: CFIndex, n_fm: int, wide: bool = None
              ) -> "ShardedFMArrays":
        """The JAX package's ownership rules: block rows padded to a
        multiple of n_fm and split by row >> 9; ftab entries split by
        entry index (n_fm must divide 4^ftab_chars); samples padded to a
        multiple of n_fm and split by row >> offrate."""
        if wide is None:
            wide = idx.bwt_len >= (1 << 31)
        if (1 << (2 * idx.ftab_chars)) % n_fm != 0:
            raise ValueError("ftab size must divide the fm axis")
        it = np.int64 if wide else np.int32
        return ShardedFMArrays(
            blocks=_pad_to(pack_bwt_blocks(idx.bwt, wide), n_fm),
            fchr=idx.fchr.astype(it),
            ftab_tb=np.stack([idx.ftab_top.astype(it),
                              idx.ftab_bot.astype(it)], axis=1),
            offs=_pad_to(idx.offs.astype(np.int32), n_fm),
            boundary_rows=idx.boundary_rows.astype(it),
            boundary_refs=idx.boundary_refidx.astype(np.int32),
            zoff=int(idx.zoff), bwt_len=int(idx.bwt_len),
            offrate=int(idx.offrate), npat=int(idx.npat), n_fm=n_fm,
            wide=bool(wide), ftab_chars=int(idx.ftab_chars))

    @staticmethod
    def from_device_index(fm, n_fm: int) -> "ShardedFMArrays":
        """The arrays of a built DeviceFMIndex (ops/fm_torch.py), copied to
        the host, under build's ownership rules: the same blocks, ftab
        entries and SA samples (ceil(bwt_len / 2^offrate) of them, without
        the index's 8-padding), padded to a multiple of n_fm."""
        if (1 << (2 * fm.ftab_chars)) % n_fm != 0:
            raise ValueError("ftab size must divide the fm axis")

        def host(t):
            return t.cpu().numpy()

        n_samples = -(-fm.bwt_len >> fm.offrate)
        return ShardedFMArrays(
            blocks=_pad_to(host(fm.blocks).view(np.uint32), n_fm),
            fchr=host(fm.fchr),
            ftab_tb=np.stack([host(fm.ftab_top), host(fm.ftab_bot)], axis=1),
            offs=_pad_to(host(fm.offs.reshape(-1)[:n_samples]), n_fm),
            boundary_rows=host(fm.boundary_rows),
            boundary_refs=host(fm.boundary_refs), zoff=int(fm.zoff),
            bwt_len=int(fm.bwt_len), offrate=int(fm.offrate),
            npat=int(fm.npat), n_fm=n_fm, wide=bool(fm.wide),
            ftab_chars=int(fm.ftab_chars))

    @staticmethod
    def from_jax(fields) -> "ShardedFMArrays":
        """The port's arrays from the host fields of a JAX ShardedFMArrays
        (a mapping of JAX_FIELDS, e.g. {k: getattr(jsh, k) ...}), read
        before any JAX device upload. The JAX `ufm` interleave is not
        carried: the port keeps plain per-shard tables."""
        wide = bool(fields["wide"])
        it = np.int64 if wide else np.int32

        def arr(k, dt):
            return np.array(fields[k], dtype=dt)

        return ShardedFMArrays(
            blocks=np.array(fields["blocks"]).view(np.uint32),
            fchr=arr("fchr", it), ftab_tb=arr("ftab_tb", it),
            offs=arr("offs", np.int32),
            boundary_rows=arr("boundary_rows", it),
            boundary_refs=arr("boundary_refs", np.int32),
            zoff=int(fields["zoff"]), bwt_len=int(fields["bwt_len"]),
            offrate=int(fields["offrate"]), npat=int(fields["npat"]),
            n_fm=int(fields["n_fm"]), wide=wide,
            ftab_chars=int(fields["ftab_chars"]))


class Mesh:
    """An (n_dp, n_fm) grid of torch devices. Row d holds dp shard d of
    the lanes; its device f holds fm shard f of the index, and its first
    device leads (runs the advance and holds the lane state). A device
    may appear more than once."""

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = [[resolve_device(d) for d in row] for row in devices]
        n_fm = len(self.devices[0]) if self.devices else 0
        if not n_fm or any(len(r) != n_fm for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        kinds = {d.type for row in self.devices for d in row}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh is all cpu or all cuda devices, not "
                             f"{sorted(kinds)}")
        self.on_cuda = kinds == {"cuda"}
        self.shape = {"dp": len(self.devices), "fm": n_fm}

    @property
    def n_dp(self) -> int:
        return self.shape["dp"]

    @property
    def n_fm(self) -> int:
        return self.shape["fm"]

    def distinct(self) -> List[torch.device]:
        seen = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def make_mesh(n_dp: int, n_fm: int, devices=None) -> Mesh:
    """A (dp, fm) mesh over the first n_dp * n_fm of `devices` (default:
    every CUDA device), row by row. Repeat a device to place several
    shards or dp rows on it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n_dp * n_fm:
        raise ValueError(f"a ({n_dp}, {n_fm}) mesh needs {n_dp * n_fm} "
                         f"devices, got {len(devices)}")
    return Mesh([devices[d * n_fm: (d + 1) * n_fm] for d in range(n_dp)])


def pad_lanes(rseq: np.ndarray, lengths: np.ndarray, start: np.ndarray,
              n_dp: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the lane dimension to a multiple of the dp axis (dead lanes
    have length 0 and finish at once)."""
    return (_pad_to(rseq, n_dp), _pad_to(lengths, n_dp),
            _pad_to(start, n_dp))


def _lane_slices(n: int, n_dp: int) -> List[slice]:
    """The contiguous, lane-major dp chunks of n lanes."""
    if n % n_dp:
        raise ValueError(f"{n} lanes do not split over {n_dp} dp rows "
                         "(pad_lanes)")
    per = n // n_dp
    return [slice(d * per, (d + 1) * per) for d in range(n_dp)]


@dataclass
class FMShard:
    """One fm shard's tables on its device."""

    device: torch.device
    blocks: torch.Tensor     # int32 [nblk_per, 36|40]
    ftab_tb: torch.Tensor    # row dtype [nftab_per, 2]
    offs: torch.Tensor       # int32 [noffs_per]
    fchr: torch.Tensor       # row dtype [5]
    blk_base: int            # first block row, ftab entry and sample held
    ftab_base: int
    offs_base: int


@dataclass
class MeshRow:
    """A dp row: its lead device, its n_fm shards, the replicated arrays
    on the lead, and on a CUDA mesh K6's shard descriptor."""

    lead: torch.device
    shards: List[FMShard]
    fchr: torch.Tensor
    brows: torch.Tensor
    brefs: torch.Tensor
    desc: np.ndarray = None


class MeshIndex:
    """A ShardedFMArrays placed on a mesh: shard f's tables on each
    device of fm column f (one copy per device, however often it
    appears), the replicated arrays on each row's lead. On a CUDA mesh
    each row's lead gets peer access to the row's other cards (raises
    where a pair has none) and the row its shard descriptor."""

    def __init__(self, sh: ShardedFMArrays, mesh: Mesh):
        if mesh.n_fm != sh.n_fm:
            raise ValueError(f"the arrays are split {sh.n_fm} ways, the "
                             f"mesh's fm axis is {mesh.n_fm}")
        if mesh.on_cuda:
            if sh.n_fm > MAX_SHARDS:
                raise ValueError(f"K6 takes at most {MAX_SHARDS} fm shards, "
                                 f"not {sh.n_fm}")
            _enable_peers(mesh)
        self.mesh = mesh
        self.on_cuda = mesh.on_cuda
        for k in ("zoff", "bwt_len", "offrate", "npat", "n_fm", "wide",
                  "ftab_chars", "nblk_per", "nftab_per", "noffs_per"):
            setattr(self, k, getattr(sh, k))
        self.row_dtype = torch.int64 if sh.wide else torch.int32
        self._cache: Dict = {}

        def put(key, dev, a):
            if (key, dev) not in self._cache:
                self._cache[key, dev] = torch.from_numpy(
                    np.ascontiguousarray(a)).to(dev)
            return self._cache[key, dev]

        def shard(f, dev):
            b, e, o = (f * sh.nblk_per, f * sh.nftab_per,
                       f * sh.noffs_per)
            return FMShard(
                device=dev,
                blocks=put(("blocks", f), dev,
                           sh.blocks[b: b + sh.nblk_per].view(np.int32)),
                ftab_tb=put(("ftab", f), dev,
                            sh.ftab_tb[e: e + sh.nftab_per]),
                offs=put(("offs", f), dev, sh.offs[o: o + sh.noffs_per]),
                fchr=put("fchr", dev, sh.fchr), blk_base=b, ftab_base=e,
                offs_base=o)

        self.rows = [
            MeshRow(lead=row[0],
                    shards=[shard(f, d) for f, d in enumerate(row)],
                    fchr=put("fchr", row[0], sh.fchr),
                    brows=put("brows", row[0], sh.boundary_rows),
                    brefs=put("brefs", row[0], sh.boundary_refs))
            for row in mesh.devices]
        if self.on_cuda:
            for row in self.rows:
                row.desc = shard_descriptor(self, row)
            for dev in mesh.distinct():
                torch.cuda.synchronize(dev)

    @property
    def device(self) -> torch.device:
        return self.rows[0].lead

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._cache.values())


def shard_descriptor(index: MeshIndex, row: MeshRow) -> np.ndarray:
    """The int64 words that describe a dp row's shards to K6
    (csrc/fm_common.cuh shard_set): n_fm, the per-shard block, ftab and
    sample counts, zoff, the address of fchr on the lead, then per shard
    the addresses of its blocks, ftab pairs and samples and its first
    block row, ftab entry and sample. Shard f owns keys [f * per,
    (f + 1) * per) of each table. Block tables must be 16-byte aligned
    (the row scan reads them in 16-byte chunks)."""
    _cuda.require_aligned(*[s.blocks for s in row.shards])
    words = [len(row.shards), index.nblk_per, index.nftab_per,
             index.noffs_per, int(index.zoff), row.fchr.data_ptr()]
    for s in row.shards:
        words += [s.blocks.data_ptr(), s.ftab_tb.data_ptr(),
                  s.offs.data_ptr(), s.blk_base, s.ftab_base, s.offs_base]
    return np.array(words, dtype=np.int64)


def _enable_peers(mesh: Mesh) -> None:
    """Peer access from each row's lead to every other card of its row,
    checked for all pairs first: K6 reads those cards' shards in place."""
    pairs = sorted({(row[0].index, d.index) for row in mesh.devices
                    for d in row if d != row[0]})
    for lead, other in pairs:
        if not torch.cuda.can_device_access_peer(lead, other):
            raise RuntimeError(
                f"cuda:{lead} has no peer access to cuda:{other}: K6 on "
                f"cuda:{lead} reads the shards on cuda:{other} in place")
    for lead, other in pairs:
        _cuda.check(_cuda.lib("sharded").fm_shard_enable_peer(lead, other),
                    f"peer access from cuda:{lead} to cuda:{other}")


# ---- the plain versions ----

class ShardTableReads:
    """classify/engine.TableReads over one dp row's shards: each read is
    the sum over the shards of the shard's owner-masked read of its own
    slice (the JAX package's masked gather + psum, sharded.py:169-214).
    A shard reads its block rows at local rows (row - 512 * blk_base),
    with '$' at zoff - 512 * blk_base, so the rank's '$' correction
    compares the same global positions. int64 results on the lanes'
    device; rows, entries or samples no shard owns read 0."""

    deep = False

    def __init__(self, index: MeshIndex, row: MeshRow):
        self.index = index
        self.row = row
        self.zoff = int(index.zoff)
        self.fchr = row.fchr.to(torch.int64)
        self.row_dtype = index.row_dtype
        self.counts = [word_counts(s.blocks) for s in row.shards]

    def _sum(self, keys: torch.Tensor, base_of, per: int, read) -> list:
        """Per shard: the lanes whose key (block, entry or sample index)
        the shard owns, read there and written into zero-filled outputs
        (the shards' key ranges are disjoint: a lane has one owner at
        most, and one no shard owns reads 0)."""
        out = None
        for k, s in enumerate(self.row.shards):
            local = keys - base_of(s)
            own = torch.nonzero((local >= 0) & (local < per))[:, 0]
            if out is not None and own.numel() == 0:
                continue
            vals = read(k, s, own, local[own].to(s.device))
            if out is None:
                out = [torch.zeros(keys.shape, dtype=torch.int64,
                                   device=keys.device) for _ in vals]
            for o, v in zip(out, vals):
                o[own] = v.to(o.device, torch.int64)
        return out

    def rank(self, rows: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
        r = rows.to(torch.int64)

        def read(k, s, own, _):
            b = 512 * s.blk_base
            return [rank_plain(s.blocks, self.zoff - b,
                               (r[own] - b).to(s.device),
                               chars[own].to(s.device), self.counts[k])]

        return self._sum(r >> 9, lambda s: s.blk_base,
                         self.index.nblk_per, read)[0]

    def bwt(self, rows: torch.Tensor) -> torch.Tensor:
        r = rows.to(torch.int64)

        def read(k, s, own, _):
            return [bwt_at_plain(s.blocks,
                                 (r[own] - 512 * s.blk_base).to(s.device))]

        return self._sum(r >> 9, lambda s: s.blk_base,
                         self.index.nblk_per, read)[0]

    def ftab(self, fi: torch.Tensor):
        def read(k, s, own, li):
            tb = s.ftab_tb[li]
            return [tb[:, 0], tb[:, 1]]

        return tuple(self._sum(fi.to(torch.int64), lambda s: s.ftab_base,
                               self.index.nftab_per, read))

    def sample(self, rows: torch.Tensor) -> torch.Tensor:
        """offs[row >> offrate] from the owning shard, 0 where none owns
        it (the index past the padded table)."""
        def read(k, s, own, li):
            return [s.offs[li]]

        return self._sum(rows.to(torch.int64) >> self.index.offrate,
                         lambda s: s.offs_base, self.index.noffs_per,
                         read)[0]

    def try_offset(self, rows: torch.Tensor,
                   stats: dict = None) -> torch.Tensor:
        """The exits of each row over the sharded sample (the JAX
        package's _sharded_try_offset): 0 at the '$' row, which wins; else
        the sample of a sampled row from the shard owning row >> offrate,
        0 where no shard owns it (no clip to the table); else the ref of a
        boundary row (low 16 bits when npat <= 0xFFFF) when the last
        boundary row is nonzero and the row does not pass it; else -1.
        int32. stats receives `offs`: the sample indexes read."""
        ix = self.index
        r = rows.to(torch.int64)
        sampled = (r & ((1 << ix.offrate) - 1)) == 0
        t = torch.where(sampled, self.sample(r), -1)
        br = self.row.brows.to(torch.int64).to(r.device)
        nb = br.numel()
        if nb:
            pos = torch.searchsorted(br, r).clamp(max=nb - 1)
            bval = self.row.brefs.to(r.device)[pos].to(torch.int64)
            if ix.npat <= 0xFFFF:
                bval = bval & 0xFFFF
            is_b = (br[pos] == r) & ~sampled & (br[-1] > 0) & (r <= br[-1])
            t = torch.where(is_b, bval, t)
        t = torch.where(r == ix.zoff, 0, t)
        if stats is not None:
            stats.setdefault("offs", []).append((r >> ix.offrate)[sampled])
        return t.to(torch.int32)


def sharded_search_plain(index: MeshIndex, reads: torch.Tensor,
                         lengths: torch.Tensor, start: torch.Tensor,
                         mh: int, min_hitlen: int, increment: int,
                         first_hit_only: bool, stats: dict = None):
    """Plain PyTorch K6 search: per dp row, the lockstep loop of
    search_plain (no depth-12 prime) over the row's sharded table reads.
    Returns the 6 output tensors on the lanes' device; stats as
    search_plain's (global rows and entries)."""
    outs = []
    for row, sl in zip(index.rows, _lane_slices(reads.shape[0],
                                                len(index.rows))):
        outs.append(search_steps(
            ShardTableReads(index, row), reads[sl], lengths[sl], start[sl],
            mh, min_hitlen, increment, first_hit_only, False, stats))
    return [torch.cat([o[k] for o in outs]) for k in range(6)]


def sharded_resolve_plain(index: MeshIndex, rows: torch.Tensor,
                          max_steps: int = SHARDED_RESOLVE_MAX_STEPS,
                          stats: dict = None) -> torch.Tensor:
    """Plain PyTorch K6 resolve walk (resolve_rows_plain over the shards):
    per dp row, a lockstep LF walk of the rows not yet at an exit, each
    step's BWT char and rank from the block's owner, for at most
    walk_budget(max_steps, 4) steps; -1 for rows still unresolved. int32
    [N]. stats as resolve_rows_plain's."""
    outs = []
    for row, sl in zip(index.rows, _lane_slices(rows.shape[0],
                                                len(index.rows))):
        tables = ShardTableReads(index, row)
        r = rows[sl].to(torch.int64).clone()
        t = tables.try_offset(r, stats)
        act = torch.nonzero(t < 0)[:, 0]
        for _ in range(walk_budget(max_steps, SHARDED_RESOLVE_UNROLL)):
            if act.numel() == 0:
                break
            ra = r[act]
            c = tables.bwt(ra)
            nxt = tables.fchr.to(ra.device)[c] + tables.rank(ra, c)
            ta = tables.try_offset(nxt, stats)
            if stats is not None:
                for k, v in (("bwt_rows", ra), ("rank_rows", ra),
                             ("rank_chars", c)):
                    stats.setdefault(k, []).append(v)
            r[act] = nxt
            t[act] = ta
            act = act[ta < 0]
        outs.append(t)
    return torch.cat(outs)


# ---- K6 on CUDA devices ----

def _check_on_index(index: MeshIndex, *tensors) -> bool:
    """True for CUDA tensors on a CUDA mesh (launch K6), False for CPU
    tensors on a CPU mesh (the plain version); raises on a mix."""
    cuda = [t.is_cuda for t in tensors]
    if all(cuda) and index.on_cuda:
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
        return True
    if not any(cuda) and not index.on_cuda:
        return False
    raise ValueError("K6 takes CUDA tensors on a CUDA mesh, CPU tensors on "
                     "a CPU mesh")


def sharded_search(index: MeshIndex, reads: torch.Tensor,
                   lengths: torch.Tensor, start: torch.Tensor, mh: int,
                   min_hitlen: int, increment: int, first_hit_only: bool):
    """K6 search over all lanes (reads uint8 [L, row_bytes], lengths and
    start int32 [L], L a multiple of n_dp): for CUDA tensors on a CUDA
    mesh, one kernel launch per dp row on its lead's current stream; for
    CPU tensors on a CPU mesh, the plain version. Returns [h_top, h_bot,
    h_off, h_len, nhits, sums] on the inputs' device."""
    if not _check_on_index(index, reads, lengths, start):
        return sharded_search_plain(index, reads, lengths, start, mh,
                                    min_hitlen, increment, first_hit_only)
    L = reads.shape[0]
    if reads.dtype != torch.uint8 or lengths.dtype != torch.int32 \
            or start.dtype != torch.int32 or reads.dim() != 2 \
            or lengths.shape != (L,) or start.shape != (L,):
        raise ValueError("reads must be uint8 [L, row_bytes], lengths and "
                         "start int32 [L]")
    dev, idt, i32 = reads.device, index.row_dtype, torch.int32
    out = [torch.empty((L, mh), dtype=idt, device=dev),
           torch.empty((L, mh), dtype=idt, device=dev),
           torch.empty((L, mh), dtype=i32, device=dev),
           torch.empty((L, mh), dtype=i32, device=dev),
           torch.empty(L, dtype=i32, device=dev),
           torch.empty(L, dtype=i32, device=dev)]
    fn = getattr(_cuda.lib("sharded"),
                 f"fm_shard_search_{'wide' if index.wide else 'narrow'}")
    for row, sl in zip(index.rows, _lane_slices(L, len(index.rows))):
        ins = [t[sl].to(row.lead) for t in (reads, lengths, start)]
        outs = [o[sl] if row.lead == dev else torch.empty_like(o[sl],
                                                             device=row.lead)
                for o in out]
        with torch.cuda.device(row.lead):
            rc = fn(row.desc.ctypes.data, ins[0].data_ptr(), reads.shape[1],
                    ins[1].data_ptr(), ins[2].data_ptr(),
                    *[o.data_ptr() for o in outs], sl.stop - sl.start, mh,
                    min_hitlen, increment, int(first_hit_only),
                    _cuda.stream_ptr(row.lead))
        _cuda.check(rc, "sharded search")
        _cuda.LAUNCHES["sharded_search"] += 1
        if row.lead != dev:
            for o, r in zip(out, outs):
                o[sl].copy_(r)
    return out


def sharded_resolve(index: MeshIndex, rows: torch.Tensor,
                    max_steps: int = SHARDED_RESOLVE_MAX_STEPS
                    ) -> torch.Tensor:
    """K6 resolve walk over rows (row dtype [N], N a multiple of n_dp,
    each >= 0) -> int32 [N], -1 where unresolved after
    walk_budget(max_steps, 4) LF steps: one kernel launch per dp row for
    CUDA tensors on a CUDA mesh, the plain version for CPU tensors on a
    CPU mesh."""
    if not _check_on_index(index, rows):
        return sharded_resolve_plain(index, rows, max_steps)
    if rows.dtype != index.row_dtype or rows.dim() != 1:
        raise ValueError(f"rows must be a 1-d {index.row_dtype} tensor")
    tidx = torch.empty(rows.shape, dtype=torch.int32, device=rows.device)
    fn = getattr(_cuda.lib("sharded"),
                 f"fm_shard_resolve_{'wide' if index.wide else 'narrow'}")
    for row, sl in zip(index.rows, _lane_slices(rows.shape[0],
                                                len(index.rows))):
        part = rows[sl].to(row.lead)
        got = tidx[sl] if row.lead == rows.device else torch.empty(
            part.shape, dtype=torch.int32, device=row.lead)
        with torch.cuda.device(row.lead):
            rc = fn(row.desc.ctypes.data, row.brows.data_ptr(),
                    row.brefs.data_ptr(), row.brows.numel(), index.offrate,
                    int(index.npat <= 0xFFFF), max_steps, part.data_ptr(),
                    got.data_ptr(), part.numel(), _cuda.stream_ptr(row.lead))
        _cuda.check(rc, "sharded resolve")
        _cuda.LAUNCHES["sharded_resolve"] += 1
        if row.lead != rows.device:
            tidx[sl].copy_(got)
    return tidx


@contextlib.contextmanager
def _on_streams(streams):
    """Each device's current stream set to its stream in `streams`."""
    with contextlib.ExitStack() as st:
        for s in (streams or {}).values():
            st.enter_context(torch.cuda.stream(s))
        yield


def _streams(index: MeshIndex):
    return {d: torch.cuda.Stream(d) for d in index.mesh.distinct()} \
        if index.on_cuda else None


def make_sharded_resolver(index: MeshIndex,
                          max_steps: int = SHARDED_RESOLVE_MAX_STEPS):
    """SA-row -> sequence-index resolver over the mesh (the JAX package's
    make_sharded_resolver): numpy rows in, int32 numpy values out, -1
    where unresolved. Rows are padded to a multiple of n_dp with row 0
    (sampled: it exits at once). On a CUDA mesh it runs on streams of its
    own and returns finished arrays, so any thread may call it."""
    streams = _streams(index)
    rdt = np.int64 if index.wide else np.int32
    n_dp = index.mesh.n_dp

    def resolve(rows) -> np.ndarray:
        rows = np.ascontiguousarray(rows, dtype=rdt)
        n = rows.shape[0]
        padded = np.zeros(-(-n // n_dp) * n_dp, rdt)
        padded[:n] = rows
        t = torch.from_numpy(padded)
        if streams is None:
            return sharded_resolve(index, t, max_steps).numpy()[:n]
        with _on_streams(streams):
            out = sharded_resolve(index, t.to(index.device), max_steps)
            return out.cpu().numpy()[:n]

    resolve.wide = index.wide
    return resolve


class ShardedSearchEngine(BatchSearchEngine):
    """BatchSearchEngine over a mesh: lanes split into contiguous dp
    chunks, each searched by K6 on its row's shards; outputs copied to
    pinned host buffers behind one event. No presolve (the dispatch
    returns no prefetch) and no depth-12 prime. Lane counts are buckets
    of at least max(256, n_dp), overflow re-runs of at least
    max(32, n_dp) lanes."""

    def __init__(self, index: MeshIndex, min_hitlen: int = 22):
        super().__init__(index, min_hitlen)
        self.index = index
        self.n_dp = index.mesh.n_dp
        self.lane_bucket_lo = max(256, self.n_dp)
        self.overflow_bucket_lo = max(32, self.n_dp)
        self._stream = None
        self._streams = _streams(index)

    def _deep(self, lmax: int) -> bool:
        return False

    def search_async(self, seqs, presolve: bool = False, khits: int = 5,
                     ihits: int = 200):
        return super().search_async(seqs)

    def _launch(self, handle, start, first_hit_only: bool):
        index = self.index
        args = (handle.mh, self.min_hitlen, self.increment, first_hit_only)
        if not index.on_cuda:
            handle.host_out = sharded_search(
                index, *self._inputs(handle, start), *args)
            return handle
        with self.dev_lock, _on_streams(self._streams):
            out = sharded_search(index, *self._inputs(handle, start), *args)
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in out]
            for h, o in zip(host, out):
                h.copy_(o, non_blocking=True)
            handle.event = torch.cuda.Event()
            handle.event.record(self._streams[index.device])
            handle.device_out = out
            handle.host_out = host
        return handle
