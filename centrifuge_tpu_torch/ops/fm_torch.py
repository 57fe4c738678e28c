"""The device FM index for the PyTorch port: packed BWT blocks, packed
ftab rows, the load-time depth-12 ftab (K4), and the SA resolver (K3).

Layout (byte-equal to the JAX package's ops/fm_jax.py): the BWT is
repacked into 512-base block rows of 4 occ checkpoints followed by 32
uint32 words (16 bases per word, little-endian 2-bit codes); the wide
layout (indexes of 2^31 bases or more) splits 64-bit checkpoints into
lo/hi words (occ_lo[4] | occ_hi[4] | words[32]) and uses int64 rows.
uint32 words are held in int32 tensors (same bits); the kernels read
them as uint32.

The ftab and the depth-12 ftab are their own tensors of packed rows
(pack_ftab_rows), not trailing rows of one unified table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import _cuda
from ..index.cf_io import CFIndex
from .rank import bwt_at_plain, is_wide, level1, rank_plain, word_counts

BLOCK_BASES = 512
WORDS_PER_BLOCK = BLOCK_BASES // 16
N10 = 1 << 20           # depth-10 ftab entries
N12 = 1 << 24           # depth-12 ftab entries


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. There is no silent CPU path."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device present; pass device='cpu' "
                               "to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pack_ftab_rows(top_arr: np.ndarray, bot_arr: np.ndarray, wide: bool,
                   width: int) -> np.ndarray:
    """Pack (top, bot) ftab entries into block-shaped uint32 rows:
    narrow = 16 (top, bot) pairs per row; wide = 8 entries x 4 words
    (top_lo, top_hi, bot_lo, bot_hi)."""
    ne = top_arr.shape[0]
    if wide:
        per = 8
        nfr = (ne + per - 1) // per
        fr = np.zeros((nfr, width), dtype=np.uint32)
        quads = np.zeros((nfr * per, 4), dtype=np.uint32)
        t64 = top_arr.astype(np.uint64)
        b64 = bot_arr.astype(np.uint64)
        quads[:ne, 0] = (t64 & 0xFFFFFFFF).astype(np.uint32)
        quads[:ne, 1] = (t64 >> 32).astype(np.uint32)
        quads[:ne, 2] = (b64 & 0xFFFFFFFF).astype(np.uint32)
        quads[:ne, 3] = (b64 >> 32).astype(np.uint32)
        fr[:, : per * 4] = quads.reshape(nfr, per * 4)
    else:
        per = 16
        nfr = (ne + per - 1) // per
        fr = np.zeros((nfr, width), dtype=np.uint32)
        pairs = np.zeros((nfr * per, 2), dtype=np.uint32)
        pairs[:ne, 0] = top_arr.astype(np.uint32)
        pairs[:ne, 1] = bot_arr.astype(np.uint32)
        fr[:, : per * 2] = pairs.reshape(nfr, per * 2)
    return fr


def pack_bwt_blocks(bwt: np.ndarray, wide: bool) -> np.ndarray:
    """Repack a BWT code array into 512-base block rows.

    Narrow: uint32[nblk, 4 + 32] = occ[4] | words[32].
    Wide:   uint32[nblk, 8 + 32] = occ_lo[4] | occ_hi[4] | words[32].
    Occ counts are global prefix counts; '$' is counted as the code-0
    'A' it is stored as, and the rank subtracts it once."""
    n = bwt.shape[0]
    nblk = n // BLOCK_BASES + 1
    word_off = 8 if wide else 4
    out = np.zeros((nblk, word_off + WORDS_PER_BLOCK), dtype=np.uint32)
    # chunked over block ranges to bound the transient memory of the
    # uint32 cast to a few hundred MB
    chunk_blk = 1 << 20                      # 512 Mbases per chunk
    run = np.zeros(4, dtype=np.uint64)       # occ at chunk start
    for b0 in range(0, nblk, chunk_blk):
        b1 = min(nblk, b0 + chunk_blk)
        lo = b0 * BLOCK_BASES
        hi = min(n, b1 * BLOCK_BASES)
        codes = np.zeros((b1 - b0) * BLOCK_BASES, dtype=np.uint8)
        if hi > lo:
            codes[: hi - lo] = bwt[lo:hi]
        q = codes.reshape(-1, 16).astype(np.uint32)
        words = np.zeros(q.shape[0], dtype=np.uint32)
        for i in range(16):
            words |= q[:, i] << (2 * i)
        out[b0:b1, word_off:] = words.reshape(b1 - b0, WORDS_PER_BLOCK)
        blocks_codes = codes.reshape(b1 - b0, BLOCK_BASES)
        occ = np.zeros((b1 - b0, 4), dtype=np.uint64)
        for c in range(4):
            cnt = (blocks_codes == c).sum(axis=1).astype(np.uint64)
            occ[1:, c] = np.cumsum(cnt)[:-1]
            occ[:, c] += run[c]
            run[c] += cnt.sum()
        if wide:
            out[b0:b1, :4] = (occ & 0xFFFFFFFF).astype(np.uint32)
            out[b0:b1, 4:8] = (occ >> 32).astype(np.uint32)
        else:
            out[b0:b1, :4] = occ.astype(np.uint32)
    return out


def _pack_offs8(offs: np.ndarray) -> np.ndarray:
    """SA-sample values padded and reshaped to (n/8, 8) rows."""
    n = offs.shape[0]
    n8 = ((n + 7) // 8) * 8
    out = np.zeros(n8, np.int32)
    out[:n] = offs.astype(np.int32)
    return out.reshape(-1, 8)


def _lo32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 values as the int32 with the same bits."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def ftab12_plain(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
                 t0: torch.Tensor, b0: torch.Tensor, out: torch.Tensor,
                 chunk: int = 1 << 20, stats: dict = None) -> torch.Tensor:
    """Plain PyTorch depth-12 ftab (the twin of csrc/ftab12.cu): fills the
    packed rows of `out` in place and returns it. Entry idx = e10 |
    c10 << 20 | c11 << 22; ranges extend only where the parent range is
    non-empty, everything else stores (0, 0). stats (optional dict)
    receives `rank_rows`/`rank_chars`: lists of the LF ranks the entries
    need (both levels, non-empty ranges only)."""
    dev = blocks.device
    f = fchr.to(torch.int64)
    t0 = t0.to(torch.int64)
    b0 = b0.to(torch.int64)
    counts = word_counts(blocks)

    def lf_sel(rows: torch.Tensor, c: int) -> torch.Tensor:
        res = torch.empty_like(rows)
        for s in range(0, rows.shape[0], chunk):
            part = rows[s: s + chunk]
            ch = torch.full_like(part, c)
            res[s: s + chunk] = f[c] + rank_plain(blocks, zoff, part, ch,
                                                  counts)
            if stats is not None:
                stats.setdefault("rank_rows", []).append(part)
                stats.setdefault("rank_chars", []).append(ch)
        return res

    # level 1 (layout c10 << 20 | e10), over non-empty parents only
    t1 = torch.zeros(4 * N10, dtype=torch.int64, device=dev)
    b1 = torch.zeros_like(t1)
    par = torch.nonzero(b0 > t0)[:, 0]
    for c10 in range(4):
        t1[c10 * N10 + par] = lf_sel(t0[par], c10)
        b1[c10 * N10 + par] = lf_sel(b0[par], c10)
    # level 2, one c11 quarter (4 * N10 consecutive entries) at a time
    live = torch.nonzero(b1 > t1)[:, 0]
    wide = is_wide(blocks)
    per = 8 if wide else 16
    rows_q = 4 * N10 // per
    for c11 in range(4):
        t12 = torch.zeros(4 * N10, dtype=torch.int64, device=dev)
        b12 = torch.zeros_like(t12)
        t12[live] = lf_sel(t1[live], c11)
        b12[live] = lf_sel(b1[live], c11)
        if wide:
            packed = torch.stack([_lo32(t12), _lo32(t12 >> 32),
                                  _lo32(b12), _lo32(b12 >> 32)], dim=1)
        else:
            packed = torch.stack([_lo32(t12), _lo32(b12)], dim=1)
        out[c11 * rows_q: (c11 + 1) * rows_q, :32] = packed.reshape(
            rows_q, 32)
    return out


def ftab12_level1(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
                  t0: torch.Tensor, b0: torch.Tensor):
    """The depth-12 ftab's level 1: t1/b1[e10 | c10 << 20] = LF(t0[e10],
    c10) / LF(b0[e10], c10) where the depth-10 range is non-empty, else
    0; on CUDA tensors one launch of K0's level-1 entry (a tile of
    threads a depth-10 range), on CPU tensors the plain version."""
    if t0.shape != (N10,):
        raise ValueError("the level 1 extends the 2^20 depth-10 ranges")
    return level1(blocks, fchr, zoff, t0, b0)


def ftab12_level2(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
                  t0: torch.Tensor, b0: torch.Tensor, t1: torch.Tensor,
                  b1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K4's launch (CUDA tensors only): the 2^24 depth-12 entries from the
    depth-10 ranges t0/b0 and their level-1 extensions t1/b1, written in
    place into `out`, one tile of threads a level-1 range
    (csrc/ftab12.cu)."""
    _cuda.require_cuda(blocks, fchr, t0, b0, t1, b1, out)
    wide = is_wide(blocks)
    rdt = torch.int64 if wide else torch.int32
    if out.dtype != torch.int32 or out.shape != (
            N12 // (8 if wide else 16), blocks.shape[1]):
        raise ValueError("out must be the int32 packed depth-12 table")
    if any(t.dtype != rdt for t in (fchr, t0, b0, t1, b1)) \
            or t0.shape != (N10,) or b0.shape != (N10,) \
            or t1.shape != (4 * N10,) or b1.shape != (4 * N10,):
        raise ValueError("ftab12 ranges must be [2^20] (depth 10) and "
                         "[2^22] (level 1) in the row dtype")
    _cuda.require_aligned(blocks, out)
    lib = _cuda.lib("ftab12")
    fn = lib.fm_ftab12_wide if wide else lib.fm_ftab12_narrow
    rc = fn(blocks.data_ptr(), fchr.data_ptr(), int(zoff), t0.data_ptr(),
            b0.data_ptr(), t1.data_ptr(), b1.data_ptr(), out.data_ptr(),
            _cuda.work_counter(blocks.device).data_ptr(),
            _cuda.stream_ptr(blocks.device))
    _cuda.check(rc, "ftab12 kernel")
    _cuda.LAUNCHES["ftab12"] += 1
    return out


def build_ftab12(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
                 t0: torch.Tensor, b0: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """K4: the depth-12 ftab written in place into `out`, the zeroed
    packed-row table [2^24 / (16 | 8), 36 | 40]. On CUDA tensors: one
    launch of K0's level-1 entry, then one ftab12-kernel launch with a
    tile of threads a level-1 range; on CPU tensors the plain version."""
    if t0.shape[0] != N10:
        raise ValueError("the depth-12 ftab extends a depth-10 ftab")
    if not blocks.is_cuda:
        return ftab12_plain(blocks, fchr, zoff, t0, b0, out)
    _cuda.require_cuda(blocks, fchr, t0, b0, out)
    t1, b1 = ftab12_level1(blocks, fchr, zoff, t0, b0)
    return ftab12_level2(blocks, fchr, zoff, t0, b0, t1, b1, out)


@dataclass
class DeviceFMIndex:
    """Device-resident arrays for the FM search kernels."""

    blocks: torch.Tensor        # int32[nblk, 36|40]: occ then 32 bwt words
    ftab_rows: torch.Tensor     # int32[4^10/(16|8), 36|40]: packed ftab
    ftab12_rows: Optional[torch.Tensor]  # packed depth-12 ftab, or None
    fchr: torch.Tensor          # row dtype [5]
    ftab_top: torch.Tensor      # row dtype [4^ftab_chars]
    ftab_bot: torch.Tensor      # row dtype [4^ftab_chars]
    offs: torch.Tensor          # int32[ceil(n/8), 8] SA-sample seq indexes
    boundary_rows: torch.Tensor  # row dtype [nb] sorted
    boundary_refs: torch.Tensor  # int32[nb]
    zoff: int
    bwt_len: int
    ftab_chars: int
    offrate: int
    npat: int
    wide: bool = False
    host_blocks: Optional[np.ndarray] = None  # uint32 host copy of blocks
                                              # (the native HostResolver)

    TENSORS = ("blocks", "ftab_rows", "ftab12_rows", "fchr", "ftab_top",
               "ftab_bot", "offs", "boundary_rows", "boundary_refs")

    @property
    def nblk(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def row_dtype(self):
        return torch.int64 if self.wide else torch.int32

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def deep(self) -> bool:
        return self.ftab12_rows is not None

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in self.TENSORS
                if getattr(self, k) is not None}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.tensors().values())

    @staticmethod
    def build(idx: CFIndex, device="cuda", wide: bool = None,
              keep_host_blocks: bool = True,
              deep_ftab: bool = None) -> "DeviceFMIndex":
        """Pack and upload the index. wide: int64 rows (default: at 2^31
        bases or more). deep_ftab: build the depth-12 ftab at load
        (default: on for a depth-10 ftab over at least 2^25 bases, where
        the expected 12-mer range still holds ~2 rows)."""
        dev = resolve_device(device)
        if wide is None:
            wide = idx.bwt_len >= (1 << 31)
        if deep_ftab is None:
            deep_ftab = idx.ftab_chars == 10 and idx.bwt_len >= (1 << 25)
        elif deep_ftab and idx.ftab_chars != 10:
            raise ValueError("the depth-12 ftab extends a depth-10 ftab")
        rows = pack_bwt_blocks(idx.bwt, wide)
        it = np.int64 if wide else np.int32

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        width = rows.shape[1]
        fm = DeviceFMIndex(
            blocks=put(rows.view(np.int32)),
            ftab_rows=put(pack_ftab_rows(idx.ftab_top, idx.ftab_bot, wide,
                                         width).view(np.int32)),
            ftab12_rows=None,
            fchr=put(idx.fchr.astype(it)),
            ftab_top=put(idx.ftab_top.astype(it)),
            ftab_bot=put(idx.ftab_bot.astype(it)),
            offs=put(_pack_offs8(idx.offs)),
            boundary_rows=put(idx.boundary_rows.astype(it)),
            boundary_refs=put(idx.boundary_refidx.astype(np.int32)),
            zoff=int(idx.zoff), bwt_len=int(idx.bwt_len),
            ftab_chars=int(idx.ftab_chars), offrate=int(idx.offrate),
            npat=int(idx.npat), wide=bool(wide),
            host_blocks=rows if keep_host_blocks else None)
        if deep_ftab:
            fm.ftab12_rows = torch.zeros((N12 // (8 if wide else 16), width),
                                         dtype=torch.int32, device=dev)
            build_ftab12(fm.blocks, fm.fchr, fm.zoff, fm.ftab_top[:N10],
                         fm.ftab_bot[:N10], fm.ftab12_rows)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return fm

    @staticmethod
    def from_jax_arrays(d: dict, meta: dict, device="cuda",
                        keep_host_blocks: bool = True) -> "DeviceFMIndex":
        """The port's index from the host copies (np.asarray) of a JAX
        DeviceFMIndex's fields: `d` holds ufm, fchr, ftab_top, ftab_bot,
        offs, boundary_rows, boundary_refs; `meta` holds nblk, nblk12,
        zoff, bwt_len, ftab_chars, offrate, npat, wide. The unified JAX
        table splits at nblk (ftab rows) and nblk12 (depth-12 rows)."""
        dev = resolve_device(device)
        ufm = np.array(d["ufm"]).view(np.uint32)
        nblk, nblk12 = int(meta["nblk"]), int(meta.get("nblk12") or 0)
        wide = bool(meta["wide"])
        it = np.int64 if wide else np.int32
        blocks = ufm[:nblk]

        def put(a, dt=None) -> torch.Tensor:
            return torch.from_numpy(np.array(a, dtype=dt)).to(dev)

        return DeviceFMIndex(
            blocks=put(blocks.view(np.int32)),
            ftab_rows=put(ufm[nblk: nblk12 or None].view(np.int32)),
            ftab12_rows=put(ufm[nblk12:].view(np.int32)) if nblk12 else None,
            fchr=put(d["fchr"], it), ftab_top=put(d["ftab_top"], it),
            ftab_bot=put(d["ftab_bot"], it), offs=put(d["offs"], np.int32),
            boundary_rows=put(d["boundary_rows"], it),
            boundary_refs=put(d["boundary_refs"], np.int32),
            zoff=int(meta["zoff"]), bwt_len=int(meta["bwt_len"]),
            ftab_chars=int(meta["ftab_chars"]),
            offrate=int(meta["offrate"]), npat=int(meta["npat"]),
            wide=wide,
            host_blocks=np.array(blocks) if keep_host_blocks else None)



# ---- K3: SA row -> sequence index ----

RESOLVE_MAX_STEPS = 4096   # fm_jax's LF step bound
RESOLVE_UNROLL = 8         # fm_jax's steps per while-loop iteration


def walk_budget(max_steps: int, unroll: int = RESOLVE_UNROLL) -> int:
    """The LF steps a JAX resolve walk takes at most: its while_loop runs
    `unroll` steps per iteration, counts steps and tests max_steps once per
    iteration, so it stops after max_steps rounded up to a multiple of the
    unroll."""
    return -(-max_steps // unroll) * unroll


def try_offset_plain(fm: DeviceFMIndex, rows: torch.Tensor,
                     stats: dict = None) -> torch.Tensor:
    """The exits of each row (the JAX package's ops/fm_jax.py _try_offset,
    fm_common.cuh try_offset): 0 at the '$' row, which wins; else the
    sample of a sampled row, its index clipped to the padded table; else
    the ref of a genome-boundary row (its low 16 bits when npat <=
    0xFFFF), checked only when the last boundary row is nonzero and the
    row does not pass it; else -1. int32. stats (optional dict) receives
    `offs`: the sample indexes read."""
    r = rows.to(torch.int64)
    offs = fm.offs.reshape(-1)
    sampled = (r & ((1 << fm.offrate) - 1)) == 0
    si = (r >> fm.offrate).clamp(0, offs.numel() - 1)
    t = torch.where(sampled, offs[si], -1)
    nb = fm.boundary_rows.numel()
    if nb and int(fm.boundary_rows[-1]) > 0:
        br = fm.boundary_rows.to(torch.int64)
        pos = torch.searchsorted(br, r).clamp(max=nb - 1)
        bval = fm.boundary_refs[pos]
        if fm.npat <= 0xFFFF:
            bval = bval & 0xFFFF
        is_b = (br[pos] == r) & ~sampled & (r <= br[-1])
        t = torch.where(is_b, bval, t)
    t = torch.where(r == fm.zoff, 0, t)
    if stats is not None:
        stats.setdefault("offs", []).append(si[sampled])
    return t.to(torch.int32)


def resolve_rows_plain(fm: DeviceFMIndex, rows: torch.Tensor,
                       max_steps: int = RESOLVE_MAX_STEPS,
                       stats: dict = None) -> torch.Tensor:
    """Plain PyTorch K3: a lockstep LF walk over the rows not yet
    resolved, for at most walk_budget(max_steps) steps (the JAX walk's
    bound, tested once per 8 unrolled steps); -1 for rows still
    unresolved then.
    Returns int32 [N]. stats (optional dict) receives the kernel's
    lookups for these rows: `bwt_rows` and `rank_rows`/`rank_chars` of
    every LF step and `offs` of every sample read."""
    r = rows.to(torch.int64).clone()
    t = try_offset_plain(fm, r, stats)
    f = fm.fchr.to(torch.int64)
    counts = word_counts(fm.blocks)
    act = torch.nonzero(t < 0)[:, 0]
    for _ in range(walk_budget(max_steps)):
        if act.numel() == 0:
            break
        ra = r[act]
        c = bwt_at_plain(fm.blocks, ra)
        nxt = f[c] + rank_plain(fm.blocks, fm.zoff, ra, c, counts)
        ta = try_offset_plain(fm, nxt, stats)
        if stats is not None:
            for k, v in (("bwt_rows", ra), ("rank_rows", ra),
                         ("rank_chars", c)):
                stats.setdefault(k, []).append(v)
        r[act] = nxt
        t[act] = ta
        act = act[ta < 0]
    return t


def resolve_rows(fm: DeviceFMIndex, rows: torch.Tensor,
                 max_steps: int = RESOLVE_MAX_STEPS) -> torch.Tensor:
    """K3 over rows (row dtype [N]) -> int32 [N] sequence indexes, -1
    where unresolved: the CUDA kernel (csrc/resolve.cu: a tile of
    threads a row, rows taken from a work counter) for CUDA tensors, the
    plain version for CPU tensors."""
    if not (rows.is_cuda or fm.blocks.is_cuda):
        return resolve_rows_plain(fm, rows, max_steps)
    _cuda.require_cuda(fm.blocks, fm.fchr, fm.offs, fm.boundary_rows,
                       fm.boundary_refs, rows)
    if rows.dtype != fm.row_dtype or rows.dim() != 1:
        raise ValueError(f"rows must be a 1-d {fm.row_dtype} tensor")
    if rows.numel() >= _cuda.MAX_ITEMS:
        raise ValueError(f"{rows.numel()} rows: the walk takes fewer than "
                         f"{_cuda.MAX_ITEMS} a call")
    _cuda.require_aligned(fm.blocks)
    out = torch.empty(rows.shape, dtype=torch.int32, device=rows.device)
    if rows.numel() == 0:
        return out
    lib = _cuda.lib("resolve")
    fn = lib.fm_resolve_wide if fm.wide else lib.fm_resolve_narrow
    rc = fn(fm.blocks.data_ptr(), fm.fchr.data_ptr(), int(fm.zoff),
            fm.offs.data_ptr(), fm.offs.numel(), fm.boundary_rows.data_ptr(),
            fm.boundary_refs.data_ptr(), fm.boundary_rows.numel(),
            fm.offrate, int(fm.npat <= 0xFFFF), max_steps, rows.data_ptr(),
            out.data_ptr(), rows.numel(),
            _cuda.work_counter(rows.device).data_ptr(),
            _cuda.stream_ptr(rows.device))
    _cuda.check(rc, "resolve kernel")
    _cuda.LAUNCHES["resolve"] += 1
    return out


def make_resolver(fm: DeviceFMIndex, max_steps: int = RESOLVE_MAX_STEPS):
    """Batched SA-row -> sequence-index resolver over K3 (the JAX
    package's ops/fm_jax.py make_resolver): a callable from rows (numpy)
    to int32 numpy values, -1 where unresolved. On a CUDA index it
    uploads, launches and copies back on a stream of its own and returns
    finished arrays, so any thread may call it (the native tail calls it
    under engine.dev_lock). Like the JAX resolver it has no first_hits,
    bwops or needs_bucket: the native tail pads its rows to a lane bucket
    and sends extension misses to the engine's first-hit search."""
    stream = torch.cuda.Stream(fm.device) if fm.device.type == "cuda" \
        else None
    rdt = np.int64 if fm.wide else np.int32

    def resolve(rows) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(rows, dtype=rdt))
        if stream is None:
            return resolve_rows(fm, t, max_steps).numpy()
        with torch.cuda.stream(stream):
            return resolve_rows(fm, t.to(fm.device), max_steps).cpu().numpy()

    resolve.wide = fm.wide
    return resolve
