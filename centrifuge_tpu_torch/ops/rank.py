"""K0: batched rank_c(row) and LF(row, c) over the packed BWT blocks,
and the depth-12 ftab's level 1 (LF of both ends of every depth-10
range for every code).

The CUDA kernels (csrc/rank.cu: `rank` a tile of kTile threads a
query, `level1` a tile of kTileL1 threads a range) run for tensors on a
CUDA device; the plain PyTorch versions below run for tensors on the
CPU, and are what the kernels are held against on the card. They compute the JAX package's
rank_kernel / lf_kernel (ops/fm_jax.py) and its Pallas rank kernel
(ops/pallas_rank.py), and the level 1 of its _ftab12_rows_graph, narrow
(int32 rows, 36-word blocks) and wide (int64 rows, 40-word blocks).

Counting trick: XOR each word with the char's repeated 2-bit pattern, so
matching bases become 00; AND the complement's two bit planes to get one
marker bit per base; count the marker bits of the first `row & 511`
bases and add the block's occ checkpoint. '$' is stored as code 0 at
row zoff and subtracted once. The kernel counts word by word; the plain
version takes the full words' counts from a per-block prefix table
(word_counts) and counts only the partial word.
"""

from __future__ import annotations

import torch

from .. import _cuda

WORDS_PER_BLOCK = 32
_M32 = 0xFFFFFFFF


def is_wide(blocks: torch.Tensor) -> bool:
    return blocks.shape[1] == 8 + WORDS_PER_BLOCK


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words holding uint32 bit patterns -> int64 values."""
    return x.to(torch.int64) & _M32


def _i32(v: int) -> int:
    """The int32 value with the bits of the uint32 v."""
    return v - (1 << 32) if v >= (1 << 31) else v


# mask of the first n bases of a word, n = 0..16, as int32 bit patterns
_BASE_MASKS = [_i32((1 << (2 * n)) - 1) for n in range(17)]


def _markers(words: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """One marker bit (at even positions) per base equal to the char of
    `pattern`, in int32 arithmetic: the arithmetic right shift only ever
    feeds bit 31, which the 0x55555555 mask drops."""
    x = ~(words ^ pattern)
    return x & (x >> 1) & 0x55555555


def _popcount_even(y: torch.Tensor) -> torch.Tensor:
    """Bits set in int32 values whose set bits all sit at even positions."""
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    return (y + (y >> 16)) & 0x3F


def _patterns(device) -> torch.Tensor:
    return torch.tensor([_i32(k * 0x55555555) for k in range(4)],
                        dtype=torch.int32, device=device)


def word_counts(blocks: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """int16 [nblk, 33, 4]: occurrences of each char in the first w words
    (w = 0..32) of each block row, so a rank needs one partial word."""
    word_off = 8 if is_wide(blocks) else 4
    nblk = blocks.shape[0]
    out = torch.zeros((nblk, WORDS_PER_BLOCK + 1, 4), dtype=torch.int16,
                      device=blocks.device)
    pat = _patterns(blocks.device)
    for s in range(0, nblk, chunk):
        words = blocks[s: s + chunk, word_off:]
        for c in range(4):
            cnt = _popcount_even(_markers(words, pat[c]))
            out[s: s + chunk, 1:, c] = torch.cumsum(cnt, dim=1).to(
                torch.int16)
    return out


def rank_plain(blocks: torch.Tensor, zoff: int, rows: torch.Tensor,
               chars: torch.Tensor, counts: torch.Tensor = None
               ) -> torch.Tensor:
    """rank_c(row) for each (row, char): occurrences of c in bwt[0:row],
    '$' excluded. Returns int64. The block's occ checkpoint, plus the
    char's count in the block's full words before the row (`counts`,
    from word_counts; computed here when not given), plus the marker bits
    of the row's partial word."""
    word_off = 8 if is_wide(blocks) else 4
    if counts is None:
        counts = word_counts(blocks)
    r = rows.to(torch.int64)
    c = chars.to(torch.int64)
    blk = r >> 9
    w = (r & 511) >> 4
    word = blocks[blk, word_off + w]
    masks = torch.tensor(_BASE_MASKS, dtype=torch.int32, device=r.device)
    y = _markers(word, _patterns(r.device)[c]) & masks[r & 15]
    cnt = counts[blk, w, c].to(torch.int64) + _popcount_even(y)
    base = u32(blocks[blk, c])
    if word_off == 8:
        base = base | (u32(blocks[blk, c + 4]) << 32)
    adj = ((c == 0) & (r > zoff)).to(torch.int64)
    return base + cnt - adj


def bwt_at_plain(blocks: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """BWT code at each row ('$' reads as the code 0 it is stored as)."""
    word_off = 8 if is_wide(blocks) else 4
    r = rows.to(torch.int64)
    col = word_off + ((r & 511) >> 4)
    word = u32(blocks[r >> 9].gather(1, col[:, None])[:, 0])
    return (word >> (2 * (r & 15))) & 3


def level1_plain(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
                 t0: torch.Tensor, b0: torch.Tensor, counts=None):
    """(t1, b1) in the row dtype: t1[e + c * n] = LF(t0[e], c) and
    b1[e + c * n] = LF(b0[e], c) for the n ranges (t0, b0) and c = 0..3,
    where the range is non-empty (b0 > t0); 0 where it is empty, the
    guard of the JAX package's level 1 (fm_jax._ftab12_rows_graph)."""
    n = t0.shape[0]
    if counts is None:
        counts = word_counts(blocks)
    f = fchr.to(torch.int64)
    t1 = torch.zeros(4 * n, dtype=torch.int64, device=t0.device)
    b1 = torch.zeros_like(t1)
    par = torch.nonzero(b0 > t0)[:, 0]
    for c in range(4):
        ch = torch.full(par.shape, c, dtype=torch.int32, device=t0.device)
        t1[c * n + par] = f[c] + rank_plain(blocks, zoff, t0[par], ch, counts)
        b1[c * n + par] = f[c] + rank_plain(blocks, zoff, b0[par], ch, counts)
    return t1.to(t0.dtype), b1.to(b0.dtype)


def _check_kernel_args(blocks, fchr, rows, chars=None) -> None:
    """Device, types and shapes the kernels take; the block table 16-byte
    aligned (rows are read in 16-byte chunks); at most MAX_ITEMS items."""
    _cuda.require_cuda(blocks, fchr, rows, chars)
    want = torch.int64 if is_wide(blocks) else torch.int32
    if blocks.dtype != torch.int32 or blocks.dim() != 2:
        raise ValueError("blocks must be an int32 [nblk, 36|40] tensor")
    if rows.dtype != want or (fchr is not None and fchr.dtype != want):
        raise ValueError(f"rows and fchr must be {want} for this layout")
    if chars is not None and (chars.dtype != torch.int32
                              or chars.shape != rows.shape):
        raise ValueError("chars must be int32 with the shape of rows")
    if rows.numel() > _cuda.MAX_ITEMS:
        raise ValueError(f"at most {_cuda.MAX_ITEMS} items a launch")
    _cuda.require_aligned(blocks)


def rank(blocks: torch.Tensor, zoff: int, rows: torch.Tensor,
         chars: torch.Tensor, fchr: torch.Tensor = None) -> torch.Tensor:
    """rank_c(row) (or LF(row, c) = fchr[c] + rank_c(row) when fchr is
    given; chars 0..3) in the row dtype: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    tensors = (blocks, fchr, rows, chars)
    if not any(t is not None and t.is_cuda for t in tensors):
        out = rank_plain(blocks, zoff, rows, chars)
        if fchr is not None:
            out = fchr.to(torch.int64)[chars.to(torch.int64)] + out
        return out.to(rows.dtype)
    _check_kernel_args(blocks, fchr, rows, chars)
    out = torch.empty_like(rows)
    lib = _cuda.lib("rank")
    fn = lib.fm_rank_wide if is_wide(blocks) else lib.fm_rank_narrow
    rc = fn(blocks.data_ptr(), None if fchr is None else fchr.data_ptr(),
            int(zoff), rows.data_ptr(), chars.data_ptr(), out.data_ptr(),
            rows.numel(), _cuda.stream_ptr(rows.device))
    _cuda.check(rc, "rank kernel")
    _cuda.LAUNCHES["rank"] += 1
    return out


def lf(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
       rows: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """LF(row, c) = fchr[c] + rank_c(row)."""
    return rank(blocks, zoff, rows, chars, fchr=fchr)


def level1(blocks: torch.Tensor, fchr: torch.Tensor, zoff: int,
           t0: torch.Tensor, b0: torch.Tensor):
    """(t1, b1) of level1_plain: on CUDA tensors one launch of the
    level-1 kernel (a tile of threads a range, both ends' rows scanned
    once for every code), on CPU tensors the plain version."""
    if not any(t.is_cuda for t in (blocks, fchr, t0, b0)):
        return level1_plain(blocks, fchr, zoff, t0, b0)
    _check_kernel_args(blocks, fchr, t0)
    if b0.dtype != t0.dtype or b0.shape != t0.shape or t0.dim() != 1:
        raise ValueError("t0 and b0 must be 1-D of one shape and dtype")
    _cuda.require_cuda(b0)
    n = t0.numel()
    t1 = torch.empty(4 * n, dtype=t0.dtype, device=t0.device)
    b1 = torch.empty_like(t1)
    lib = _cuda.lib("rank")
    fn = lib.fm_lf_level1_wide if is_wide(blocks) \
        else lib.fm_lf_level1_narrow
    rc = fn(blocks.data_ptr(), fchr.data_ptr(), int(zoff), t0.data_ptr(),
            b0.data_ptr(), t1.data_ptr(), b1.data_ptr(), n,
            _cuda.stream_ptr(t0.device))
    _cuda.check(rc, "level-1 kernel")
    _cuda.LAUNCHES["rank"] += 1
    return t1, b1
