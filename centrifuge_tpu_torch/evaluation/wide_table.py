"""A synthetic wide table (the wide layout past 2^31 rows) and reads that
occur in it, generated on the device from a seed in seconds, where the
2.2 Gbp database of evaluation/widebench.py takes tens of minutes to
build. chip_smoke's wide_scale phase holds every kernel to its plain
version on it.
"""

from __future__ import annotations

import numpy as np
import torch

# chip_smoke's table: past 2^31 rows by 2^20 + 7, so the last block is
# partial
WIDE_SCALE_LEN = (1 << 31) + (1 << 20) + 7
NPAT = 550             # sequences the samples and boundary refs point at
N_BOUNDARY = 16        # boundary rows, half of them among the last 2^20
OFFRATE = 4            # one SA sample every 2^OFFRATE rows
CHUNK = 1 << 20        # block rows generated and counted at a time


def random_wide_index(bwt_len: int, seed: int, device):
    """A DeviceFMIndex of `bwt_len` rows in the wide layout, made on
    `device` from `seed`, legal for LF mapping: random 2-bit BWT words
    (the bases past bwt_len zero, as pack_bwt_blocks pads); the '$' row
    (zoff, code 0) among the last 2^20 rows; the occ checkpoints counted
    from the words with the plain word counts (ops/rank.py word_counts,
    '$' counted as the code 0 it is stored as); fchr from the totals
    (fchr[4] = bwt_len - 1: the '$' suffix is the last row); the depth-10
    ftab from the plain backward search of all 2^20 10-mers (first char
    in the high bits, fm_numpy.FMOracle.ftab_lookup); random int32 SA
    samples (sequence indexes below NPAT) at OFFRATE; N_BOUNDARY sorted
    boundary rows, half of them, and zoff, among the last 2^20 rows, with
    random refs. No depth-12 ftab (ftab12_rows None)."""
    from ..ops.fm_torch import (DeviceFMIndex, N10, _lo32, pack_ftab_rows,
                                resolve_device)
    from ..ops.rank import _i32, rank_plain, word_counts
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    nblk = bwt_len // 512 + 1
    blocks = torch.zeros((nblk, 40), dtype=torch.int32, device=dev)
    for s in range(0, nblk, CHUNK):
        e = min(nblk, s + CHUNK)
        blocks[s:e, 8:] = _lo32(torch.randint(
            0, 1 << 32, (e - s, 32), generator=gen, device=dev,
            dtype=torch.int64))
    # the bases past bwt_len are code 0; '$' at zoff is stored as code 0
    local = bwt_len - 512 * (nblk - 1)
    w, part = 8 + (local >> 4), local & 15
    blocks[-1, w + 1:] = 0
    blocks[-1, w] &= _i32((1 << (2 * part)) - 1)
    tail = min(1 << 20, bwt_len - 2)
    zoff = int(bwt_len - 1 - rng.integers(1, tail + 1))
    blocks[zoff >> 9, 8 + ((zoff & 511) >> 4)] &= _i32(
        ~(3 << (2 * (zoff & 15))) & 0xFFFFFFFF)
    # occ: per-block counts of each code, summed before each block
    cnt = torch.cat([word_counts(blocks[s: s + CHUNK])[:, 32, :]
                     for s in range(0, nblk, CHUNK)]).to(torch.int64)
    occ = torch.cumsum(cnt, 0) - cnt
    blocks[:, :4] = _lo32(occ)
    blocks[:, 4:8] = _lo32(occ >> 32)
    tot = cnt.sum(0)
    tot[0] -= 512 * nblk - bwt_len + 1      # the padding and '$'
    fchr = torch.zeros(5, dtype=torch.int64, device=dev)
    fchr[1:] = torch.cumsum(tot, 0)
    del cnt, occ
    # the depth-10 ftab: backward search of every 10-mer, last char first
    counts = word_counts(blocks)
    fi = torch.arange(N10, dtype=torch.int64, device=dev)
    c = fi & 3
    top, bot = fchr[c], fchr[c + 1]
    for i in range(1, 10):
        c = (fi >> (2 * i)) & 3
        top = fchr[c] + rank_plain(blocks, zoff, top, c, counts)
        bot = fchr[c] + rank_plain(blocks, zoff, bot, c, counts)
    del counts
    n_samples = -(-bwt_len >> OFFRATE)
    n8 = -(-n_samples // 8) * 8
    offs = torch.randint(0, NPAT, (n8,), generator=gen, device=dev,
                         dtype=torch.int32)
    offs[n_samples:] = 0
    half = N_BOUNDARY // 2
    brows = np.unique(np.concatenate([
        rng.integers(1, min(bwt_len - 1, 1 << 31), half),
        rng.integers(bwt_len - 1 - tail, bwt_len - 1, N_BOUNDARY - half - 1),
        [zoff]]))
    brefs = rng.integers(0, NPAT, brows.shape[0]).astype(np.int32)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ftab = pack_ftab_rows(top.cpu().numpy(), bot.cpu().numpy(), True, 40)
    return DeviceFMIndex(
        blocks=blocks, ftab_rows=put(ftab.view(np.int32)), ftab12_rows=None,
        fchr=fchr, ftab_top=top, ftab_bot=bot,
        offs=offs.reshape(-1, 8), boundary_rows=put(brows.astype(np.int64)),
        boundary_refs=put(brefs), zoff=zoff, bwt_len=bwt_len, ftab_chars=10,
        offrate=OFFRATE, npat=NPAT, wide=True)


def walk_reads(fm, n: int, length: int, seed: int,
               subst: float = 0.5) -> np.ndarray:
    """uint8 codes [m, length] of reads that occur in the table: from n
    random rows, `length` LF steps back (each the char before the row's
    suffix, read with the plain bwt_at and rank), so read i is the text
    before its row's suffix. A walk that reaches the '$' row has reached
    the text's start: its read is dropped (m <= n). Then a random
    fraction `subst` of the reads get one substitution each, at a random
    place."""
    from ..ops.rank import bwt_at_plain, rank_plain, word_counts
    dev = fm.blocks.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, fm.bwt_len, (n,), generator=gen, device=dev,
                         dtype=torch.int64)
    counts = word_counts(fm.blocks)
    out = torch.empty((n, length), dtype=torch.int64, device=dev)
    start = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(length - 1, -1, -1):
        start |= rows == fm.zoff
        c = bwt_at_plain(fm.blocks, rows)
        out[:, j] = c
        rows = fm.fchr[c] + rank_plain(fm.blocks, fm.zoff, rows, c, counts)
    hit = torch.rand(n, generator=gen, device=dev) < subst
    pos = torch.randint(0, length, (n,), generator=gen, device=dev)
    shift = torch.randint(1, 4, (n,), generator=gen, device=dev)
    lanes = torch.nonzero(hit)[:, 0]
    out[lanes, pos[lanes]] = (out[lanes, pos[lanes]] + shift[lanes]) & 3
    return out[~start].to(torch.uint8).cpu().numpy()
