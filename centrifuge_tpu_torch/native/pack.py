"""ctypes wrapper for the fused native read packer (pack.cpp).

Returns transport-packed lane matrices directly from the raw read code
arrays; ``None`` when the native library is unavailable (callers fall
back to the numpy pack+transport pair)."""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_LIB_FAILED = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _load():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        from .compile import build_native
        lib = C.CDLL(build_native(os.path.join(_HERE, "pack.cpp"),
                                  extra_flags=("-pthread",)))
        lib.cf_pack_reads.argtypes = [
            _u8p, _i64p, _i32p, C.c_int64, C.c_int64, _u8p, C.c_int64,
            C.c_int32]
        lib.cf_pack_reads2.argtypes = [
            _u8p, _i64p, _i32p, C.c_int64, C.c_int64, _u8p, C.c_int64,
            C.c_int32, _i32p]
        _LIB = lib
    except Exception as e:
        from ..utils.fallback import warn_fallback
        warn_fallback("pack.cpp (read packer)", e)
        _LIB_FAILED = True
        _LIB = None
    return _LIB


def pack_reads(seqs, lens: np.ndarray, nlanes: int, row_bytes: int,
               nthreads: int = 0, out: np.ndarray = None):
    """seqs: list of uint8 code arrays -> (nlanes, row_bytes) uint8
    transport-packed matrix, or None if the native lib is unavailable.
    With `out` (a C-contiguous uint8 (nlanes, row_bytes) array) the
    matrix is written there, every byte of every row, padding lanes
    included, and `out` is returned."""
    lib = _load()
    if lib is None:
        return None
    if out is None:
        out = np.empty((nlanes, row_bytes), np.uint8)
    elif out.dtype != np.uint8 or out.shape != (nlanes, row_bytes) \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 ({nlanes}, "
                         f"{row_bytes}) array")
    if len(seqs):
        allseq = np.ascontiguousarray(np.concatenate(seqs), np.uint8)
    else:
        allseq = np.zeros(1, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    starts = np.cumsum(lens, dtype=np.int64) - lens
    if not nthreads:
        nthreads = min(8, os.cpu_count() or 1)
    lib.cf_pack_reads(allseq, starts, lens, len(seqs), row_bytes, out,
                      nlanes, nthreads)
    return out


def pack_reads2(seqs, lens: np.ndarray, nlanes: int, row_bytes: int,
                nthreads: int = 0):
    """2-bit (4 codes/byte) transport pack for N-free batches.

    Returns (matrix, has_n); has_n=True means a code > 3 was seen and the
    matrix is NOT valid -- the caller falls back to the 4-bit packing.
    None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if len(seqs):
        allseq = np.ascontiguousarray(np.concatenate(seqs), np.uint8)
    else:
        allseq = np.zeros(1, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    starts = np.cumsum(lens, dtype=np.int64) - lens
    out = np.empty((nlanes, row_bytes), np.uint8)
    if not nthreads:
        nthreads = min(8, os.cpu_count() or 1)
    flags = np.zeros(max(nthreads, 1), np.int32)
    lib.cf_pack_reads2(allseq, starts, lens, len(seqs), row_bytes, out,
                       nlanes, nthreads, flags)
    return out, bool(flags[0])
