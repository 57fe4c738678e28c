"""CUDA kernel loader: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` is compiled on first use for ``sm_90a`` (all
sources at once, one nvcc process each) into ``csrc/_build/``, under a
name that hashes the source and the shared header, so an edit rebuilds
and an unchanged tree reuses the library. The C entry points take
device pointers and the CUDA stream as ``c_void_p`` and return
``cudaGetLastError()``; ``check`` raises on anything but 0.

``LAUNCHES`` counts the launches of each kernel (a wrapper adds one
where it launches, nowhere else), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import re
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
HEADER = "fm_common.cuh"

_P, _I64, _I32 = C.c_void_p, C.c_int64, C.c_int32
_RANK = [_P, _P, _I64, _P, _P, _P, _I64, _P]
_LEVEL1 = [_P, _P, _I64, _P, _P, _P, _P, _I64, _P]
_SEARCH = [_P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P,
           _I64, _I32, _I32, _I32, _I32, _I32, _P, _P]
_SEARCH_POOL = [_P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P, _I64, _I64, _I32,
                _I32, _I32, _I32, _P, _P]
_FTAB12 = [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _P]
_RESOLVE = [_P, _P, _I64, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P, _P,
            _I64, _P, _P]
_CONFIG = [_I32, _I64, _P]
_PRESOLVE = [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _I64, _P,
             _P]
_SH_SEARCH = [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
              _I32, _I32, _P]
_SH_RESOLVE = [_P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _I64, _P]
SIGNATURES = {
    "rank": {"fm_rank_narrow": _RANK, "fm_rank_wide": _RANK,
             "fm_lf_level1_narrow": _LEVEL1, "fm_lf_level1_wide": _LEVEL1,
             "fm_rank_config": _CONFIG, "fm_lf_level1_config": _CONFIG},
    "search": {"fm_search_narrow": _SEARCH, "fm_search_wide": _SEARCH,
               "fm_search_pool": _SEARCH_POOL, "fm_search_config": _CONFIG},
    "ftab12": {"fm_ftab12_narrow": _FTAB12, "fm_ftab12_wide": _FTAB12,
               "fm_ftab12_config": _CONFIG},
    "resolve": {"fm_resolve_narrow": _RESOLVE, "fm_resolve_wide": _RESOLVE,
                "fm_resolve_config": _CONFIG},
    "presolve": {"fm_presolve_narrow": _PRESOLVE,
                 "fm_presolve_wide": _PRESOLVE},
    "sharded": {**{f"fm_shard_{fn}_{kind}": sig
                   for fn, sig in (("search", _SH_SEARCH),
                                   ("resolve", _SH_RESOLVE))
                   for kind in ("narrow", "wide")},
                "fm_shard_enable_peer": [_I32, _I32]},
}

# one count per kernel of the port; csrc/rank.cu's two entries (K0's
# rank and its level 1) count as "rank"; csrc/sharded.cu holds two, K6's
# search and its resolve walk (one launch per dp row each)
KERNELS = ("rank", "search", "ftab12", "resolve", "presolve",
           "sharded_search", "sharded_resolve")
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in (f"{name}.cu", HEADER):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}.{h.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Compile every kernel source whose library is missing, all nvcc
    processes started together. Returns name -> compiler log (ptxas
    register and spill report) for the sources built now."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [(n, library_path(n)) for n in SIGNATURES
            if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, so, tmp, p in procs:
        logs[name] = p.communicate()[0].decode(errors="replace")
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(logs[name])
        if p.returncode:
            failed.append(f"{name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def ptxas_report(log: str) -> list:
    """Each kernel's registers and spill from an nvcc -Xptxas=-v log, as
    "<kernel> narrow|wide: ..." lines (the row type of its template: i
    narrow, l wide)."""
    out, entry = [], ""
    for ln in log.splitlines():
        k = re.search(r"([a-z_]+\d*_kernel)I([il])E", ln)
        if "entry function" in ln and k:
            entry = f"{k.group(1)} {'narrow' if k.group(2) == 'i' else 'wide'}"
        elif "registers" in ln or "spill" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return out


def lib(name: str):
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            build_all()
            dll = C.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = C.c_int
            _LIBS[name] = dll
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


# K1, K3 and K4 (csrc/search.cu, csrc/resolve.cu, csrc/ftab12.cu) take
# their lanes, rows or level-1 ranges from an int32 work counter; K0
# (csrc/rank.cu) takes as many items a launch
MAX_ITEMS = 1 << 30
CONFIG_KEYS = ("tile", "threads", "grid", "registers", "resident_blocks")


def persistent_config(kernel: str, wide: bool, n: int,
                      entry: str = None) -> dict:
    """The launch shape of K1 ("search"), K3 ("resolve"), K4 ("ftab12",
    whose n is fixed: the 2^22 level-1 ranges) or K0 ("rank"; entry
    "lf_level1" for its level 1) for n lanes, rows, ranges or queries on
    the current card: threads per item (the tile), threads per block,
    the grid, registers per thread (ptxas's count) and the resident grid
    it is capped at."""
    out = (C.c_int32 * len(CONFIG_KEYS))()
    name = entry or kernel
    check(getattr(lib(kernel), f"fm_{name}_config")(int(wide), n, out),
          f"{name} config")
    return dict(zip(CONFIG_KEYS, out))


def work_counter(device):
    """The zeroed int32 counters of a persistent kernel: [0] the one it
    takes its items from, [1] K1's hit-pool counter in pool mode (one
    fill for both)."""
    import torch
    return torch.zeros(2, dtype=torch.int32, device=device)


def require_aligned(*tensors) -> None:
    """The row scans read the block and ftab tables in 16-byte chunks."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel tables must be 16-byte aligned (a "
                             "sliced view is not)")


def require_cuda(*tensors) -> None:
    """Wrappers launch their kernel for CUDA tensors: raise on a mix."""
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError("kernel inputs must all lie on the same CUDA "
                             "device")
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
