"""Build and load the port's CUDA kernels.

At first use, every ``combblas_tpu_torch/csrc/*.cu`` is compiled with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and the objects are linked into one shared library with a
plain C interface, placed in ``combblas_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed on a hash of the sources and flags, and
loaded with ``ctypes``.  Pointers and the stream are passed as ``c_void_p``
and sizes as ``c_int64``; every entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import: the CPU test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
#: C signature of every entry point (all return an int cudaError_t).
_SIGNATURES = {
    # a_row, a_val, offs, n_a, bstart, b_col, b_val, stride, mul_code,
    # splits (int64 scratch, one per tile and one more), out_key, out_val,
    # cap, stream
    "cbt_expand_i32": [_P, _P, _P, _I64, _P, _P, _P, _I64, _I32, _P, _P, _P,
                       _I64, _P],
    "cbt_expand_i64": [_P, _P, _P, _I64, _P, _P, _P, _I64, _I32, _P, _P, _P,
                       _I64, _P],
    # a_col, a_valid, n_a, b_rp, offs (int64[n_a + 1]: 0, then counts),
    # bstart (int64[n_a]: each entry's B row start), stream
    "cbt_expand_counts": [_P, _P, _I64, _P, _P, _P, _P],
    # a_col, a_valid, n_a, b_rp, ch_offs (int64[n_a + 1]: 0, then 128-slot
    # chunk counts), bstart, blen (int64[n_a]: each entry's products), stream
    "cbt_expand_chunk_counts": [_P, _P, _I64, _P, _P, _P, _P, _P],
    # a_row, a_val, ch_offs, n_a, bstart, blen, b_col, b_val, stride,
    # mul_code, splits (int64 scratch, one per tile and one more), out_key,
    # out_val, cap (in chunks), stream
    "cbt_expand_chunks_i32": [_P, _P, _P, _I64, _P, _P, _P, _P, _I64, _I32,
                              _P, _P, _P, _I64, _P],
    # key, val, n, add_code, out_key, out_val, cap, state (int64 zeros:
    # tile counter, nnz, one status word per tile), stream
    "cbt_compress_i32": [_P, _P, _I64, _I32, _P, _P, _I64, _P, _P],
    "cbt_compress_i64": [_P, _P, _I64, _I32, _P, _P, _I64, _P, _P],
    # cols, vals, run_start, run_len, pieces, n_pieces, folds, n_folds, nb,
    # bs_c, x, d, op, part, y, stream
    "cbt_ell_fold": [_P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _I64, _P,
                     _I64, _I32, _P, _P, _P],
    # row_ptr, col, val, m, ranges, piece_len, x, d, part, y, stream
    "cbt_spmm_coo": [_P, _P, _P, _I64, _I64, _I64, _P, _I64, _P, _P, _P],
    # table (host int64[7 * n]: src, dst, dst_wrap, words, outer, ring,
    # inner), n, stream
    "cbt_ring_shift": [_P, _I32, _P],
    # device, bytes, ptr_out (void**), handle_out; device, handle, ptr_out;
    # device, ptr; device, ptr; dst, src, bytes, stream (csrc/ipc.cu)
    "cbt_ipc_alloc": [_I32, _I64, _P, _P],
    "cbt_ipc_open": [_I32, _P, _P],
    "cbt_ipc_close": [_I32, _P],
    "cbt_ipc_free": [_I32, _P],
    "cbt_copy": [_P, _P, _I64, _P],
    # col, val, start, len, dest, width (each offset to the first window),
    # windows, cap, bits, out_key, out_val, stream (csrc/winsort.cu)
    "cbt_winsort_narrow": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _P, _P,
                           _P],
    # col, val, start, len, dest, width, windows, bits, scratch_key,
    # scratch_val, tile_cum, tail_cum, tile_win, tail_win, max_tiles,
    # max_chunks, hist, state (zeroed), max_scan_tiles, out_key, out_val,
    # stream
    "cbt_winsort_wide": [_P, _P, _P, _P, _P, _P, _I64, _I32, _P, _P, _P, _P,
                         _P, _P, _I64, _I64, _P, _P, _I64, _P, _P, _P],
    # key, key64, val, bounds, n_rows, stream_len, stride, bits, narrow
    # bounds (3), max_wide, max_tiles, max_scan_tiles, zeroed, rows (int32
    # lists), tile_win, hist, cums, scratch_k, scratch_v, stream
    "cbt_winsort_rows": [_P, _I32, _P, _P, _I64, _I64, _I64, _I32, _I64,
                         _I64, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P,
                         _P, _P],
}

_lib = None
#: Seconds the last nvcc run took in this process (None: loaded a cached
#: build, or nothing built yet).
build_seconds: float | None = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source with the CUDA toolkit")
    return path


def _compile_and_link(so: Path) -> None:
    """nvcc every source to an object in parallel, then link ``so``; the
    commands and compiler output go to ``build.log``."""
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:  # wait for every job, failed or not
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = so.with_name(f"{tag}.so.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(obj) for _c, obj, _p in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libcombblas_torch_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile_and_link(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cbt_error_string.argtypes = [ctypes.c_int]
    lib.cbt_error_string.restype = ctypes.c_char_p
    lib.cbt_ipc_handle_bytes.argtypes = []
    lib.cbt_ipc_handle_bytes.restype = ctypes.c_int64
    # the wrappers size their scratch by the kernels' tiles (imported here:
    # the wrapper modules import this one)
    from combblas_tpu_torch.ops.kernels.compress import COMPRESS_TILE
    from combblas_tpu_torch.ops.kernels.expand import (EXPAND_CHUNKS_TILE,
                                                       EXPAND_TILE)
    from combblas_tpu_torch.ops.kernels.winsort import (NARROW_MAX,
                                                        SCAN_TILE,
                                                        TAIL_CHUNK,
                                                        WINSORT_TILE)
    for name, tile in (("cbt_expand_tile", EXPAND_TILE),
                       ("cbt_expand_chunks_tile", EXPAND_CHUNKS_TILE),
                       ("cbt_compress_tile", COMPRESS_TILE),
                       ("cbt_winsort_tile", WINSORT_TILE),
                       ("cbt_winsort_tail_chunk", TAIL_CHUNK),
                       ("cbt_winsort_scan_tile", SCAN_TILE),
                       ("cbt_winsort_narrow_max", NARROW_MAX)):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int64
        if fn() != tile:
            raise RuntimeError(f"{name}() = {fn()}, the wrapper's tile {tile}")
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.cbt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
