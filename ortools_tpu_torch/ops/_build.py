"""Build and bind the CUDA kernels of ``ops/csrc``.

``nvcc`` compiles each source of ``csrc`` (``block_spmv.cu``: the block-row
SpMV kernels and the row SpMV; ``block_spmm.cu``: the batched block-row
SpMM and the batched row SpMM) for ``sm_90a`` into a shared library with
a plain C interface under ``build/kernels/`` at the root of the checkout,
at first use; each library is loaded with ctypes.  ``build`` starts one ``nvcc`` per source, all at
once.  A file name carries a hash of its source and the flags, so an edited
source is rebuilt and concurrent builds never see a half-written library
(each writes a private file and renames it into place).  ``load`` is the
same scheme for one library and any compiler command; the native C++ core
(``_native/build.py``) is built and loaded through it.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"block_spmv": CSRC / "block_spmv.cu",
           "block_spmm": CSRC / "block_spmm.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P, _I = ctypes.c_void_p, ctypes.c_int
# schedule, block_cols, data, x, y; num_block_rows, num_long, bm, bn,
# device; stream
_BLOCK_SPMV = [_P] * 5 + [_I] * 5 + [_P]
# order, row_ptr, cols, values, x, y, bin_rows (host); num_rows, device;
# stream
_ROWS_SPMV = [_P] * 7 + [_I] * 2 + [_P]
# items, row_ptr, block_cols, data, x, y; num_items, num_block_rows, bm,
# bn, batch, n, m, device; stream
_BLOCK_SPMM = [_P] * 6 + [_I] * 8 + [_P]
# order, row_ptr, cols, values, x, xt (scratch), y, bin_rows (host);
# num_rows, batch, n, device; stream
_ROWS_SPMM = [_P] * 8 + [_I] * 4 + [_P]
# Each library's functions and their argument types.
_FUNCTIONS = {
    "block_spmv": {"block_spmv_exact_f32": _BLOCK_SPMV,
                   "block_spmv_exact_f64": _BLOCK_SPMV,
                   "block_spmv_fast_bf16": _BLOCK_SPMV,
                   "block_spmv_rows_f32": _ROWS_SPMV,
                   "block_spmv_rows_f64": _ROWS_SPMV},
    "block_spmm": {"block_spmm_exact_f32": _BLOCK_SPMM,
                   "block_spmm_exact_f64": _BLOCK_SPMM,
                   "block_spmm_rows_f32": _ROWS_SPMM,
                   "block_spmm_rows_f64": _ROWS_SPMM},
}

_libs: dict = {}
_loaded: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(compiler: list, src: Path, so: Path):
    """Start ``compiler`` (the command and its flags) on ``src``, writing a
    private file beside ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return so, tmp, cmd, proc


def _finish(job) -> str:
    """Wait for a ``_start``ed compile; rename its library and the
    compiler's report (``.log``) into place and return the report."""
    so, tmp, cmd, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):"
                           f" {' '.join(cmd)}\n{out}\n{err}")
    log = so.with_suffix(".log")
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(out + err)
    os.replace(tmp, so)
    os.replace(tmp_log, log)
    return out + err


def build(names=tuple(SOURCES)) -> str:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together; returns the compiler's reports (``-Xptxas -v``:
    registers, shared memory and spills of every kernel), kept beside each
    library."""
    compiler = [nvcc_path(), *NVCC_FLAGS]
    running = [_start(compiler, SOURCES[name], so) for name in names
               for so in (_library_path(name),)
               if not (so.exists() and so.with_suffix(".log").exists())]
    failures = []
    for job in running:
        try:
            _finish(job)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return "".join(_library_path(name).with_suffix(".log").read_text()
                   for name in names)


def load(compiler: list, src: Path, so: Path) -> ctypes.CDLL:
    """The library ``so`` built from ``src`` by ``compiler``, compiled first
    where it is missing and loaded once per process."""
    with _LOCK:
        if so not in _loaded:
            if not so.exists():
                _finish(_start(compiler, src, so))
            _loaded[so] = ctypes.CDLL(str(so))
        return _loaded[so]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of ``SOURCES``), built
    first if needed."""
    if name not in _libs:
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        for fname, argtypes in _FUNCTIONS[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
