"""Build and bind the CUDA kernels of ``ops/csrc``.

``nvcc`` compiles ``csrc/block_spmv.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, at first use; the library is loaded with ctypes.  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and concurrent builds never see a half-written library (each
writes a private file and renames it into place).

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_spmv.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_FUNCTIONS = ("block_spmv_exact_f32", "block_spmv_exact_f64",
              "block_spmv_fast_bf16")

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libblock_spmv_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels unless this source is built already; returns
    the compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of every kernel), kept beside the library."""
    so = _library_path()
    log = so.with_suffix(".log")
    if so.exists() and log.exists():
        return log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(report)
    os.replace(tmp, so)
    os.replace(tmp_log, log)
    return report


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_library_path()))
        for name in _FUNCTIONS:
            fn = getattr(lib, name)
            # schedule, block_cols, data, x, y; num_block_rows, num_long,
            # bm, bn, device; stream
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
