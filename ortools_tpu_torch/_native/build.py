"""Build and load the port's native C++ cores (``smalllp.cc``,
``cdcl.cc``, ``lcg.cc``, ``pbsat.cc`` and ``graph.cc``, byte copies of
the JAX package's ``_native`` sources).

The source is compiled on demand with g++ (``-O2 -std=c++17 -shared
-fPIC``) into a shared library consumed through ctypes, by the kernels'
build scheme (``ops/_build.py::load``).  The library goes to
``build/native/`` at the root of the checkout, never beside the source,
keyed by a hash of the source so that an edit triggers a rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path

from ortools_tpu_torch.ops import _build

_SRC_DIR = Path(__file__).resolve().parent
OUT_DIR = _SRC_DIR.parents[1] / "build" / "native"
GXX = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """A native core that has no source or that g++ could not compile."""


def library_path(name: str) -> Path:
    """Where the library built from ``<name>.cc``'s present text goes."""
    src = _SRC_DIR / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return OUT_DIR / f"lib_otpu_torch_{name}_{digest}.so"


def load_library(name: str = "smalllp") -> ctypes.CDLL:
    """Compile (if needed) and dlopen the named native module."""
    src = _SRC_DIR / f"{name}.cc"
    if not src.exists():
        raise NativeBuildError(f"no native source {src}")
    try:
        return _build.load(list(GXX), src, library_path(name))
    except RuntimeError as e:  # g++ failed
        raise NativeBuildError(str(e)) from e
