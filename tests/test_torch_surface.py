"""The port's public surface covers the JAX package's.

- Every ``.py`` file under ``ortools_tpu/`` has a counterpart under
  ``ortools_tpu_torch/`` at the same relative path (``__graft_entry__.py``
  at the repo's root is the port's ``graft_entry.py``; it is not in the
  package).
- Every top-level public name that a JAX module defines or re-exports is
  defined or re-exported by its counterpart.  Both sides are read with
  ``ast``, nothing is imported.  A name is public when it does not start
  with ``_`` (``__version__`` and ``__all__`` count); a re-export is a
  name imported from the package itself in an ``__init__.py``, or on an
  import line marked ``# noqa: F401`` (an import that a module keeps for
  its importers, not for itself).

The exceptions are the TPU-only names below, each with its reason.  No
Pallas kernel is among them: both of the package's kernels are ported
(``ops/csrc/block_spmv.cu``).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "ortools_tpu"
PORT_PKG = ROOT / "ortools_tpu_torch"

# name: (the JAX module that defines it, why the port has no counterpart).
# A name is exempt in every module that defines or re-exports it
# (ops/block_sparse.py imports TiledSpmv).
TPU_ONLY = {
    # double-f32 error-free transforms: the port's df32.py accumulates in
    # float64 under the same entry names
    "two_sum": ("ops/df32.py", "f64 is native on the H100"),
    "two_prod": ("ops/df32.py", "f64 is native on the H100"),
    "sum2": ("ops/df32.py", "f64 is native on the H100"),
    "dot2": ("ops/df32.py", "f64 is native on the H100"),
    # the TPU super-tile layout (one-hot MXU gather/scatter, bf16x3
    # splitting): the H100 kernels run over a block-row CSR index instead
    "TiledSpmv": ("ops/tiled_spmv.py", "the TPU layout is not ported"),
    "pack_tiled": ("ops/tiled_spmv.py", "the TPU layout is not ported"),
    "dp_knapsack_jax": ("algorithms/knapsack.py",
                        "its counterpart is dp_knapsack_torch"),
}

JAX_FILES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _reexport(node: ast.ImportFrom, path: Path, lines: list) -> bool:
    in_package = node.level > 0 or (node.module or "").split(".")[0] in (
        "ortools_tpu", "ortools_tpu_torch")
    marked = any("noqa: F401" in ln
                 for ln in lines[node.lineno - 1:node.end_lineno])
    return in_package and (path.name == "__init__.py" or marked)


def public_names(path: Path, *, every_import: bool) -> set:
    """The names that the module at ``path`` binds at its top level (and in
    top-level ``if``/``try`` blocks) and that do not start with ``_``, apart
    from ``__version__`` and ``__all__``.  Imports count when they come from
    the package as re-exports, or all of them with ``every_import``."""
    text = path.read_text()
    lines = text.splitlines()
    names = set()
    stack = list(ast.parse(text, filename=str(path)).body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and (
                every_import or _reexport(node, path, lines)):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import) and every_import:
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.If):
            stack.extend(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            stack.extend(node.body + node.orelse + node.finalbody
                         + [s for h in node.handlers for s in h.body])
    return {n for n in names
            if not n.startswith("_") or n in ("__version__", "__all__")}


def test_every_jax_module_has_a_counterpart():
    missing = [rel for rel in JAX_FILES if not (PORT_PKG / rel).exists()]
    assert not missing, missing


@pytest.mark.parametrize("rel", JAX_FILES)
def test_public_names_have_counterparts(rel):
    want = public_names(JAX_PKG / rel, every_import=False)
    have = public_names(PORT_PKG / rel, every_import=True)
    missing = sorted(n for n in want - have if n not in TPU_ONLY)
    assert not missing, f"{rel}: the port lacks {missing}"


def test_exceptions_are_missing_and_name_no_kernel():
    """Each exception is defined by its JAX module and missing from the
    port's; none is a function that reaches ``pallas_call``."""
    for name, (rel, reason) in TPU_ONLY.items():
        assert reason
        tree = ast.parse((JAX_PKG / rel).read_text())
        defs = [node for node in tree.body
                if getattr(node, "name", None) == name]
        assert defs, (rel, name)
        assert "pallas_call" not in ast.unparse(defs[0]), name
        assert name not in public_names(PORT_PKG / rel, every_import=True)


# ---------------------------------------------------------------------------
# The helpers that the surface check brought in
# ---------------------------------------------------------------------------


def test_native_build_error_on_a_missing_source_and_a_failed_compile(
        tmp_path, monkeypatch):
    from ortools_tpu_torch._native import build

    assert issubclass(build.NativeBuildError, RuntimeError)
    with pytest.raises(build.NativeBuildError, match="no native source"):
        build.load_library("no_such_core")
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "_SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "OUT_DIR", tmp_path / "out")
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ failed"):
        build.load_library("broken")


def test_params_cache_key_matches_the_jax_package():
    import torch
    from ortools_tpu.pdlp.params import PdhgParams as JParams
    from ortools_tpu.pdlp.solver import params_cache_key as jkey
    from ortools_tpu_torch.pdlp.params import PdhgParams
    from ortools_tpu_torch.pdlp.solver import params_cache_key

    kw = dict(iteration_limit=77, eps_optimal_relative=1e-5)
    key = params_cache_key(PdhgParams(**kw))
    assert hash(key) == hash(params_cache_key(PdhgParams(**kw)))
    assert key != params_cache_key(PdhgParams(iteration_limit=78))
    # the fields both packages' params have agree (enums by name), the
    # dtype's type aside
    tk, jk = dict(key), dict(jkey(JParams(**kw)))
    common = (set(tk) & set(jk)) - {"dtype"}
    assert len(common) > 20
    plain = lambda v: getattr(v, "name", v)  # noqa: E731
    assert {n: plain(tk[n]) for n in common} == {n: plain(jk[n])
                                                 for n in common}
    assert tk["dtype"] is torch.float32
