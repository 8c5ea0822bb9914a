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


# ---------------------------------------------------------------------------
# The scripts around the package
# ---------------------------------------------------------------------------

# Every script of the repo (at the root or under scripts/) that imports JAX
# or the JAX package, with its counterparts in the port: (path, the functions it
# defines or the options it takes that do the script's work).  The four
# development probes are covered by tools that already do their work.
SCRIPT_COUNTERPARTS = {
    "__graft_entry__.py": [("ortools_tpu_torch/graft_entry.py",
                            ("entry", "dryrun_multichip"))],
    "bench.py": [("bench_torch.py", ("main",))],
    "bench_large.py": [("bench_large_torch.py", ("main",))],
    "bench_miplib.py": [("bench_miplib_torch.py", ("main",))],
    "scripts/bench_roofline.py": [("scripts/bench_roofline_torch.py",
                                   ("main", "fit"))],
    "scripts/bench_lp_suite_batch.py": [(
        "scripts/bench_lp_suite_batch_torch.py",
        ("main", "build_suite", "verify"))],
    "scripts/bench_onchip_search.py": [(
        "scripts/bench_onchip_search_torch.py",
        ("main", "bench_node_lps", "bench_device_fj"))],
    "scripts/bench_multichip_large.py": [(
        "scripts/bench_multichip_large_torch.py", ("main", "census"))],
    "scripts/bench_inprocessing.py": [("scripts/bench_inprocessing_torch.py",
                                       ("main", "php", "rand3sat"))],
    "scripts/bench_opb.py": [("scripts/bench_opb_torch.py",
                              ("main", "php_opb", "run"))],
    "scripts/bench_routing.py": [("scripts/bench_routing_torch.py",
                                  ("main", "seeded_vrptw",
                                   "best_known_proxy"))],
    "scripts/bench_scheduling.py": [("scripts/bench_scheduling_torch.py",
                                     ("main", "seeded_instance",
                                      "run_engine"))],
    # a major's time by kernel, the SpMVs alone, attempts per iteration
    "scripts/profile_major.py": [
        ("chip_smoke.py", ("device_profile", "kernel_times")),
        ("scripts/torch_bench_probe.py", ("block_rate",))],
    # fast against exact kernels on the card, each stream's rate
    "scripts/check_mixed.py": [
        ("chip_smoke.py", ("kernels_against_plain", "stream_rates"))],
    # battery instances through mip.solve, each against HiGHS
    "scripts/probe_mip.py": [("scripts/torch_mip_probe.py",
                              ("main", "--cases"))],
    "scripts/repro_deadline.py": [("scripts/repro_deadline_torch.py",
                                   ("main",))],
}


def _imports_jax(path: Path) -> bool:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        if any(n.split(".")[0] in ("jax", "ortools_tpu") for n in names):
            return True
    return False


JAX_SCRIPTS = sorted(
    str(p.relative_to(ROOT))
    for p in sorted(ROOT.glob("*.py"))
    + sorted((ROOT / "scripts").glob("*.py"))
    if _imports_jax(p))


def test_the_script_census_is_whole():
    assert set(JAX_SCRIPTS) == set(SCRIPT_COUNTERPARTS)
    assert len(JAX_SCRIPTS) == 16


@pytest.mark.parametrize("rel", JAX_SCRIPTS)
def test_every_jax_script_has_a_counterpart(rel):
    assert rel in SCRIPT_COUNTERPARTS, f"{rel} has no counterpart"
    for counterpart, names in SCRIPT_COUNTERPARTS[rel]:
        path = ROOT / counterpart
        assert path.is_file(), counterpart
        assert not _imports_jax(path), counterpart
        text = path.read_text()
        defs = {node.name for node in ast.walk(ast.parse(text))
                if isinstance(node, ast.FunctionDef)}
        for name in names:
            assert (name in text) if name.startswith("--") else (
                name in defs), (counterpart, name)
