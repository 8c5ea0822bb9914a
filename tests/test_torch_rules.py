"""Rules of the PyTorch port that no functional test would catch."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import ortools_tpu_torch  # noqa: F401  (sets the precision pins)
from ortools_tpu_torch.models.lp import random_lp
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.pdlp import PdhgParams, solve

# The tensors are small: one thread each keeps the parallel test run's
# workers off each other's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ortools_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ortools_tpu"), (path, mod)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    qp = random_lp(10, 10, density=0.3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(qp, PdhgParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockSparseMatrix.from_scipy(qp.constraint_matrix)


def test_tf32_is_off_and_matmul_precision_highest():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_solve_runs_when_asked():
    qp = random_lp(10, 10, density=0.3, seed=0)
    r = solve(qp, PdhgParams(dtype=torch.float64), device="cpu")
    assert r.termination_reason.name == "OPTIMAL"
    assert np.all(np.isfinite(r.primal_solution))
