"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU: each example's ``main`` with ``device="cpu"``
and the arguments of tests/test_examples.py passes its own asserts and
returns what the JAX example returns.  ``pdlp_large_lp`` returns a solve:
the same termination reason, the objective within the solve's relative
tolerance (1e-6) and the iteration count within a quarter (ROADMAP's
parity rules for longer f64 solves)."""

import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py"))
ARGS = {"nqueens_sat": (6,), "jobshop_sat": (8.0,)}  # tests/test_examples.py


def _load(folder: str, stem: str):
    path = ROOT / folder / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"{folder}_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_nine_examples_are_ported():
    assert EXAMPLES == sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert len(EXAMPLES) == 9


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_returns_what_the_jax_example_returns(stem):
    args = ARGS.get(stem, ())
    port = _load("examples_torch", stem).main(*args, device="cpu")
    ref = _load("examples", stem).main(*args)
    if stem == "pdlp_large_lp":
        assert port.termination_reason.name == ref.termination_reason.name
        assert port.termination_reason.name == "OPTIMAL"
        assert abs(port.primal_objective - ref.primal_objective) <= 1e-6 * (
            1 + abs(ref.primal_objective))
        assert abs(port.iterations - ref.iterations) <= ref.iterations / 4
    else:
        assert port == ref
