"""A cell's instances, made by the configuration's generator, and their form
for the program.

The instances of a configuration are the same in every run: instance ``i``
comes from the generator seed drawn for ``i``, never from ``--seed``.  The
run's seed draws the traffic over them (the order of the solves, the nodes
of a batch), so that every seed gives work of the same kind in another
order and the runs' spread is the system's, not the instances'."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from lpbench.spec import generator
from reference.lp import Instance

# Generator seeds tried per instance where the generator has a certificate
# and finds no feasible point for the first.
_ATTEMPTS = 16

UNIT_ROUNDOFF = {"float64": 2.0 ** -53, "float32": 2.0 ** -24,
                 "bfloat16": 2.0 ** -8}


def sub_seed(seed: int, *path: int) -> int:
    """A generator seed drawn from the run's ``seed`` and a purpose."""
    ss = np.random.SeedSequence([seed % 2**64, *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *path]))


def certificate(bench_dir: Path, config: dict):
    """The generator's feasibility certificate, or None where it has none."""
    return getattr(generator(bench_dir, config["generator"]), "certificate",
                   None)


def make_instance(bench_dir: Path, config: dict, index: int) -> Instance:
    """Instance ``index`` of the configuration.  Where the generator has a
    certificate, the first of its seeds that it proves feasible."""
    gen = generator(bench_dir, config["generator"])
    cert = certificate(bench_dir, config)
    for attempt in range(_ATTEMPTS if cert else 1):
        inst = gen.make(**config["instance"],
                        seed=sub_seed(0, 0, index, attempt))
        if cert is None or cert(inst, ()) is not None:
            return inst
    raise RuntimeError(f"no feasible instance {index} of {config['name']}")


def to_program(inst: Instance):
    """The program's ``QuadraticProgram`` of ``inst``, with a matrix of its
    own (built once; the drivers hand each call a copy)."""
    from ortools_tpu_torch.models.lp import QuadraticProgram

    a = sp.csr_matrix((inst.vals, (inst.rows, inst.cols)),
                      shape=(inst.m, inst.n))
    return QuadraticProgram(
        objective_vector=inst.c.copy(), constraint_matrix=a,
        constraint_lower=inst.con_lo.copy(), constraint_upper=inst.con_hi.copy(),
        variable_lower=inst.var_lo.copy(), variable_upper=inst.var_hi.copy(),
        name=inst.name)


def fresh_copy(qp):
    """``qp`` with copies of its matrix and vectors, so that no call of the
    program is handed an object an earlier call has seen."""
    return dataclasses.replace(
        qp, constraint_matrix=qp.constraint_matrix.copy(),
        objective_vector=qp.objective_vector.copy(),
        constraint_lower=qp.constraint_lower.copy(),
        constraint_upper=qp.constraint_upper.copy(),
        variable_lower=qp.variable_lower.copy(),
        variable_upper=qp.variable_upper.copy())


def solver_params(config: dict):
    """The program's ``PdhgParams`` of the configuration: its ``params``,
    ``dtype`` by name; every other field keeps the program's default."""
    import torch

    from ortools_tpu_torch.pdlp.params import PdhgParams

    p = dict(config["params"])
    p["dtype"] = getattr(torch, p["dtype"])
    return PdhgParams(**p)
