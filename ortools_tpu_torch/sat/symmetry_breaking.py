"""CP model symmetry detection + breaking (presolve wave 2).

Capability parity: ``ortools/sat/cp_model_symmetries.cc``
(``DetectAndAddSymmetryToProto``, wired at cp_model_solver.cc:4511) —
variable symmetries found as automorphisms of a colored model graph via
``algorithms/symmetry.GraphSymmetryFinder`` (the in-repo analogue of
``algorithms/find_graph_symmetries``), then broken with lex-leader
inequalities.

Graph encoding (original design, standard colored-bipartite scheme):
  - one node per variable, colored by (canonical domain, objective
    coefficient) — variables with different objectives never swap;
  - one node per constraint, colored by (kind, constant signature);
  - one TERM node per (constraint, variable) occurrence, colored by the
    occurrence role (linear coefficient / literal sign / enforcement
    sign), edged var—term—constraint.
A color-preserving automorphism restricted to variable nodes is then a
solution-set-preserving variable permutation of the model.

Breaking: for each generator sigma and f = min moved variable (in the
fixed variable-index order), the lex-least point z of every solution
orbit satisfies z_f <= z_{sigma(f)} and z_f <= z_{sigma^{-1}(f)}; those
2-variable inequalities are emitted as linear constraints.  All emitted
inequalities refer to the SAME variable order, so they are simultaneously
satisfied by each orbit's lex-least point — sound for satisfiability and
optimization, NOT for solution enumeration (callers gate on that, as the
reference does).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain, INT_MAX

_SUPPORTED = frozenset([
    "bool_or", "bool_and", "at_most_one", "exactly_one", "linear",
])


def _domain_key(d: Domain) -> Tuple:
    return tuple(d.intervals())


def detect_variable_symmetries(
        model: ir.CpModelIR,
        max_graph_nodes: int = 8000,
        node_budget: int = 50_000):
    """Generators of a variable-symmetry group of the model, or [] when
    out of fragment / over budget."""
    n = len(model.variables)
    for ct in model.constraints:
        if ct.kind not in _SUPPORTED:
            return []
    obj = {}
    if model.objective is not None:
        for v, c in zip(model.objective.vars, model.objective.coeffs):
            obj[v] = obj.get(v, 0) + c
    colors: List = []
    for i, v in enumerate(model.variables):
        colors.append(("var", _domain_key(v.domain), obj.get(i, 0)))
    edges: List[Tuple[int, int]] = []
    nodes = n
    for ct in model.constraints:
        a = ct.args
        if ct.kind == "linear":
            sig = ("linear", _domain_key(a.domain),
                   tuple(sorted(a.coeffs)))
            terms = list(zip(a.vars, a.coeffs))
        else:
            lits = a.literals
            sig = (ct.kind, len(lits))
            terms = [(ir.literal_index(l),
                      1 if ir.literal_is_positive(l) else -1)
                     for l in lits]
        sig = sig + (
            tuple(sorted(
                (1 if ir.literal_is_positive(l) else -1)
                for l in ct.enforcement_literals)),
        )
        cnode = nodes
        nodes += 1
        colors.append(("ct", sig))
        for var, role in terms:
            tnode = nodes
            nodes += 1
            colors.append(("term", role))
            edges.append((var, tnode))
            edges.append((tnode, cnode))
        for l in ct.enforcement_literals:
            tnode = nodes
            nodes += 1
            colors.append(
                ("enf", 1 if ir.literal_is_positive(l) else -1))
            edges.append((ir.literal_index(l), tnode))
            edges.append((tnode, cnode))
        if nodes > max_graph_nodes:
            return []
    from ortools_tpu_torch.algorithms.symmetry import GraphSymmetryFinder

    remap = {c: k for k, c in enumerate(sorted(set(colors), key=repr))}
    finder = GraphSymmetryFinder(
        nodes, edges, node_colors=[remap[c] for c in colors],
        node_budget=node_budget)
    gens = []
    for g in finder.find_generators():
        # restrict to the variable nodes
        mapping = g.to_mapping()
        var_map = mapping[:n] if len(mapping) >= n else None
        if var_map is None:
            continue
        if any(m >= n for m in var_map):
            continue  # mixes var and non-var nodes: not a var symmetry
        if var_map == list(range(n)):
            continue
        gens.append(var_map)
    return gens


def add_symmetry_breaking(model: ir.CpModelIR,
                          max_generators: int = 64
                          ) -> ir.CpModelIR:
    """Detect symmetries and append lex-leader inequalities.  No-op when
    nothing is found; callers must NOT use this for solution enumeration
    and should skip it when a solution hint is present (the hint may not
    be the lex-least representative)."""
    gens = detect_variable_symmetries(model)
    if not gens:
        return model
    n = len(model.variables)
    new_cts: List[ir.ConstraintIR] = []
    seen = set()

    def emit(i: int, j: int):
        if i == j or (i, j) in seen:
            return
        seen.add((i, j))
        new_cts.append(ir.ConstraintIR(
            "linear",
            ir.LinearArgs([i, j], [-1, 1], Domain(0, INT_MAX)),
            name="symmetry_break",
        ))

    for var_map in gens[:max_generators]:
        moved = [i for i in range(n) if var_map[i] != i]
        if not moved:
            continue
        f = min(moved)
        # z_f <= z_{sigma(f)} and z_f <= z_{sigma^{-1}(f)}
        emit(f, var_map[f])
        inv = {var_map[i]: i for i in moved}
        emit(f, inv[f])
    if not new_cts:
        return model
    return dataclasses.replace(
        model, constraints=list(model.constraints) + new_cts)
