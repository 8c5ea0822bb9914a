"""Pure-SAT / max-SAT / pseudo-Boolean problem readers.

Capability parity: ``ortools/sat/sat_cnf_reader.h`` (DIMACS CNF and
weighted wCNF, both the classic ``p wcnf`` header form and the 2022
MaxSAT-evaluation "h"-prefix form) and ``ortools/sat/opb_reader.h``
(linear OPB pseudo-Boolean instances), feeding ``sat_runner``
(``ortools/sat/sat_runner.cc``, here ``sat/runner.py``).

All readers build a ``CpModelIR``: hard clauses become ``bool_or``
rows, soft clauses get a fresh relaxation literal whose weighted sum is
minimized (the reference's slack encoding, sat_cnf_reader.h:184), and
OPB constraints become integer ``linear`` rows over boolean variables.
Clause-only outputs ride the native CDCL core via sat/pure_sat.py; the
weighted objective rides the core-guided (OLL) descent.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain, INT_MAX, INT_MIN


class SatIoError(ValueError):
    pass


def _bool_domain() -> Domain:
    return Domain(0, 1)


def _ensure_vars(model: ir.CpModelIR, n: int) -> None:
    while len(model.variables) < n:
        model.variables.append(
            ir.IntegerVariableIR(f"x{len(model.variables) + 1}",
                                 _bool_domain()))


def _dimacs_lit(tok: int) -> int:
    """DIMACS literal (1-based, sign = polarity) -> IR literal."""
    v = abs(tok) - 1
    return v if tok > 0 else -v - 1


def read_cnf(text: str, name: str = "") -> ir.CpModelIR:
    """Parse a DIMACS CNF string into a clause-only CP model."""
    model = ir.CpModelIR(name=name)
    declared: Optional[Tuple[int, int]] = None
    lits: List[int] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("c", "%")):
            continue
        if line.startswith("p"):
            parts = line.split()
            if len(parts) < 4 or parts[1] != "cnf":
                raise SatIoError(f"bad problem line: {line!r}")
            declared = (int(parts[2]), int(parts[3]))
            _ensure_vars(model, declared[0])
            continue
        for tok in line.split():
            t = int(tok)
            if t == 0:
                if lits:
                    _ensure_vars(model,
                                 max(ir.literal_index(x) for x in lits) + 1)
                    model.constraints.append(
                        ir.ConstraintIR("bool_or", ir.BoolArgs(list(lits))))
                    lits.clear()
                else:
                    # empty clause: trivially unsatisfiable model
                    model.constraints.append(
                        ir.ConstraintIR("bool_or", ir.BoolArgs([])))
            else:
                lits.append(_dimacs_lit(t))
    if lits:  # final clause without the trailing 0
        _ensure_vars(model, max(ir.literal_index(x) for x in lits) + 1)
        model.constraints.append(
            ir.ConstraintIR("bool_or", ir.BoolArgs(list(lits))))
    return model


def read_wcnf(text: str, name: str = "") -> ir.CpModelIR:
    """Parse weighted (partial) max-SAT: classic ``p wcnf n m [top]``
    lines or the 2022 format (``h`` prefix = hard, leading integer =
    soft weight, no problem line)."""
    model = ir.CpModelIR(name=name)
    top: Optional[int] = None
    soft: List[Tuple[int, List[int]]] = []  # (weight, clause literals)
    classic = False

    def parse_clause(tokens: List[str]) -> List[int]:
        out = []
        for tok in tokens:
            t = int(tok)
            if t == 0:
                break
            out.append(_dimacs_lit(t))
        return out

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("c", "%")):
            continue
        if line.startswith("p"):
            parts = line.split()
            if len(parts) < 4 or parts[1] not in ("wcnf", "cnf"):
                raise SatIoError(f"bad problem line: {line!r}")
            _ensure_vars(model, int(parts[2]))
            if parts[1] == "wcnf":
                classic = True
                top = int(parts[4]) if len(parts) > 4 else None
            continue
        parts = line.split()
        if parts[0] == "h":  # 2022 format hard clause
            lits = parse_clause(parts[1:])
            _ensure_vars(model,
                         max((ir.literal_index(x) for x in lits),
                             default=0) + 1)
            model.constraints.append(
                ir.ConstraintIR("bool_or", ir.BoolArgs(lits)))
            continue
        if classic:
            w = int(parts[0])
            lits = parse_clause(parts[1:])
            if top is not None and w >= top:
                _ensure_vars(model,
                             max((ir.literal_index(x) for x in lits),
                                 default=0) + 1)
                model.constraints.append(
                    ir.ConstraintIR("bool_or", ir.BoolArgs(lits)))
            else:
                soft.append((w, lits))
        else:
            # 2022 format: leading integer weight = soft clause
            w = int(parts[0])
            soft.append((w, parse_clause(parts[1:])))

    if soft:
        obj_vars: List[int] = []
        obj_coeffs: List[int] = []
        for w, lits in soft:
            _ensure_vars(model,
                         max((ir.literal_index(x) for x in lits),
                             default=0) + 1)
            # relaxation literal: clause or slack (sat_cnf_reader.h:184)
            s = len(model.variables)
            model.variables.append(
                ir.IntegerVariableIR(f"_soft{len(obj_vars)}",
                                     _bool_domain()))
            model.constraints.append(
                ir.ConstraintIR("bool_or", ir.BoolArgs(lits + [s])))
            obj_vars.append(s)
            obj_coeffs.append(w)
        model.objective = ir.ObjectiveIR(vars=obj_vars, coeffs=obj_coeffs,
                                         offset=0, maximize=False)
    return model


def read_opb(text: str, name: str = "") -> ir.CpModelIR:
    """Parse a linear OPB pseudo-Boolean instance (opb_reader.h): an
    optional ``min:`` objective line and ``<terms> >=|=|<= rhs ;``
    constraints over x<i> boolean variables (~x<i> = negation)."""
    model = ir.CpModelIR(name=name)
    var_of: Dict[int, int] = {}

    def var_index(n1: int) -> int:
        if n1 not in var_of:
            var_of[n1] = len(model.variables)
            model.variables.append(
                ir.IntegerVariableIR(f"x{n1}", _bool_domain()))
        return var_of[n1]

    def parse_terms(tokens: List[str]) -> Tuple[List[int], List[int], int]:
        """-> (vars, coeffs, constant_offset); ~x contributes c*(1-x)."""
        vs: List[int] = []
        cs: List[int] = []
        const = 0
        i = 0
        while i < len(tokens):
            c = int(tokens[i])
            i += 1
            if i >= len(tokens):
                raise SatIoError("dangling coefficient in OPB terms")
            name_tok = tokens[i]
            i += 1
            if i < len(tokens) and tokens[i].lstrip("~").startswith("x"):
                # two variable tokens in a row = a product term
                raise SatIoError("nonlinear OPB terms are not supported")
            neg = name_tok.startswith("~")
            if neg:
                name_tok = name_tok[1:]
            if not name_tok.startswith("x"):
                raise SatIoError(f"bad OPB variable token: {name_tok!r}")
            v = var_index(int(name_tok[1:]))
            if neg:
                vs.append(v)
                cs.append(-c)
                const += c
            else:
                vs.append(v)
                cs.append(c)
        return vs, cs, const

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("*"):
            continue
        if line.endswith(";"):
            line = line[:-1].strip()
        if line.startswith("min:") or line.startswith("max:"):
            maximize = line.startswith("max:")
            vs, cs, const = parse_terms(line[4:].split())
            model.objective = ir.ObjectiveIR(
                vars=vs, coeffs=cs, offset=const, maximize=maximize)
            continue
        for op in (">=", "<=", "="):
            if op in line:
                lhs, rhs_s = line.split(op, 1)
                rhs = int(rhs_s.strip())
                vs, cs, const = parse_terms(lhs.split())
                rhs -= const
                if op == ">=":
                    dom = Domain(rhs, INT_MAX)
                elif op == "<=":
                    dom = Domain(INT_MIN, rhs)
                else:
                    dom = Domain(rhs, rhs)
                model.constraints.append(
                    ir.ConstraintIR("linear",
                                    ir.LinearArgs(vs, cs, dom)))
                break
        else:
            raise SatIoError(f"unrecognized OPB line: {raw!r}")
    return model


def read_problem_file(path: str) -> ir.CpModelIR:
    """Dispatch on extension: .cnf/.dimacs, .wcnf, .opb, else JSON
    (sat/serialization.py)."""
    with open(path) as f:
        text = f.read()
    low = path.lower()
    if low.endswith((".cnf", ".dimacs")):
        return read_cnf(text, name=path)
    if low.endswith(".wcnf"):
        return read_wcnf(text, name=path)
    if low.endswith(".opb"):
        return read_opb(text, name=path)
    from ortools_tpu_torch.sat.serialization import model_from_json
    return model_from_json(text)
