"""FlatZinc front-end.

Capability parity: ``ortools/flatzinc`` (flex/bison parser + the
FlatZinc -> CpModelProto translation of cp_model_fz_solver.cc + the fz CLI,
fz.cc:174).  FlatZinc is machine-generated and line-regular, so a
regex/recursive-descent parser covers it without a parser generator.

Supported items: par/var declarations (int ranges, int sets, bool, arrays),
constraints over the common integer/bool builtins (with _reif forms),
solve satisfy/minimize/maximize, output annotations.  Unknown predicates
raise a clear error listing the offender (reference behavior).
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Dict, List, Optional, Tuple, Union

from ortools_tpu_torch.sat import CpModel, CpSolver, CpSolverSolutionCallback
from ortools_tpu_torch.sat.cp_model import IntVar, LinearExpr, _NotBoolVar
from ortools_tpu_torch.utils.domain import Domain
from ortools_tpu_torch.utils.status import SolveStatus
from ortools_tpu_torch.utils.device import device_option_or_exit, resolve_device


class FlatZincError(ValueError):
    pass


_ITEM_RE = re.compile(r"([^;]*);", re.S)


@dataclasses.dataclass
class FzResult:
    status: SolveStatus
    text: str  # FlatZinc-format output
    objective: Optional[float] = None


def _split_top(s: str, sep: str = ",") -> List[str]:
    """Split at top level (not inside brackets/parens)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last:
        out.append(last)
    return out


FLOAT_SCALE = 10**6  # fixed-point scale for float variables


@dataclasses.dataclass
class _SetVar:
    """A finite set variable as a characteristic boolean vector over its
    declared universe (the reference encodes set vars the same way,
    flatzinc/cp_model_fz_solver.cc set handling)."""
    name: str
    values: List[int]          # sorted universe
    bools: List  # BoolVar per universe value ("value is a member")

    def bool_for(self, v: int):
        try:
            return self.bools[self.values.index(v)]
        except ValueError:
            return None  # value outside the universe: membership is false


class _FzModel:
    def __init__(self) -> None:
        self.model = CpModel()
        self.vars: Dict[str, IntVar] = {}
        self.pars: Dict[str, Union[int, List[int]]] = {}
        self.arrays: Dict[str, List] = {}  # name -> list of IntVar/int
        self.set_vars: Dict[str, _SetVar] = {}
        self.output_items: List[Tuple[str, object]] = []
        self.objective = None
        self.sense = "satisfy"
        # float variables are fixed-point integers at FLOAT_SCALE
        # (the reference scales floats into CpModel integers too,
        # flatzinc/cp_model_fz_solver + FloatObjectiveProto)
        self.float_var_ids: set = set()

    def is_float(self, item) -> bool:
        return isinstance(item, IntVar) and item.index in self.float_var_ids

    def set_var(self, tok: str) -> "_SetVar":
        tok = tok.strip()
        sv = self.set_vars.get(tok)
        if sv is None:
            raise FlatZincError(f"not a set variable: {tok!r}")
        return sv

    # ---- value/expression resolution ----------------------------------
    def value(self, tok: str):
        tok = tok.strip()
        if tok in self.vars:
            return self.vars[tok]
        if tok in self.pars:
            return self.pars[tok]
        if tok in self.arrays:
            return self.arrays[tok]
        if tok.startswith("[") and tok.endswith("]"):
            inner = tok[1:-1].strip()
            return [self.value(t) for t in _split_top(inner)] if inner else []
        if tok == "true":
            return 1
        if tok == "false":
            return 0
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if re.fullmatch(r"-?\d+\.\d+([eE][-+]?\d+)?", tok) or \
                re.fullmatch(r"-?\d+[eE][-+]?\d+", tok):
            return float(tok)
        m = re.fullmatch(r"(\w+)\[(\d+)\]", tok)
        if m:
            return self.arrays[m.group(1)][int(m.group(2)) - 1]
        raise FlatZincError(f"cannot resolve {tok!r}")

    def int_list(self, tok: str) -> List[int]:
        v = self.value(tok)
        assert isinstance(v, list), tok
        return [int(x) for x in v]

    def var_list(self, tok: str) -> List:
        v = self.value(tok)
        return v if isinstance(v, list) else [v]

    def as_expr(self, item) -> LinearExpr:
        if isinstance(item, LinearExpr):
            return item
        return LinearExpr.of(int(item))

    def lin(self, coeffs: str, xs: str) -> LinearExpr:
        cs = self.int_list(coeffs)
        vs = self.var_list(xs)
        return LinearExpr.sum([self.as_expr(v) * c for c, v in zip(cs, vs)])

    def as_lit(self, item):
        if isinstance(item, (IntVar, _NotBoolVar)):
            return item
        return bool(int(item))


def parse_fzn(text: str) -> _FzModel:
    fz = _FzModel()
    m = fz.model
    # strip comments
    text = re.sub(r"%[^\n]*", "", text)
    for item_m in _ITEM_RE.finditer(text):
        item = item_m.group(1).strip()
        if not item:
            continue
        if item.startswith("predicate"):
            continue
        anns = re.findall(r"::\s*([\w]+(?:\([^)]*\))?)", item)
        body = re.split(r"::", item)[0].strip()
        if item.startswith("solve"):
            _parse_solve(fz, item)
            continue
        if body.startswith("constraint"):
            _parse_constraint(fz, body[len("constraint"):].strip())
            continue
        _parse_decl(fz, body, anns, item)
    return fz


def _parse_domain(dom: str) -> Domain:
    dom = dom.strip()
    if dom == "bool":
        return Domain(0, 1)
    if dom == "int":
        return Domain(-(2**31), 2**31)
    m = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", dom)
    if m:
        return Domain(int(m.group(1)), int(m.group(2)))
    if dom.startswith("{"):
        vals = [int(x) for x in _split_top(dom[1:-1])]
        return Domain.from_values(vals)
    raise FlatZincError(f"unsupported domain {dom!r}")


def _parse_decl(fz: _FzModel, body: str, anns: List[str],
                full_item: str) -> None:
    mdl = fz.model
    # array declaration
    am = re.match(
        r"array\s*\[\s*1\s*\.\.\s*(\d+)\s*\]\s*of\s+(.*?):\s*(\w+)"
        r"(?:\s*=\s*(.*))?$",
        body, re.S,
    )
    if am:
        size, elem_type, name, init = am.groups()
        size = int(size)
        if init is not None:
            vals = [fz.value(t) for t in _split_top(init.strip()[1:-1])]
            fz.arrays[name] = vals
        else:
            elem_type = elem_type.strip()
            if elem_type.startswith("var"):
                dom = _parse_domain(elem_type[3:].strip())
                fz.arrays[name] = [
                    mdl.new_int_var_from_domain(dom, f"{name}[{i+1}]")
                    for i in range(size)
                ]
            else:
                raise FlatZincError(f"par array without init: {body!r}")
        for ann in anns:
            if ann.startswith("output_array"):
                fz.output_items.append((name, fz.arrays[name]))
        return
    # var declaration
    vm = re.match(r"var\s+(.*?):\s*(\w+)(?:\s*=\s*(.*))?$", body, re.S)
    if vm:
        dom_s, name, init = vm.groups()
        sm = re.fullmatch(r"set\s+of\s+(.*)", dom_s.strip(), re.S)
        if sm:
            universe = sorted(_parse_domain(sm.group(1).strip()))
            if len(universe) > 4096:
                raise FlatZincError(f"set universe too large for {name!r}")
            bools = [mdl.new_bool_var(f"{name}__has_{v}") for v in universe]
            sv = _SetVar(name, list(universe), bools)
            fz.set_vars[name] = sv
            if init is not None:
                fixed = set(_parse_set_const(fz, init.strip()))
                for v, b in zip(sv.values, sv.bools):
                    mdl.add_bool_or([b] if v in fixed else [_neg(b)])
                if not fixed.issubset(universe):
                    raise FlatZincError(
                        f"set init outside universe for {name!r}")
            if any(a.startswith("output_var") for a in anns):
                fz.output_items.append((name, sv))
            return
        if init is not None:
            val = fz.value(init.strip())
            if isinstance(val, IntVar):
                fz.vars[name] = val
            else:
                fz.vars[name] = fz.model.new_constant(int(val))
        else:
            dom_s2 = dom_s.strip()
            fm = re.fullmatch(
                r"(-?\d+(?:\.\d+)?)\s*\.\.\s*(-?\d+(?:\.\d+)?)",
                dom_s2)
            if dom_s2 == "float" or (
                    fm and ("." in fm.group(1) or "." in fm.group(2))):
                if dom_s2 == "float":
                    lo, hi = -(2**40), 2**40
                else:
                    lo = _scaled_const(float(fm.group(1)))
                    hi = _scaled_const(float(fm.group(2)))
                v = mdl.new_int_var(lo, hi, name)
                fz.vars[name] = v
                fz.float_var_ids.add(v.index)
            else:
                fz.vars[name] = mdl.new_int_var_from_domain(
                    _parse_domain(dom_s), name
                )
        if any(a.startswith("output_var") for a in anns):
            fz.output_items.append((name, fz.vars[name]))
        return
    # par declaration
    pm = re.match(r"(?:int|bool|float)\s*:\s*(\w+)\s*=\s*(.*)$",
                  body, re.S)
    if pm:
        name, init = pm.groups()
        fz.pars[name] = fz.value(init.strip())
        return
    pm2 = re.match(r"set\s+of\s+int\s*:\s*(\w+)\s*=\s*(.*)$", body, re.S)
    if pm2:
        name, init = pm2.groups()
        init = init.strip()
        rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", init)
        if rm:
            fz.pars[name] = list(range(int(rm.group(1)),
                                       int(rm.group(2)) + 1))
        else:
            fz.pars[name] = [int(x) for x in _split_top(init[1:-1])]
        return
    raise FlatZincError(f"cannot parse declaration: {full_item!r}")


def _parse_solve(fz: _FzModel, item: str) -> None:
    item = re.sub(r"::\s*\w+\([^)]*\)", "", item)  # drop search annotations
    parts = item.split()
    if "satisfy" in parts:
        fz.sense = "satisfy"
        return
    for sense in ("minimize", "maximize"):
        if sense in parts:
            target = item.split(sense, 1)[1].strip()
            fz.sense = sense
            fz.objective = fz.as_expr(fz.value(target))
            if sense == "minimize":
                fz.model.minimize(fz.objective)
            else:
                fz.model.maximize(fz.objective)
            return
    raise FlatZincError(f"cannot parse solve item: {item!r}")


def _parse_constraint(fz: _FzModel, text: str) -> None:
    m = re.match(r"(\w+)\s*\((.*)\)$", text, re.S)
    if not m:
        raise FlatZincError(f"bad constraint syntax: {text!r}")
    name, args_s = m.group(1), m.group(2)
    args = _split_top(args_s)
    mdl = fz.model
    E = fz.as_expr
    V = fz.value

    def expr(i):
        return E(V(args[i]))

    def lit(i):
        return fz.as_lit(V(args[i]))

    if name == "int_lin_eq":
        mdl.add(fz.lin(args[0], args[1]) == int(V(args[2])))
    elif name == "int_lin_le":
        mdl.add(fz.lin(args[0], args[1]) <= int(V(args[2])))
    elif name == "int_lin_ne":
        mdl.add(fz.lin(args[0], args[1]) != int(V(args[2])))
    elif name in ("int_lin_eq_reif", "int_lin_le_reif"):
        b = lit(3)
        e = fz.lin(args[0], args[1])
        c = int(V(args[2]))
        if name == "int_lin_eq_reif":
            mdl.add(e == c).only_enforce_if(b)
            mdl.add(e != c).only_enforce_if(_neg(b))
        else:
            mdl.add(e <= c).only_enforce_if(b)
            mdl.add(e >= c + 1).only_enforce_if(_neg(b))
    elif name in ("int_eq", "bool_eq"):
        mdl.add(expr(0) == expr(1))
    elif name in ("int_ne", "bool_not"):
        mdl.add(expr(0) != expr(1))
    elif name in ("int_le", "bool_le"):
        mdl.add(expr(0) <= expr(1))
    elif name in ("int_lt", "bool_lt"):
        mdl.add(expr(0) <= expr(1) - 1)
    elif name in ("int_eq_reif", "bool_eq_reif"):
        b = lit(2)
        mdl.add(expr(0) == expr(1)).only_enforce_if(b)
        mdl.add(expr(0) != expr(1)).only_enforce_if(_neg(b))
    elif name in ("int_ne_reif",):
        b = lit(2)
        mdl.add(expr(0) != expr(1)).only_enforce_if(b)
        mdl.add(expr(0) == expr(1)).only_enforce_if(_neg(b))
    elif name in ("int_le_reif", "bool_le_reif"):
        b = lit(2)
        mdl.add(expr(0) <= expr(1)).only_enforce_if(b)
        mdl.add(expr(0) >= expr(1) + 1).only_enforce_if(_neg(b))
    elif name in ("int_lt_reif", "bool_lt_reif"):
        b = lit(2)
        mdl.add(expr(0) <= expr(1) - 1).only_enforce_if(b)
        mdl.add(expr(0) >= expr(1)).only_enforce_if(_neg(b))
    elif name == "int_plus":
        mdl.add(expr(0) + expr(1) == expr(2))
    elif name == "int_minus":
        mdl.add(expr(0) - expr(1) == expr(2))
    elif name == "int_times":
        mdl.add_multiplication_equality(expr(2), [expr(0), expr(1)])
    elif name == "int_div":
        mdl.add_division_equality(expr(2), expr(0), expr(1))
    elif name == "int_mod":
        mdl.add_modulo_equality(expr(2), expr(0), expr(1))
    elif name == "int_abs":
        mdl.add_abs_equality(expr(1), expr(0))
    elif name == "int_min":
        mdl.add_min_equality(expr(2), [expr(0), expr(1)])
    elif name == "int_max":
        mdl.add_max_equality(expr(2), [expr(0), expr(1)])
    elif name == "array_int_maximum":
        mdl.add_max_equality(expr(0), [E(v) for v in fz.var_list(args[1])])
    elif name == "array_int_minimum":
        mdl.add_min_equality(expr(0), [E(v) for v in fz.var_list(args[1])])
    elif name in ("array_int_element", "array_var_int_element"):
        idx = expr(0) - 1  # FlatZinc is 1-based
        arr = [E(v) for v in fz.var_list(args[1])]
        mdl.add_element(idx, arr, expr(2))
    elif name == "all_different_int":
        mdl.add_all_different([E(v) for v in fz.var_list(args[0])])
    elif name in ("fzn_cumulative", "cumulative"):
        # cumulative(s, d, r, b): renewable-resource scheduling
        starts = [E(v) for v in fz.var_list(args[0])]
        durs = [E(v) for v in fz.var_list(args[1])]
        reqs = [E(v) for v in fz.var_list(args[2])]
        ivs = [mdl.new_interval_var(s, d, s + d)
               for s, d in zip(starts, durs)]
        mdl.add_cumulative(ivs, reqs, expr(3))
    elif name in ("fzn_diffn", "diffn"):
        # diffn(x, y, dx, dy): non-overlapping rectangles
        xs = [E(v) for v in fz.var_list(args[0])]
        ys = [E(v) for v in fz.var_list(args[1])]
        dxs = [E(v) for v in fz.var_list(args[2])]
        dys = [E(v) for v in fz.var_list(args[3])]
        xiv = [mdl.new_interval_var(x, dx, x + dx)
               for x, dx in zip(xs, dxs)]
        yiv = [mdl.new_interval_var(y, dy, y + dy)
               for y, dy in zip(ys, dys)]
        mdl.add_no_overlap_2d(xiv, yiv)
    elif name in ("fzn_circuit", "circuit"):
        # circuit(x): 1-based successor array forms one Hamiltonian cycle
        succ = [E(v) for v in fz.var_list(args[0])]
        n = len(succ)
        arcs = []
        for i, s in enumerate(succ):
            if n > 1:
                mdl.add(s != i + 1)  # MiniZinc circuit forbids self-loops
            for j in range(1, n + 1):
                if j == i + 1 and n > 1:
                    continue
                b = mdl.new_bool_var(f"_circ{i}_{j}")
                mdl.add(s == j).only_enforce_if(b)
                mdl.add(s != j).only_enforce_if(_neg(b))
                arcs.append((i, j - 1, b))
        mdl.add_circuit(arcs)
    elif name in ("fzn_inverse", "inverse"):
        # inverse(f, g): g[f[i]] = i with 1-based values -> shift to 0-based
        f_vars = [E(v) - 1 for v in fz.var_list(args[0])]
        g_vars = [E(v) - 1 for v in fz.var_list(args[1])]
        f0, g0 = [], []
        for k, e in enumerate(f_vars):
            v = mdl.new_int_var(0, len(g_vars) - 1, f"_inv_f{k}")
            mdl.add(v == e)
            f0.append(v)
        for k, e in enumerate(g_vars):
            v = mdl.new_int_var(0, len(f_vars) - 1, f"_inv_g{k}")
            mdl.add(v == e)
            g0.append(v)
        mdl.add_inverse(f0, g0)
    elif name in ("fzn_global_cardinality", "global_cardinality",
                  "fzn_global_cardinality_closed",
                  "global_cardinality_closed"):
        xs = [E(v) for v in fz.var_list(args[0])]
        cover = fz.int_list(args[1])
        counts = [E(v) for v in fz.var_list(args[2])]
        for ci, (val, cnt) in enumerate(zip(cover, counts)):
            bs = []
            for k, x in enumerate(xs):
                b = mdl.new_bool_var(f"_gcc{ci}_{k}")
                mdl.add(x == val).only_enforce_if(b)
                mdl.add(x != val).only_enforce_if(_neg(b))
                bs.append(b)
            mdl.add(sum(bs) == cnt)
        if name.endswith("closed"):
            dom = Domain.from_values(cover)
            for x in xs:
                mdl.add_linear_expression_in_domain(x, dom)
    elif name in ("fzn_nvalue", "nvalue"):
        # nvalue(n, xs): n = number of distinct values taken by xs
        tgt = expr(0)
        xs = [E(v) for v in fz.var_list(args[1])]
        values: set = set()
        for x in xs:
            values.update(_expr_values(fz.model, x))
            if len(values) > 256:
                raise FlatZincError("nvalue domain too wide (> 256 values)")
        ys = []
        for v in sorted(values):
            # y_v <=> some x_k takes value v
            y = mdl.new_bool_var(f"_nv{v}")
            es = []
            for k, x in enumerate(xs):
                e = mdl.new_bool_var(f"_nv{v}_{k}")
                mdl.add(x == v).only_enforce_if(e)
                mdl.add(x != v).only_enforce_if(_neg(e))
                mdl.add_implication(e, y)
                es.append(e)
            mdl.add_bool_or(es).only_enforce_if(y)
            ys.append(y)
        mdl.add(sum(ys) == tgt)
    elif name in ("fzn_lex_less_int", "fzn_lex_lesseq_int", "lex_less",
                  "lex_lesseq", "fzn_lex_less_bool",
                  "fzn_lex_lesseq_bool"):
        xs = [E(v) for v in fz.var_list(args[0])]
        ys = [E(v) for v in fz.var_list(args[1])]
        k = min(len(xs), len(ys))
        # r_i = "the length-i prefixes are equal"; r_0 = true.
        # x <=lex y  <=>  for all i < k: r_i -> x_i <= y_i,
        # plus r_k forbidden when |x| > |y| (longer extension is bigger)
        # or when strict and |x| == |y| (full equality not allowed).
        r_prev = None  # None = constant true (r_0)
        for i in range(k):
            ct = mdl.add(xs[i] <= ys[i])
            if r_prev is not None:
                ct.only_enforce_if(r_prev)
            e = mdl.new_bool_var(f"_lexeq{i}")
            mdl.add(xs[i] == ys[i]).only_enforce_if(e)
            mdl.add(xs[i] != ys[i]).only_enforce_if(_neg(e))
            if r_prev is None:
                r = e
            else:
                r = mdl.new_bool_var(f"_lexr{i}")
                mdl.add_implication(r, r_prev)
                mdl.add_implication(r, e)
                mdl.add_bool_or([_neg(r_prev), _neg(e), r])
            r_prev = r
        strict = "lesseq" not in name
        forbid_full_eq = (len(xs) > len(ys)
                          or (strict and len(xs) == len(ys)))
        if forbid_full_eq:
            if r_prev is None:
                raise FlatZincError("lex_less on empty arrays is false")
            mdl.add_bool_or([_neg(r_prev)])
    elif name in ("fzn_regular", "regular"):
        # regular(x, Q, S, d, q0, F): DFA over 1..S symbols; next-state 0
        # is the fail state (omit those transitions)
        xs = [E(v) for v in fz.var_list(args[0])]
        n_states = int(V(args[1]))
        n_syms = int(V(args[2]))
        d_flat = fz.int_list(args[3])
        q0 = int(V(args[4]))
        f_tok = args[5].strip()
        rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", f_tok)
        if rm:
            finals = list(range(int(rm.group(1)), int(rm.group(2)) + 1))
        else:
            finals = [int(x) for x in _split_top(f_tok[1:-1])] \
                if len(f_tok) > 2 else []
        triples = []
        for st in range(1, n_states + 1):
            for sym in range(1, n_syms + 1):
                nxt = d_flat[(st - 1) * n_syms + (sym - 1)]
                if nxt != 0:
                    triples.append((st, sym, nxt))
        mdl.add_automaton(xs, q0, finals, triples)
    elif name == "bool_clause":
        pos = [fz.as_lit(v) for v in fz.var_list(args[0])]
        neg = [_neg(fz.as_lit(v)) for v in fz.var_list(args[1])]
        mdl.add_bool_or(pos + neg)
    elif name == "array_bool_and":
        b = lit(1)
        lits = [fz.as_lit(v) for v in fz.var_list(args[0])]
        mdl.add_bool_and(lits).only_enforce_if(b)
        mdl.add_bool_or([_neg(x) for x in lits] + [b])
    elif name == "array_bool_or":
        b = lit(1)
        lits = [fz.as_lit(v) for v in fz.var_list(args[0])]
        mdl.add_bool_or(lits).only_enforce_if(b)
        for x in lits:
            mdl.add_implication(x, b)
    elif name == "bool2int":
        mdl.add(expr(0) == expr(1))
    elif name == "set_in" and args[1].strip() not in fz.set_vars:
        dom_tok = args[1].strip()
        rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", dom_tok)
        if rm:
            d = Domain(int(rm.group(1)), int(rm.group(2)))
        else:
            d = Domain.from_values([int(x) for x in
                                    _split_top(dom_tok[1:-1])])
        mdl.add_linear_expression_in_domain(expr(0), d)
    elif name == "table_int":
        exprs = [E(v) for v in fz.var_list(args[0])]
        flat = fz.int_list(args[1])
        k = len(exprs)
        tuples = [tuple(flat[i:i + k]) for i in range(0, len(flat), k)]
        mdl.add_allowed_assignments(exprs, tuples)
    elif name == "set_in_reif" and args[1].strip() not in fz.set_vars:
        b = lit(2)
        dom_tok = args[1].strip()
        rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", dom_tok)
        if rm:
            d = Domain(int(rm.group(1)), int(rm.group(2)))
        else:
            d = Domain.from_values([int(x) for x in
                                    _split_top(dom_tok[1:-1])])
        mdl.add_linear_expression_in_domain(expr(0), d).only_enforce_if(b)
        comp = d.complement()
        mdl.add_linear_expression_in_domain(expr(0), comp) \
            .only_enforce_if(_neg(b))
    elif name in ("array_int_element", "array_var_int_element"):
        # FlatZinc: element(idx, array, target) with 1-based idx
        idx = expr(0) - 1
        arr = [E(v) for v in fz.var_list(args[1])]
        mdl.add_element(idx, arr, expr(2))
    elif name in ("array_bool_element", "array_var_bool_element"):
        idx = expr(0) - 1
        arr = [E(fz.as_lit(v)) if not isinstance(v, (IntVar,))
               else E(v) for v in fz.var_list(args[1])]
        mdl.add_element(idx, arr, expr(2))
    elif name in ("count_eq", "count"):
        arr = [E(v) for v in fz.var_list(args[0])]
        val = expr(1)
        cnt = expr(2)
        bs = []
        for e in arr:
            b = mdl.new_bool_var("")
            mdl.add(e == val).only_enforce_if(b)
            mdl.add(e != val).only_enforce_if(b.negated())
            bs.append(b)
        mdl.add(LinearExpr.sum([E(b) for b in bs]) == cnt)
    elif name in ("fzn_all_different_except_0", "all_different_except_0",
                  "alldifferent_except_0"):
        # pairwise: equal values forbidden unless both are 0
        exprs = [E(v) for v in fz.var_list(args[0])]
        for i in range(len(exprs)):
            for j in range(i + 1, len(exprs)):
                bi = mdl.new_bool_var(f"_ade{i}_{j}a")
                bj = mdl.new_bool_var(f"_ade{i}_{j}b")
                mdl.add(exprs[i] == 0).only_enforce_if(bi)
                mdl.add(exprs[i] != 0).only_enforce_if(_neg(bi))
                mdl.add(exprs[j] == 0).only_enforce_if(bj)
                mdl.add(exprs[j] != 0).only_enforce_if(_neg(bj))
                mdl.add(exprs[i] != exprs[j]).only_enforce_if(
                    [_neg(bi), _neg(bj)])
    elif name in ("fzn_among", "among"):
        # among(n, xs, S): n = #{i : xs[i] in S}
        cnt = expr(0)
        arr = [E(v) for v in fz.var_list(args[1])]
        set_tok = args[2].strip()
        rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", set_tok)
        if rm:
            dom = Domain(int(rm.group(1)), int(rm.group(2)))
        else:
            dom = Domain.from_values([int(x) for x in
                                      _split_top(set_tok[1:-1])])
        bs = []
        for e in arr:
            b = mdl.new_bool_var("")
            mdl.add_linear_expression_in_domain(e, dom).only_enforce_if(b)
            mdl.add_linear_expression_in_domain(
                e, dom.complement()).only_enforce_if(_neg(b))
            bs.append(b)
        mdl.add(LinearExpr.sum([E(b) for b in bs]) == cnt)
    elif name == "bool_xor":
        if len(args) == 3:
            r = lit(2)
            mdl.add(expr(0) + expr(1) == 1).only_enforce_if(r)
            mdl.add(expr(0) == expr(1)).only_enforce_if(_neg(r))
        else:
            mdl.add(expr(0) + expr(1) == 1)
    elif name in ("bool_lin_eq", "bool_lin_le"):
        e = fz.lin(args[0], args[1])
        c = int(V(args[2]))
        mdl.add(e == c) if name == "bool_lin_eq" else mdl.add(e <= c)
    elif name in ("minimum_int", "maximum_int"):
        exprs = [E(v) for v in fz.var_list(args[1])]
        if name == "minimum_int":
            mdl.add_min_equality(expr(0), exprs)
        else:
            mdl.add_max_equality(expr(0), exprs)
    # ---- float builtins: fixed-point at FLOAT_SCALE ---------------------
    elif name == "int2float":
        # f == FLOAT_SCALE * x
        mdl.add(expr(1) == expr(0) * FLOAT_SCALE)
    elif name in ("float_lin_eq", "float_lin_le", "float_lin_ne",
                  "float_lin_eq_reif", "float_lin_le_reif"):
        cs = [float(x) for x in fz.value(args[0])]
        ics, cscale = _int_coeffs(cs)
        vs = fz.var_list(args[1])
        e = LinearExpr.sum([E(v) * c for c, v in zip(ics, vs)])
        # vars live at FLOAT_SCALE, coefficients at cscale: the RHS must
        # scale by both, exactly
        rhs = float(V(args[2]))
        crhs_f = rhs * cscale * FLOAT_SCALE
        crhs = round(crhs_f)
        if abs(crhs - crhs_f) > 1e-6:
            raise FlatZincError(f"float rhs {rhs} not exactly scalable")
        if name == "float_lin_eq":
            mdl.add(e == crhs)
        elif name == "float_lin_le":
            mdl.add(e <= crhs)
        elif name == "float_lin_ne":
            mdl.add(e != crhs)
        else:
            b = lit(3)
            if name == "float_lin_eq_reif":
                mdl.add(e == crhs).only_enforce_if(b)
                mdl.add(e != crhs).only_enforce_if(_neg(b))
            else:
                mdl.add(e <= crhs).only_enforce_if(b)
                mdl.add(e >= crhs + 1).only_enforce_if(_neg(b))
    elif name in ("float_eq", "float_ne", "float_le", "float_lt"):
        a0, a1 = V(args[0]), V(args[1])
        e0 = E(a0) if not isinstance(a0, float) else \
            LinearExpr.of(_scaled_const(a0))
        e1 = E(a1) if not isinstance(a1, float) else \
            LinearExpr.of(_scaled_const(a1))
        if name == "float_eq":
            mdl.add(e0 == e1)
        elif name == "float_ne":
            mdl.add(e0 != e1)
        elif name == "float_le":
            mdl.add(e0 <= e1)
        else:
            mdl.add(e0 <= e1 - 1)
    elif name == "float_plus":
        mdl.add(expr(0) + expr(1) == expr(2))
    elif name == "float_times":
        # z == x*y over reals; in fixed point Z/S = (X/S)(Y/S) => S*Z = X*Y.
        # Exactness is the fixed-point contract (like every float builtin
        # here): products that do not land on the 10^-6 grid are rejected
        # by the solver as infeasible equalities, never silently rounded.
        t_lo, t_hi = _prod_bounds(fz, args[0], args[1])
        t = mdl.new_int_var(t_lo, t_hi, "")
        mdl.add_multiplication_equality(t, [expr(0), expr(1)])
        mdl.add(expr(2) * FLOAT_SCALE == t)
    elif name == "float_div":
        # z == x/y  <=>  z*y == x (y != 0); fixed point: Z*Y == S*X.
        t_lo, t_hi = _prod_bounds(fz, args[2], args[1])
        t = mdl.new_int_var(t_lo, t_hi, "")
        mdl.add_multiplication_equality(t, [expr(2), expr(1)])
        mdl.add(expr(0) * FLOAT_SCALE == t)
        mdl.add(expr(1) != 0)
    elif name == "float_abs":
        mdl.add_abs_equality(expr(1), expr(0))
    elif name == "float_min":
        mdl.add_min_equality(expr(2), [expr(0), expr(1)])
    elif name == "float_max":
        mdl.add_max_equality(expr(2), [expr(0), expr(1)])
    # ---- set-variable builtins (characteristic-vector encoding) ---------
    elif name == "set_card":
        sv = fz.set_var(args[0])
        mdl.add(LinearExpr.sum([E(b) for b in sv.bools]) == expr(1))
    elif name in ("set_in_var", "set_in") and args[1].strip() in fz.set_vars:
        # x in S for a *variable* S: x confined to the universe, and
        # taking value v implies v's membership bool.
        sv = fz.set_var(args[1])
        x = expr(0)
        mdl.add_linear_expression_in_domain(
            x, Domain.from_values(sv.values))
        for v, b in zip(sv.values, sv.bools):
            e = mdl.new_bool_var("")
            mdl.add(x == v).only_enforce_if(e)
            mdl.add(x != v).only_enforce_if(_neg(e))
            mdl.add_implication(e, b)
    elif name == "set_in_reif" and args[1].strip() in fz.set_vars:
        sv = fz.set_var(args[1])
        x, r = expr(0), lit(2)
        ms = []
        for v, b in zip(sv.values, sv.bools):
            e = mdl.new_bool_var("")
            mdl.add(x == v).only_enforce_if(e)
            mdl.add(x != v).only_enforce_if(_neg(e))
            m2 = mdl.new_bool_var("")
            mdl.add_implication(m2, e)
            mdl.add_implication(m2, b)
            mdl.add_bool_or([_neg(e), _neg(b), m2])
            ms.append(m2)
        if ms:
            for m2 in ms:
                mdl.add_implication(m2, r)
            mdl.add_bool_or(ms).only_enforce_if(r)
        else:
            mdl.add_bool_or([_neg(r)])
    elif name in ("set_eq", "set_ne", "set_subset", "set_superset"):
        sa, sb = fz.set_var(args[0]), fz.set_var(args[1])
        union = sorted(set(sa.values) | set(sb.values))
        if name == "set_ne":
            ds = []
            for v in union:
                ba, bb = sa.bool_for(v), sb.bool_for(v)
                d = mdl.new_bool_var("")
                _xor_link(mdl, ba, bb, d)
                ds.append(d)
            mdl.add_bool_or(ds)
        else:
            for v in union:
                ba, bb = sa.bool_for(v), sb.bool_for(v)
                if name == "set_eq":
                    _members_equal(mdl, ba, bb)
                elif name == "set_subset":
                    _member_implies(mdl, ba, bb)
                else:  # superset
                    _member_implies(mdl, bb, ba)
    elif name in ("set_union", "set_intersect", "set_diff", "set_symdiff"):
        sa, sb, sc = (fz.set_var(args[0]), fz.set_var(args[1]),
                      fz.set_var(args[2]))
        union = sorted(set(sa.values) | set(sb.values) | set(sc.values))
        for v in union:
            ba, bb, bc = sa.bool_for(v), sb.bool_for(v), sc.bool_for(v)
            if name == "set_union":
                _ternary_or(mdl, ba, bb, bc)
            elif name == "set_intersect":
                _ternary_and(mdl, ba, bb, bc)
            elif name == "set_diff":
                _ternary_and(mdl, ba, _neg_or_none(mdl, bb), bc)
            else:  # symdiff
                d = mdl.new_bool_var("")
                _xor_link(mdl, ba, bb, d)
                _members_equal(mdl, d, bc)
    else:
        raise FlatZincError(f"unsupported FlatZinc predicate: {name}")


def _prod_bounds(fz: _FzModel, tok_a: str, tok_b: str) -> Tuple[int, int]:
    """Interval bounds for the product of two fixed-point operands."""
    def rng(tok):
        v = fz.value(tok)
        if isinstance(v, IntVar):
            d = fz.model.ir.variables[v.index].domain
            return d.min(), d.max()
        iv = _scaled_const(float(v)) if isinstance(v, float) else int(v)
        return iv, iv
    alo, ahi = rng(tok_a)
    blo, bhi = rng(tok_b)
    cands = [alo * blo, alo * bhi, ahi * blo, ahi * bhi]
    return min(cands), max(cands)


def _members_equal(mdl, ba, bb) -> None:
    """ba == bb where either side may be None (constant false)."""
    if ba is None and bb is None:
        return
    if ba is None:
        mdl.add_bool_or([_neg(bb)])
    elif bb is None:
        mdl.add_bool_or([_neg(ba)])
    else:
        mdl.add_implication(ba, bb)
        mdl.add_implication(bb, ba)


def _member_implies(mdl, ba, bb) -> None:
    """ba -> bb with None = constant false."""
    if ba is None:
        return
    if bb is None:
        mdl.add_bool_or([_neg(ba)])
    else:
        mdl.add_implication(ba, bb)


def _neg_or_none(mdl, b):
    """Negation of a membership bool where None means constant false;
    the result is a literal that is constant TRUE when b is None."""
    if b is None:
        t = mdl.new_bool_var("")
        mdl.add_bool_or([t])
        return t
    return _neg(b)


def _ternary_or(mdl, ba, bb, bc) -> None:
    """bc == (ba or bb), None = false."""
    ins = [b for b in (ba, bb) if b is not None]
    if bc is None:
        for b in ins:
            mdl.add_bool_or([_neg(b)])
        return
    if not ins:
        mdl.add_bool_or([_neg(bc)])
        return
    for b in ins:
        mdl.add_implication(b, bc)
    mdl.add_bool_or(ins).only_enforce_if(bc)


def _ternary_and(mdl, ba, bb, bc) -> None:
    """bc == (ba and bb), None = false."""
    if ba is None or bb is None:
        if bc is not None:
            mdl.add_bool_or([_neg(bc)])
        return
    if bc is None:
        mdl.add_bool_or([_neg(ba), _neg(bb)])
        return
    mdl.add_implication(bc, ba)
    mdl.add_implication(bc, bb)
    mdl.add_bool_or([_neg(ba), _neg(bb), bc])


def _xor_link(mdl, ba, bb, d) -> None:
    """d == (ba xor bb), None = constant false."""
    if ba is None and bb is None:
        mdl.add_bool_or([_neg(d)])
        return
    if ba is None:
        _members_equal(mdl, d, bb)
        return
    if bb is None:
        _members_equal(mdl, d, ba)
        return
    mdl.add_bool_or([_neg(ba), _neg(bb), _neg(d)])
    mdl.add_bool_or([ba, bb, _neg(d)])
    mdl.add_bool_or([ba, _neg(bb), d])
    mdl.add_bool_or([_neg(ba), bb, d])


def _parse_set_const(fz: _FzModel, tok: str) -> List[int]:
    tok = tok.strip()
    rm = re.fullmatch(r"(-?\d+)\s*\.\.\s*(-?\d+)", tok)
    if rm:
        return list(range(int(rm.group(1)), int(rm.group(2)) + 1))
    if tok.startswith("{"):
        inner = tok[1:-1].strip()
        return [int(x) for x in _split_top(inner)] if inner else []
    v = fz.pars.get(tok)
    if isinstance(v, list):
        return [int(x) for x in v]
    raise FlatZincError(f"cannot parse set constant: {tok!r}")


def _neg(lit):
    if isinstance(lit, bool):
        return not lit
    return lit.negated()


def _expr_values(mdl, e) -> set:
    """Candidate value set of a linear expression over the model's
    current variable domains (hull per variable, exact for the common
    affine-of-one-variable case)."""
    coeffs = dict(e._coeffs)
    off = int(e._offset)
    if not coeffs:
        return {off}
    if len(coeffs) == 1:
        (v, c), = coeffs.items()
        d = mdl.ir.variables[v].domain
        if d.max() - d.min() > 100_000:
            raise FlatZincError("nvalue variable domain too wide")
        return {c * x + off
                for x in range(d.min(), d.max() + 1) if d.contains(x)}
    lo = hi = off
    for v, c in coeffs.items():
        d = mdl.ir.variables[v].domain
        lo += min(c * d.min(), c * d.max())
        hi += max(c * d.min(), c * d.max())
    if hi - lo > 100_000:
        raise FlatZincError("nvalue expression range too wide")
    return set(range(lo, hi + 1))


def _scaled_const(x: float) -> int:
    """Exact fixed-point representation; FlatZinc floats are decimal
    literals, so scaling by 10^6 is exact for <= 6 decimals."""
    v = round(x * FLOAT_SCALE)
    if abs(v - x * FLOAT_SCALE) > 1e-6:
        raise FlatZincError(
            f"float constant {x} not representable at scale {FLOAT_SCALE}")
    return int(v)


def _int_coeffs(cs: List[float]) -> Tuple[List[int], int]:
    """Smallest 10^d making every coefficient integral (d <= 9)."""
    for d in range(10):
        scale = 10 ** d
        out = []
        ok = True
        for c in cs:
            v = round(c * scale)
            if abs(v - c * scale) > 1e-9 * max(1.0, abs(c * scale)):
                ok = False
                break
            out.append(int(v))
        if ok:
            return out, scale
    raise FlatZincError(f"float coefficients {cs} need more than 9 decimals")


def _format_output(fz: _FzModel, solver: CpSolver) -> str:
    def fmt(v) -> str:
        val = solver.value(fz.as_expr(v))
        if fz.is_float(v):
            return repr(val / FLOAT_SCALE)
        return str(val)

    lines = []
    for name, item in fz.output_items:
        if isinstance(item, _SetVar):
            members = [str(v) for v, b in zip(item.values, item.bools)
                       if solver.boolean_value(b)]
            lines.append(f"{name} = {{{', '.join(members)}}};")
        elif isinstance(item, list):
            vals = ", ".join(fmt(v) for v in item)
            lines.append(
                f"{name} = array1d(1..{len(item)}, [{vals}]);"
            )
        else:
            lines.append(f"{name} = {fmt(item)};")
    lines.append("----------")
    return "\n".join(lines)


def solve_fzn_text(text: str, max_time_in_seconds: float = 60.0,
                   all_solutions: bool = False, *, device="cuda") -> FzResult:
    device = resolve_device(device)
    fz = parse_fzn(text)
    solver = CpSolver(device=device)
    solver.parameters.max_time_in_seconds = max_time_in_seconds
    outputs: List[str] = []

    if all_solutions and fz.sense == "satisfy":
        solver.parameters.enumerate_all_solutions = True

        class Cb(CpSolverSolutionCallback):
            def on_solution_callback(cb_self):
                pass

        # enumeration prints each; round 1 prints only the last
    status = solver.solve(fz.model)
    if status in (SolveStatus.OPTIMAL, SolveStatus.FEASIBLE):
        out = _format_output(fz, solver)
        if status == SolveStatus.OPTIMAL and fz.sense != "satisfy":
            out += "\n=========="
        obj = (solver.objective_value if fz.sense != "satisfy" else None)
        return FzResult(status, out, obj)
    if status == SolveStatus.INFEASIBLE:
        return FzResult(status, "=====UNSATISFIABLE=====")
    return FzResult(status, "=====UNKNOWN=====")


def solve_flatzinc(path: str, **kw) -> FzResult:
    with open(path) as f:
        return solve_fzn_text(f.read(), **kw)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    device, args = device_option_or_exit(args, "ortools_tpu_torch.flatzinc")
    if not args:
        print("usage: python -m ortools_tpu_torch.flatzinc [--device cuda|cpu] model.fzn")
        return 2
    res = solve_flatzinc(args[0], device=device)
    print(res.text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
