"""CPLEX LP text format reader/writer.

Capability parity: ``ortools/linear_solver/model_exporter.{h,cc}`` (LP
writer) and ``ortools/lp_data/lp_parser.{h,cc}`` (LP reader), covering the
common sections: Minimize/Maximize, Subject To (incl. ranged rows), Bounds,
General(s)/Binary(ies), End.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram

_INF = math.inf


class LpFormatError(ValueError):
    pass


def write_lp(qp: QuadraticProgram, path: Optional[str] = None) -> str:
    if not qp.is_lp():
        raise LpFormatError("LP writer does not support quadratic objectives")
    n, m = qp.num_variables, qp.num_constraints
    vnames = qp.variable_names or [f"x{j}" for j in range(n)]
    cnames = qp.constraint_names or [f"c{i}" for i in range(m)]

    def term_str(coeffs: Dict[int, float]) -> str:
        parts = []
        for j, v in sorted(coeffs.items()):
            if v == 0:
                continue
            sign = "+" if v >= 0 else "-"
            mag = abs(v)
            parts.append(f"{sign} {mag:.17g} {vnames[j]}")
        if not parts:
            return "0 " + vnames[0] if n else "0"
        out = " ".join(parts)
        return out[2:] if out.startswith("+ ") else out

    lines = ["\\ Generated by ortools_tpu", ""]
    lines.append("Maximize" if qp.maximize else "Minimize")
    obj = {j: float(qp.objective_vector[j]) for j in range(n)
           if qp.objective_vector[j] != 0}
    obj_s = term_str(obj)
    if qp.objective_constant:
        obj_s += f" + {qp.objective_constant:.17g}"
    lines.append(f" obj: {obj_s}")
    lines.append("Subject to")
    csr = sp.csr_matrix(qp.constraint_matrix)
    for i in range(m):
        coeffs = {
            int(csr.indices[k]): float(csr.data[k])
            for k in range(csr.indptr[i], csr.indptr[i + 1])
        }
        lo, hi = qp.constraint_lower[i], qp.constraint_upper[i]
        body = term_str(coeffs)
        if lo == hi:
            lines.append(f" {cnames[i]}: {body} = {lo:.17g}")
        elif math.isfinite(lo) and math.isfinite(hi):
            # ranged: emit two rows
            lines.append(f" {cnames[i]}_l: {body} >= {lo:.17g}")
            lines.append(f" {cnames[i]}_u: {body} <= {hi:.17g}")
        elif math.isfinite(hi):
            lines.append(f" {cnames[i]}: {body} <= {hi:.17g}")
        elif math.isfinite(lo):
            lines.append(f" {cnames[i]}: {body} >= {lo:.17g}")
    lines.append("Bounds")
    for j in range(n):
        lo, hi = qp.variable_lower[j], qp.variable_upper[j]
        if lo == 0 and hi == _INF:
            continue  # default
        if lo == -_INF and hi == _INF:
            lines.append(f" {vnames[j]} free")
        elif lo == hi:
            lines.append(f" {vnames[j]} = {lo:.17g}")
        else:
            lo_s = "-inf" if lo == -_INF else f"{lo:.17g}"
            hi_s = "+inf" if hi == _INF else f"{hi:.17g}"
            lines.append(f" {lo_s} <= {vnames[j]} <= {hi_s}")
    if qp.integrality is not None and np.any(qp.integrality):
        gen = [vnames[j] for j in range(n)
               if qp.integrality[j] and not (
                   qp.variable_lower[j] == 0 and qp.variable_upper[j] == 1)]
        bins = [vnames[j] for j in range(n)
                if qp.integrality[j]
                and qp.variable_lower[j] == 0 and qp.variable_upper[j] == 1]
        if gen:
            lines.append("Generals")
            lines.append(" " + " ".join(gen))
        if bins:
            lines.append("Binaries")
            lines.append(" " + " ".join(bins))
    lines.append("End")
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


_NUM = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[+-]?inf(?:inity)?"
_TERM_RE = re.compile(rf"([+-]?)\s*({_NUM})?\s*\*?\s*([A-Za-z_][\w.\[\]]*)")


def _parse_expr(text: str, var_id) -> Tuple[Dict[int, float], float]:
    coeffs: Dict[int, float] = {}
    const = 0.0
    pos = 0
    text = text.strip()
    while pos < len(text):
        mm = _TERM_RE.match(text, pos)
        if mm:
            sign_s, num_s, name = mm.groups()
            sign = -1.0 if sign_s == "-" else 1.0
            coeff = float(num_s) if num_s else 1.0
            j = var_id(name)
            coeffs[j] = coeffs.get(j, 0.0) + sign * coeff
            pos = mm.end()
        else:
            cm = re.match(rf"([+-]?)\s*({_NUM})", text[pos:])
            if cm:
                sign = -1.0 if cm.group(1) == "-" else 1.0
                const += sign * float(cm.group(2))
                pos += cm.end()
            else:
                raise LpFormatError(f"cannot parse term at: {text[pos:]!r}")
        while pos < len(text) and text[pos] in " \t":
            pos += 1
    return coeffs, const


def read_lp(path_or_text: str, is_text: bool = False) -> QuadraticProgram:
    text = path_or_text if is_text else open(path_or_text).read()
    text = re.sub(r"\\[^\n]*", "", text)  # comments
    # tokenize into sections
    sec_re = re.compile(
        r"^\s*(minimize|maximize|min|max|subject to|such that|st|s\.t\.|"
        r"bounds|generals?|binar(?:y|ies)|integers?|end)\s*:?\s*$",
        re.I | re.M,
    )
    splits = list(sec_re.finditer(text))
    if not splits:
        raise LpFormatError("no LP sections found")
    sections: List[Tuple[str, str]] = []
    for k, mm in enumerate(splits):
        name = mm.group(1).lower()
        body = text[mm.end(): splits[k + 1].start() if k + 1 < len(splits)
                    else len(text)]
        sections.append((name, body))

    var_index: Dict[str, int] = {}
    var_order: List[str] = []

    def var_id(name: str) -> int:
        if name not in var_index:
            var_index[name] = len(var_order)
            var_order.append(name)
        return var_index[name]

    maximize = False
    obj: Dict[int, float] = {}
    obj_const = 0.0
    rows: List[Tuple[str, Dict[int, float], str, float]] = []
    bounds_lines: List[str] = []
    integer_names: List[str] = []
    binary_names: List[str] = []

    for name, body in sections:
        if name in ("minimize", "maximize", "min", "max"):
            maximize = name.startswith("max")
            body = body.strip()
            if ":" in body.split("\n")[0] and re.match(
                r"^\s*[\w.]+\s*:", body
            ):
                body = body.split(":", 1)[1]
            body = " ".join(body.split())
            if body:
                obj, obj_const = _parse_expr(body, var_id)
        elif name in ("subject to", "such that", "st", "s.t."):
            # constraints may span lines; a new constraint starts at
            # "name:" or when the prior one is complete
            chunks = re.split(r"\n(?=\s*[\w.\[\]]+\s*:)", body)
            for chunk in chunks:
                chunk = " ".join(chunk.split())
                if not chunk:
                    continue
                cname = ""
                if re.match(r"^[\w.\[\]]+\s*:", chunk):
                    cname, chunk = chunk.split(":", 1)
                    cname = cname.strip()
                mm = re.match(
                    rf"(.*?)(<=|>=|=|<|>)\s*({_NUM})\s*$", chunk.strip()
                )
                if not mm:
                    raise LpFormatError(f"bad constraint: {chunk!r}")
                lhs, op, rhs = mm.groups()
                coeffs, const = _parse_expr(lhs, var_id)
                rows.append((cname, coeffs, op, float(rhs) - const))
        elif name == "bounds":
            bounds_lines.extend(
                ln.strip() for ln in body.splitlines() if ln.strip()
            )
        elif name in ("generals", "general", "integers", "integer"):
            integer_names.extend(body.split())
        elif name in ("binary", "binaries"):
            binary_names.extend(body.split())
        elif name == "end":
            pass

    n = len(var_order)
    m = len(rows)
    r_idx, c_idx, vals = [], [], []
    cl = np.full(m, -_INF)
    cu = np.full(m, _INF)
    cnames = []
    for i, (cname, coeffs, op, rhs) in enumerate(rows):
        cnames.append(cname or f"c{i}")
        for j, v in coeffs.items():
            r_idx.append(i)
            c_idx.append(j)
            vals.append(v)
        if op in ("<=", "<"):
            cu[i] = rhs
        elif op in (">=", ">"):
            cl[i] = rhs
        else:
            cl[i] = cu[i] = rhs
    def parse_bound_num(s):
        s = s.strip().lower()
        if s in ("inf", "+inf", "infinity", "+infinity"):
            return _INF
        if s in ("-inf", "-infinity"):
            return -_INF
        return float(s)

    # bounds recorded by name first (Bounds may mention new variables)
    bound_updates: Dict[int, Tuple[Optional[float], Optional[float]]] = {}

    def upd(j, lo=None, hi=None):
        cur = bound_updates.get(j, (None, None))
        bound_updates[j] = (lo if lo is not None else cur[0],
                            hi if hi is not None else cur[1])

    for ln in bounds_lines:
        ln_clean = " ".join(ln.split())
        mfree = re.fullmatch(r"([\w.\[\]]+)\s+free", ln_clean, re.I)
        if mfree:
            upd(var_id(mfree.group(1)), -_INF, _INF)
            continue
        m2 = re.fullmatch(
            rf"({_NUM})\s*<=\s*([\w.\[\]]+)\s*<=\s*({_NUM})", ln_clean
        )
        if m2:
            upd(var_id(m2.group(2)), parse_bound_num(m2.group(1)),
                parse_bound_num(m2.group(3)))
            continue
        m3 = re.fullmatch(rf"([\w.\[\]]+)\s*(<=|>=|=)\s*({_NUM})", ln_clean)
        if m3:
            j = var_id(m3.group(1))
            v = parse_bound_num(m3.group(3))
            if m3.group(2) == "<=":
                upd(j, hi=v)
            elif m3.group(2) == ">=":
                upd(j, lo=v)
            else:
                upd(j, v, v)
            continue
        m4 = re.fullmatch(rf"({_NUM})\s*<=\s*([\w.\[\]]+)", ln_clean)
        if m4:
            upd(var_id(m4.group(2)), lo=parse_bound_num(m4.group(1)))
            continue
        raise LpFormatError(f"bad bounds line: {ln!r}")

    int_ids = [var_id(nm) for nm in integer_names]
    bin_ids = [var_id(nm) for nm in binary_names]
    n = len(var_order)  # final count after Bounds/Generals/Binaries
    lb = np.zeros(n)
    ub = np.full(n, _INF)
    for j, (lo, hi) in bound_updates.items():
        if lo is not None:
            lb[j] = lo
        if hi is not None:
            ub[j] = hi
    integrality = np.zeros(n, dtype=bool)
    for j in int_ids:
        integrality[j] = True
    for j in bin_ids:
        integrality[j] = True
        lb[j] = max(lb[j], 0.0)
        ub[j] = min(ub[j], 1.0)
    cvec = np.zeros(n)
    for j, v in obj.items():
        cvec[j] = v
    a = sp.csr_matrix(
        (np.asarray(vals), (np.asarray(r_idx, dtype=np.int64),
                            np.asarray(c_idx, dtype=np.int64))),
        shape=(m, n),
    )
    return QuadraticProgram(
        objective_vector=cvec,
        constraint_matrix=a,
        constraint_lower=cl,
        constraint_upper=cu,
        variable_lower=lb,
        variable_upper=ub,
        objective_constant=obj_const,
        maximize=maximize,
        integrality=integrality,
        variable_names=list(var_order),
        constraint_names=cnames,
    )
