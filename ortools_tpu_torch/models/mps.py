"""MPS format reader/writer (free-form and fixed-form).

Capability parity: ``ortools/lp_data/mps_reader_template.h:503`` (templated
MPS parser used by glop, pdlp and both MIP front-ends) and
``ortools/linear_solver/model_exporter.{h,cc}`` (MPS writer).

Supported sections: NAME, OBJSENSE (MAX/MIN), ROWS (N/L/G/E), COLUMNS with
INTORG/INTEND integrality markers, RHS (incl. objective-row entry giving a
negated objective constant), RANGES, BOUNDS (UP LO FX FR MI PL BV UI LI).
SOS sections are rejected with a clear error (reference behavior: optional).
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from ortools_tpu_torch.models.lp import QuadraticProgram

_INF = math.inf


class MpsError(ValueError):
    pass


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mps(path_or_text: str, is_text: bool = False) -> QuadraticProgram:
    """Parse an MPS file (or raw text with is_text=True) into a
    QuadraticProgram."""
    if is_text:
        lines = path_or_text.splitlines()
    else:
        with _open(path_or_text) as f:
            lines = f.read().splitlines()

    name = ""
    maximize = False
    row_types: Dict[str, str] = {}
    row_order: List[str] = []
    obj_row: Optional[str] = None
    ignored_free_rows: set = set()
    # per-column entries
    col_order: List[str] = []
    col_index: Dict[str, int] = {}
    col_integrality: List[bool] = []
    obj_coeffs: Dict[int, float] = {}
    entries_r: List[int] = []
    entries_c: List[int] = []
    entries_v: List[float] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    lower: Dict[int, float] = {}
    upper: Dict[int, float] = {}
    obj_constant = 0.0

    section = None
    in_integer_block = False

    def col_id(cname: str) -> int:
        if cname not in col_index:
            col_index[cname] = len(col_order)
            col_order.append(cname)
            col_integrality.append(False)
        return col_index[cname]

    i = 0
    n_lines = len(lines)
    while i < n_lines:
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        # Section headers start in column 1 (no leading whitespace).
        if raw[0] not in (" ", "\t"):
            fields = raw.split()
            head = fields[0].upper()
            if head == "NAME":
                name = fields[1] if len(fields) > 1 else ""
                section = "NAME"
            elif head in ("OBJSENSE", "OBJSENSE:"):
                section = "OBJSENSE"
                if len(fields) > 1:
                    maximize = fields[1].upper().startswith("MAX")
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "ENDATA"):
                section = head
                if head == "ENDATA":
                    break
            elif head in ("SOS", "QUADOBJ", "QMATRIX", "QSECTION", "CSECTION",
                          "INDICATORS", "OBJECT"):
                raise MpsError(f"MPS section {head} not supported")
            else:
                raise MpsError(f"unknown MPS section header: {raw!r}")
            continue

        fields = raw.split()
        if section == "OBJSENSE":
            maximize = fields[0].upper().startswith("MAX")
        elif section == "ROWS":
            rtype = fields[0].upper()
            rname = fields[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                else:
                    # extra free rows are ignored (reference behavior)
                    ignored_free_rows.add(rname)
            elif rtype in ("L", "G", "E"):
                if rname in row_types:
                    raise MpsError(f"duplicate row {rname}")
                row_types[rname] = rtype
                row_order.append(rname)
            else:
                raise MpsError(f"bad row type {rtype!r}")
        elif section == "COLUMNS":
            if len(fields) >= 3 and fields[1].upper() == "'MARKER'":
                marker = fields[2].upper()
                if marker == "'INTORG'":
                    in_integer_block = True
                elif marker == "'INTEND'":
                    in_integer_block = False
                continue
            cname = fields[0]
            c = col_id(cname)
            if in_integer_block:
                col_integrality[c] = True
            pairs = fields[1:]
            if len(pairs) % 2 != 0:
                raise MpsError(f"odd COLUMNS entry: {raw!r}")
            for j in range(0, len(pairs), 2):
                rname, val = pairs[j], float(pairs[j + 1])
                if rname == obj_row:
                    obj_coeffs[c] = obj_coeffs.get(c, 0.0) + val
                elif rname in row_types:
                    entries_r.append(_row_idx(row_order, rname))
                    entries_c.append(c)
                    entries_v.append(val)
                elif rname in ignored_free_rows:
                    pass
                else:
                    raise MpsError(f"unknown row {rname!r} in COLUMNS")
        elif section == "RHS":
            pairs = fields[1:] if len(fields) % 2 == 1 else fields
            # RHS lines are "rhsname row val [row val]"; some files omit the
            # set name — detect by whether fields[0] is a known row.
            if fields[0] in row_types or fields[0] == obj_row:
                pairs = fields
            for j in range(0, len(pairs), 2):
                rname, val = pairs[j], float(pairs[j + 1])
                if rname == obj_row:
                    obj_constant = -val
                elif rname in row_types:
                    rhs[rname] = val
                elif rname in ignored_free_rows:
                    pass
                else:
                    raise MpsError(f"unknown row {rname!r} in RHS")
        elif section == "RANGES":
            pairs = fields[1:] if len(fields) % 2 == 1 else fields
            if fields[0] in row_types:
                pairs = fields
            for j in range(0, len(pairs), 2):
                rname, val = pairs[j], float(pairs[j + 1])
                if rname not in row_types:
                    raise MpsError(f"unknown row {rname!r} in RANGES")
                ranges[rname] = val
        elif section == "BOUNDS":
            btype = fields[0].upper()
            # "BTYPE bndname col [val]" — bound-set name may be omitted.
            if len(fields) >= 3 and fields[2] not in col_index and fields[1] in col_index:
                cname = fields[1]
                val = float(fields[2]) if len(fields) > 2 else 0.0
            elif len(fields) >= 3:
                cname = fields[2]
                val = float(fields[3]) if len(fields) > 3 else 0.0
            else:
                cname = fields[1]
                val = 0.0
            c = col_id(cname)
            if btype == "UP":
                upper[c] = val
                if val < 0 and c not in lower:
                    lower[c] = -_INF
            elif btype == "LO":
                lower[c] = val
            elif btype == "FX":
                lower[c] = val
                upper[c] = val
            elif btype == "FR":
                lower[c] = -_INF
                upper[c] = _INF
            elif btype == "MI":
                lower[c] = -_INF
            elif btype == "PL":
                upper[c] = _INF
            elif btype == "BV":
                lower[c] = 0.0
                upper[c] = 1.0
                col_integrality[c] = True
            elif btype == "UI":
                upper[c] = val
                col_integrality[c] = True
            elif btype == "LI":
                lower[c] = val
                col_integrality[c] = True
            else:
                raise MpsError(f"bad bound type {btype!r}")
        elif section in ("NAME", None):
            continue
        else:
            raise MpsError(f"data line outside known section: {raw!r}")

    m, n = len(row_order), len(col_order)
    a = sp.csr_matrix(
        (np.asarray(entries_v, dtype=np.float64),
         (np.asarray(entries_r, dtype=np.int64), np.asarray(entries_c, dtype=np.int64))),
        shape=(m, n),
    )
    a.sum_duplicates()
    c_lo = np.full(m, -_INF)
    c_hi = np.full(m, _INF)
    for k, rname in enumerate(row_order):
        rtype = row_types[rname]
        b = rhs.get(rname, 0.0)
        if rtype == "L":
            c_hi[k] = b
        elif rtype == "G":
            c_lo[k] = b
        else:  # E
            c_lo[k] = b
            c_hi[k] = b
        if rname in ranges:
            r = ranges[rname]
            if rtype == "L":
                c_lo[k] = b - abs(r)
            elif rtype == "G":
                c_hi[k] = b + abs(r)
            else:
                if r >= 0:
                    c_hi[k] = b + r
                else:
                    c_lo[k] = b + r

    v_lo = np.zeros(n)
    v_hi = np.full(n, _INF)
    for c, v in lower.items():
        v_lo[c] = v
    for c, v in upper.items():
        v_hi[c] = v
    obj = np.zeros(n)
    for c, v in obj_coeffs.items():
        obj[c] = v

    qp = QuadraticProgram(
        objective_vector=obj,
        constraint_matrix=a,
        constraint_lower=c_lo,
        constraint_upper=c_hi,
        variable_lower=v_lo,
        variable_upper=v_hi,
        objective_constant=obj_constant,
        maximize=maximize,
        integrality=np.asarray(col_integrality, dtype=bool),
        variable_names=col_order,
        constraint_names=row_order,
        name=name,
    )
    return qp


# Cache row name -> index mapping (row_order.index would be O(m) per entry).
def _row_idx(row_order: List[str], rname: str, _cache: Dict[int, Dict[str, int]] = {}) -> int:
    key = id(row_order)
    d = _cache.get(key)
    if d is None or len(d) != len(row_order):
        d = {nm: i for i, nm in enumerate(row_order)}
        _cache.clear()
        _cache[key] = d
    return d[rname]


def write_mps(qp: QuadraticProgram, path: Optional[str] = None) -> str:
    """Serialize a QuadraticProgram to free-form MPS text.  Returns the text;
    writes to ``path`` if given.  (Maximization is written via OBJSENSE.)"""
    if not qp.is_lp():
        raise MpsError("MPS writer does not support quadratic objectives yet")
    m, n = qp.num_constraints, qp.num_variables
    rnames = qp.constraint_names or [f"R{i}" for i in range(m)]
    cnames = qp.variable_names or [f"C{j}" for j in range(n)]
    out: List[str] = [f"NAME {qp.name or 'ortools_tpu_model'}"]
    if qp.maximize:
        out.append("OBJSENSE\n    MAX")
    out.append("ROWS")
    out.append(" N  OBJ")
    row_type = []
    for i in range(m):
        lo, hi = qp.constraint_lower[i], qp.constraint_upper[i]
        if lo == hi:
            t = "E"
        elif hi < _INF and lo > -_INF:
            t = "L"  # two-sided -> L with RANGES
        elif hi < _INF:
            t = "L"
        else:
            t = "G"
        row_type.append(t)
        out.append(f" {t}  {rnames[i]}")
    out.append("COLUMNS")
    obj = qp.objective_vector
    csc = sp.csc_matrix(qp.constraint_matrix)
    in_int = False
    marker = 0
    for j in range(n):
        is_int = bool(qp.integrality is not None and qp.integrality[j])
        if is_int and not in_int:
            out.append(f"    MARKER{marker}  'MARKER'  'INTORG'")
            marker += 1
            in_int = True
        elif not is_int and in_int:
            out.append(f"    MARKER{marker}  'MARKER'  'INTEND'")
            marker += 1
            in_int = False
        if obj[j] != 0.0:
            out.append(f"    {cnames[j]}  OBJ  {obj[j]:.17g}")
        for k in range(csc.indptr[j], csc.indptr[j + 1]):
            out.append(f"    {cnames[j]}  {rnames[csc.indices[k]]}  {csc.data[k]:.17g}")
    if in_int:
        out.append(f"    MARKER{marker}  'MARKER'  'INTEND'")
    out.append("RHS")
    const = qp.objective_constant
    if const != 0.0:
        out.append(f"    RHS  OBJ  {-const:.17g}")
    for i in range(m):
        b = qp.constraint_upper[i] if row_type[i] in ("L", "E") else qp.constraint_lower[i]
        if row_type[i] == "E":
            b = qp.constraint_lower[i]
        if b != 0.0 and np.isfinite(b):
            out.append(f"    RHS  {rnames[i]}  {b:.17g}")
    rng_lines = []
    for i in range(m):
        lo, hi = qp.constraint_lower[i], qp.constraint_upper[i]
        if row_type[i] == "L" and lo > -_INF and lo != hi:
            rng_lines.append(f"    RNG  {rnames[i]}  {hi - lo:.17g}")
    if rng_lines:
        out.append("RANGES")
        out.extend(rng_lines)
    out.append("BOUNDS")
    for j in range(n):
        lo, hi = qp.variable_lower[j], qp.variable_upper[j]
        if lo == hi:
            out.append(f" FX BND  {cnames[j]}  {lo:.17g}")
            continue
        if lo == -_INF and hi == _INF:
            out.append(f" FR BND  {cnames[j]}")
            continue
        if lo == -_INF:
            out.append(f" MI BND  {cnames[j]}")
        elif lo != 0.0:
            out.append(f" LO BND  {cnames[j]}  {lo:.17g}")
        if hi < _INF:
            out.append(f" UP BND  {cnames[j]}  {hi:.17g}")
    out.append("ENDATA")
    text = "\n".join(out) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
