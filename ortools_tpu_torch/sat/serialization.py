"""CP model serialization (JSON).

Capability parity: the reference's protobuf model exchange
(CpModelProto text/binary round trips, used for model dumping/replay via
--cp_model_dump_models, cp_model_solver.cc:120).  The IR is dataclasses,
so the wire format here is JSON with the same field structure.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.utils.domain import Domain

_ARGS_TYPES = {
    "bool_or": ir.BoolArgs, "bool_and": ir.BoolArgs,
    "at_most_one": ir.BoolArgs, "exactly_one": ir.BoolArgs,
    "bool_xor": ir.BoolArgs,
    "linear": ir.LinearArgs, "all_diff": ir.AllDiffArgs,
    "lin_max": ir.LinMaxArgs, "int_prod": ir.IntProdArgs,
    "int_div": ir.IntDivArgs, "int_mod": ir.IntModArgs,
    "element": ir.ElementArgs, "table": ir.TableArgs,
    "interval": ir.IntervalArgs, "no_overlap": ir.NoOverlapArgs,
    "cumulative": ir.CumulativeArgs, "circuit": ir.CircuitArgs,
    "inverse": ir.InverseArgs, "automaton": ir.AutomatonArgs,
    "reservoir": ir.ReservoirArgs, "no_overlap_2d": ir.NoOverlap2DArgs,
}


def _encode(obj: Any) -> Any:
    if isinstance(obj, Domain):
        return {"__domain__": obj.flattened_intervals()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _encode(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def model_to_json(model: ir.CpModelIR, indent: int | None = None) -> str:
    doc = {
        "name": model.name,
        "variables": [
            {"name": v.name, "domain": v.domain.flattened_intervals()}
            for v in model.variables
        ],
        "constraints": [
            {
                "kind": ct.kind,
                "name": ct.name,
                "enforcement_literals": list(ct.enforcement_literals),
                "args": _encode_args(ct),
            }
            for ct in model.constraints
        ],
        "objective": (
            None if model.objective is None else {
                "vars": list(model.objective.vars),
                "coeffs": list(model.objective.coeffs),
                "offset": model.objective.offset,
                "maximize": model.objective.maximize,
            }
        ),
        "search_strategies": [
            dataclasses.asdict(s) for s in model.search_strategies
        ],
        "solution_hint": [list(h) for h in model.solution_hint],
        "assumptions": list(model.assumptions),
    }
    return json.dumps(doc, indent=indent)


def _encode_args(ct: ir.ConstraintIR) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(ct.args):
        v = getattr(ct.args, f.name)
        if isinstance(v, Domain):
            out[f.name] = {"__domain__": v.flattened_intervals()}
        elif isinstance(v, list) and v and isinstance(v[0], ir.LinearExprIR):
            out[f.name] = [dataclasses.asdict(e) for e in v]
        elif isinstance(v, ir.LinearExprIR):
            out[f.name] = dataclasses.asdict(v)
        elif isinstance(v, list) and v and isinstance(v[0], tuple):
            out[f.name] = [list(t) for t in v]
        else:
            out[f.name] = v
    return out


def _decode_expr(d: Dict[str, Any]) -> ir.LinearExprIR:
    return ir.LinearExprIR(list(d["vars"]), list(d["coeffs"]),
                           int(d.get("offset", 0)))


def model_from_json(text: str) -> ir.CpModelIR:
    doc = json.loads(text)
    model = ir.CpModelIR(name=doc.get("name", ""))
    for v in doc["variables"]:
        model.variables.append(ir.IntegerVariableIR(
            v["name"], Domain.from_flat_intervals(v["domain"])
        ))
    for c in doc["constraints"]:
        kind = c["kind"]
        args_cls = _ARGS_TYPES[kind]
        raw = dict(c["args"])
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(args_cls):
            v = raw.get(f.name)
            if isinstance(v, dict) and "__domain__" in v:
                kwargs[f.name] = Domain.from_flat_intervals(v["__domain__"])
            elif isinstance(v, dict) and "vars" in v and "coeffs" in v:
                kwargs[f.name] = _decode_expr(v)
            elif (isinstance(v, list) and v and isinstance(v[0], dict)
                  and "vars" in v[0]):
                kwargs[f.name] = [_decode_expr(e) for e in v]
            elif kind == "table" and f.name == "values":
                kwargs[f.name] = [tuple(t) for t in v]
            else:
                kwargs[f.name] = v
        model.constraints.append(ir.ConstraintIR(
            kind, args_cls(**kwargs),
            enforcement_literals=list(c.get("enforcement_literals", [])),
            name=c.get("name", ""),
        ))
    if doc.get("objective"):
        o = doc["objective"]
        model.objective = ir.ObjectiveIR(
            list(o["vars"]), list(o["coeffs"]), int(o["offset"]),
            bool(o["maximize"]),
        )
    for s in doc.get("search_strategies", []):
        model.search_strategies.append(ir.DecisionStrategyIR(**s))
    model.solution_hint = [tuple(h) for h in doc.get("solution_hint", [])]
    model.assumptions = list(doc.get("assumptions", []))
    return model
