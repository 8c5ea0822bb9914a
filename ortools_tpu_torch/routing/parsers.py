"""Routing benchmark-format parsers.

Capability parity: ``ortools/routing`` parsers (tsplib_parser.{h,cc},
solomon_parser) — TSPLIB (EUC_2D / explicit matrices) and Solomon VRPTW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TsplibInstance:
    name: str
    dimension: int
    edge_weight_type: str
    coords: Optional[np.ndarray]  # [n, 2] or None
    matrix: np.ndarray  # [n, n] int64 distances

    def distance(self, i: int, j: int) -> int:
        return int(self.matrix[i, j])


def _euc_2d(coords: np.ndarray) -> np.ndarray:
    d = coords[:, None, :] - coords[None, :, :]
    return np.round(np.sqrt((d * d).sum(-1))).astype(np.int64)


def _att(coords: np.ndarray) -> np.ndarray:
    d = coords[:, None, :] - coords[None, :, :]
    r = np.sqrt((d * d).sum(-1) / 10.0)
    t = np.round(r)
    return np.where(t < r, t + 1, t).astype(np.int64)


def _geo(coords: np.ndarray) -> np.ndarray:
    # TSPLIB GEO convention
    deg = np.floor(coords)
    minute = coords - deg
    rad = math.pi * (deg + 5.0 * minute / 3.0) / 180.0
    lat, lon = rad[:, 0], rad[:, 1]
    rrr = 6378.388
    q1 = np.cos(lon[:, None] - lon[None, :])
    q2 = np.cos(lat[:, None] - lat[None, :])
    q3 = np.cos(lat[:, None] + lat[None, :])
    return (rrr * np.arccos(
        np.clip(0.5 * ((1.0 + q1) * q2 - (1.0 - q1) * q3), -1, 1)
    ) + 1.0).astype(np.int64)


def parse_tsplib(path_or_text: str, is_text: bool = False) -> TsplibInstance:
    text = path_or_text if is_text else open(path_or_text).read()
    lines = [ln.strip() for ln in text.splitlines()]
    header: Dict[str, str] = {}
    i = 0
    coords = None
    ewt = ""
    ew_format = ""
    dim = 0
    matrix = None
    name = ""
    while i < len(lines):
        ln = lines[i]
        i += 1
        if not ln or ln == "EOF":
            continue
        if ":" in ln and not ln.split(":")[0].strip().isdigit():
            key, _, val = ln.partition(":")
            key = key.strip().upper()
            val = val.strip()
            header[key] = val
            if key == "NAME":
                name = val
            elif key == "DIMENSION":
                dim = int(val)
            elif key == "EDGE_WEIGHT_TYPE":
                ewt = val.upper()
            elif key == "EDGE_WEIGHT_FORMAT":
                ew_format = val.upper()
            continue
        section = ln.split()[0].upper()
        if section == "NODE_COORD_SECTION":
            coords = np.zeros((dim, 2))
            for k in range(dim):
                parts = lines[i].split()
                i += 1
                idx = int(parts[0]) - 1
                coords[idx] = [float(parts[1]), float(parts[2])]
        elif section == "EDGE_WEIGHT_SECTION":
            vals: List[float] = []
            while i < len(lines) and lines[i] and lines[i] != "EOF" and \
                    not lines[i][0].isalpha():
                vals.extend(float(x) for x in lines[i].split())
                i += 1
            matrix = _explicit_matrix(vals, dim, ew_format)
        elif section in ("DISPLAY_DATA_SECTION", "DEPOT_SECTION",
                         "DEMAND_SECTION", "TOUR_SECTION"):
            # skip unrelated sections
            while i < len(lines) and lines[i] and lines[i] != "EOF" and \
                    lines[i] != "-1" and not lines[i][0].isalpha():
                i += 1
    if matrix is None:
        assert coords is not None, "no coords and no explicit matrix"
        if ewt == "EUC_2D":
            matrix = _euc_2d(coords)
        elif ewt == "ATT":
            matrix = _att(coords)
        elif ewt == "GEO":
            matrix = _geo(coords)
        elif ewt == "CEIL_2D":
            d = coords[:, None, :] - coords[None, :, :]
            matrix = np.ceil(np.sqrt((d * d).sum(-1))).astype(np.int64)
        else:
            raise ValueError(f"unsupported EDGE_WEIGHT_TYPE {ewt!r}")
    return TsplibInstance(name, dim, ewt, coords, matrix)


def _explicit_matrix(vals: List[float], dim: int, fmt: str) -> np.ndarray:
    m = np.zeros((dim, dim), dtype=np.int64)
    it = iter(vals)
    if fmt == "FULL_MATRIX":
        for r in range(dim):
            for c in range(dim):
                m[r, c] = int(next(it))
    elif fmt in ("UPPER_ROW", "UPPER_DIAG_ROW"):
        diag = fmt == "UPPER_DIAG_ROW"
        for r in range(dim):
            for c in range(r if diag else r + 1, dim):
                v = int(next(it))
                m[r, c] = m[c, r] = v
    elif fmt in ("LOWER_ROW", "LOWER_DIAG_ROW"):
        diag = fmt == "LOWER_DIAG_ROW"
        for r in range(dim):
            for c in range(0, r + 1 if diag else r):
                v = int(next(it))
                m[r, c] = m[c, r] = v
    else:
        raise ValueError(f"unsupported EDGE_WEIGHT_FORMAT {fmt!r}")
    return m


@dataclasses.dataclass
class SolomonInstance:
    name: str
    num_vehicles: int
    capacity: int
    coords: np.ndarray  # [n, 2], node 0 is the depot
    demands: np.ndarray
    ready_times: np.ndarray
    due_times: np.ndarray
    service_times: np.ndarray

    def distance_matrix(self, scale: int = 1) -> np.ndarray:
        d = self.coords[:, None, :] - self.coords[None, :, :]
        return np.round(np.sqrt((d * d).sum(-1)) * scale).astype(np.int64)


def parse_solomon(path_or_text: str, is_text: bool = False) -> SolomonInstance:
    text = path_or_text if is_text else open(path_or_text).read()
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    name = lines[0].strip()
    # find VEHICLE section
    rows = []
    num_vehicles = capacity = 0
    i = 1
    while i < len(lines):
        ln = lines[i].strip().upper()
        if ln.startswith("VEHICLE"):
            i += 2  # skip "NUMBER CAPACITY" header
            parts = lines[i].split()
            num_vehicles, capacity = int(parts[0]), int(parts[1])
        elif ln.startswith("CUSTOMER"):
            i += 2  # skip column header
            while i < len(lines):
                parts = lines[i].split()
                if len(parts) >= 7:
                    rows.append([float(x) for x in parts[:7]])
                i += 1
            break
        i += 1
    arr = np.asarray(rows)
    order = np.argsort(arr[:, 0])
    arr = arr[order]
    return SolomonInstance(
        name=name,
        num_vehicles=num_vehicles,
        capacity=capacity,
        coords=arr[:, 1:3],
        demands=arr[:, 3].astype(np.int64),
        ready_times=arr[:, 4].astype(np.int64),
        due_times=arr[:, 5].astype(np.int64),
        service_times=arr[:, 6].astype(np.int64),
    )
