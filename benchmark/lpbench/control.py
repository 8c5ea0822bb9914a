"""The control of a cell's judgement: the same run, one precision below the
configuration's, which the judgement has to find not correct.

- A float64 configuration: the program itself in float32 (its own
  ``PdhgParams.dtype`` path), judged as the float64 cell is.
- A float32 configuration: the program's answers rounded to bfloat16 before
  they are judged (the program has no bfloat16 solve: its bf16 stream
  only runs majors, and every termination test is exact).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

from lpbench.spec import kind, load_cell

BELOW = {"float64": ("program", "float32"), "float32": ("answers", "bfloat16")}


def run_control(root: Path, workload: str, seed: int, seconds: float, device):
    """One control run of ``workload``: (judgement, what was lowered)."""
    import torch

    cell = load_cell(root, workload)
    how, dtype = BELOW[cell.config["params"]["dtype"]]
    mix = kind(cell.bench_dir, cell.traffic["kind"])(cell, seed, device)
    if how == "program":
        mix.params = dataclasses.replace(mix.params, dtype=getattr(torch, dtype))
    mix.setup()
    deadline = time.perf_counter() + seconds
    while True:
        mix.unit()
        if time.perf_counter() >= deadline and mix.at_pass_end():
            break
    mix.release()
    return mix.judge(control=dtype if how == "answers" else ""), f"{how} in {dtype}"
