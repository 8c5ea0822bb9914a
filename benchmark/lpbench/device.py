"""The card a run measures on, and the check that the program loaded no
JAX."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ortools_tpu")


def forbidden_modules(names) -> list:
    """Module names whose top-level name (the part before the first dot)
    is, whole, one of ``FORBIDDEN``: ``ortools_tpu.x`` is, and
    ``ortools_tpu_torch.x`` is not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> list:
    return forbidden_modules(list(sys.modules))


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
