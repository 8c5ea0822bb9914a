"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never the CPU in its place."""

from __future__ import annotations

import argparse
import sys

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def resolve_device_or_exit(device, prog: str) -> torch.device:
    """``resolve_device`` for a command line: where it raises, print its
    message to stderr and exit with code 2."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def device_option_or_exit(args, prog: str):
    """Take ``--device cuda|cpu`` (default ``cuda``) out of a command
    line's ``args``: ``(resolve_device_or_exit(device, prog), the other
    args)``."""
    p = argparse.ArgumentParser(prog=prog, add_help=False)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns, rest = p.parse_known_args(args)
    return resolve_device_or_exit(ns.device, prog), rest


def lp_dtype(device: torch.device) -> torch.dtype:
    """The LP dtype of the front end's routes on ``device``: float64 where
    the backend supports it (the CPU), float32 on the card, the JAX
    package's x64 rule."""
    return torch.float64 if device.type == "cpu" else torch.float32
