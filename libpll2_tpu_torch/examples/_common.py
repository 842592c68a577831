"""Shared bootstrap of the demos: the `--device` option and the dtype.

The device is the card unless `--device cpu` is given; with no card the
demo raises and never carries on on the CPU.  The dtype is f64 on the CPU
(the JAX examples' parity path) and, on the card, f32 for the demos that
run the CUDA kernels (large_search, infer_demo) and f64 for the rest, as
the port's Partition defaults.
"""
from __future__ import annotations

import argparse
import re
from typing import Optional, Sequence

import torch

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the shared `--device {cuda,cpu}` option;
    the demo adds its positional arguments."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the demo runs (default: the card)")
    return ap


def setup(ap: argparse.ArgumentParser, argv: Optional[Sequence[str]],
          kernels: bool = False):
    """Parse `argv` (sys.argv[1:] when None).  Returns (args, device,
    dtype); raises when the card was asked for and there is none."""
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this demo runs on the card and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run it on the host CPU")
    dtype = torch.float32 if (kernels and device.type == "cuda") \
        else torch.float64
    return args, device, dtype


def split_numbers(line: str):
    """(the text between the numbers, the numbers) of one printed line:
    two outputs of a demo are compared by both."""
    return NUMBER.split(line), [float(x) for x in NUMBER.findall(line)]
