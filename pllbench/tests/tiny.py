"""Runs of the benchmark's cells at sizes a CPU test can hold: the cell's
configuration and traffic from BENCHMARK.json with fewer taxa and sites,
driven by run.execute on the CPU (the program's plain paths)."""
from __future__ import annotations

from pathlib import Path

import torch

from pllbench import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
SIZES = {"dna_eval": (16, 256), "protein_eval": (8, 128),
         "dna_search": (12, 128)}
TRAFFIC = {"dna_eval": {"warmup_calls": 2, "trace_calls": 4},
           "protein_eval": {"warmup_calls": 2, "trace_calls": 4},
           "dna_search": {"warmup_rounds": 1, "trace_rounds": 2}}


def cell(workload: str, tips: int = None, sites: int = None):
    """(cell, config, traffic, limits, e2e, layer) at a test size."""
    torch.set_num_threads(1)
    cell_, config, traffic, limits, e2e, layer = run.load_cell(ROOT, workload)
    small_tips, small_sites = SIZES[workload]
    config = dict(config, tips=tips or small_tips, sites=sites or small_sites)
    traffic = dict(traffic, **TRAFFIC[workload])
    return cell_, config, traffic, limits, e2e, layer


def execute(workload: str, seconds: float = 0.5, trace: bool = False,
            seed: int = SEED) -> dict:
    """One run of `workload` at its test size on the CPU, on one host
    thread (pytest's workers share the cores)."""
    torch.set_num_threads(1)
    return run.execute(*cell(workload), seed, seconds, trace,
                       torch.device("cpu"))
