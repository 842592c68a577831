"""The readings the limits of the benchmark's checks are set from (not
run by the benchmark's own runs):

    python3 -m pllbench.readings --workload <name> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...]

For each seed, in one process: the cell's set-up, a window of --seconds
at the cell's own load, and its checks as a run makes them (the program's
reading); for each control seed the same, and then the checks again with
the control in the program's place (the reference at TF32, the precision
below the configuration's float32).  With --fault <kind> every seed runs
with that fault planted in the program (pllbench/faults.py), the side
"fault:<kind>".  One JSON line per reading, with the rounds of a search
cell: (climb round, moves, scorer-priced) each.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

import torch

from .run import load_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell, config, traffic, limits, _, _ = load_cell(Path.cwd(),
                                                    args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    module = importlib.import_module(f"pllbench.drivers.{traffic['driver']}")
    program_side = "program"
    if args.fault:
        from . import faults
        for owner, name, new in faults.plant(args.fault, traffic["driver"]):
            setattr(owner, name, new)
        program_side = "fault:" + args.fault
    control = set(args.control_seeds)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        driver = module.Driver(config, traffic, seed, device)
        driver.warm()
        driver.window(args.seconds)
        sides = [(program_side, None)]
        if seed in control:
            sides.append(("control", driver.control()))
        for side, values in sides:
            checks = driver.check(limits, values)
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "units": driver.units,
                    "checks": {c.name: c.value for c in checks}}
            if hasattr(driver, "rounds"):
                line["rounds"] = [[r.index, r.moves, int(r.scorer_priced)]
                                  for r in driver.rounds]
            print(json.dumps(line), flush=True)
        del driver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
