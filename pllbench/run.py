"""Run one cell of the benchmark once, on the card this process sees:

    python3 -m pllbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cell; the harness
finds its configuration (the file BENCHMARK.json gives), its traffic mix
(traffic/<mix>.json, whose "driver" names a module of drivers/), the
limits of its check (limits/<cell>.json) and its metrics
(metrics/<metric>.py) by those names.  It builds the inputs from the seed,
warms up every shape the cell uses, measures for --seconds (--trace 0: the
end-to-end metrics) or traces a fixed piece of the same work (--trace 1:
the per-layer metrics), then, with the program's state freed, checks the
window's outputs against the reference, and prints the checks on stderr
and one JSON line on stdout.  It exits non-zero and prints no result
without a card, with the program missing, or where the process has
loaded JAX or the JAX package.
"""
import time

START = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
# top-level module names the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "libpll2_tpu")


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""
    config: dict
    traffic: dict
    setup_s: float
    window_s: Optional[float]       # None in a traced run
    units: int                      # evaluations or rounds completed
    latencies_s: List[float]        # per evaluation (evaluation cells)
    work_per_unit: Optional[float]  # site-updates an evaluation
    trace: object                   # tracing.Trace in a traced run
    peaks: Optional[dict]           # peaks.json's row of this card


def load_cell(root: Path, workload: str):
    """(cell, config, traffic, limits, end-to-end specs, per-layer specs)
    of `workload` in root/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reported]
    return cell, config, traffic, limits, e2e, layer


def metric_reader(name: str):
    """metrics/<name>.py's read function."""
    spec = importlib.util.spec_from_file_location(
        "pllbench.metrics." + name.replace(".", "__"),
        HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_power(device) -> Optional[str]:
    """`name, power limit` of the card as nvidia-smi prints them."""
    import torch
    uuid = str(torch.cuda.get_device_properties(device).uuid).lower()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for row in out.strip().splitlines():
        smi_uuid, rest = row.split(", ", 1)
        if smi_uuid.strip().lower().removeprefix("gpu-") == \
                uuid.removeprefix("gpu-"):
            return rest.strip()
    return None


def execute(cell: dict, config: dict, traffic: dict, limits: dict,
            e2e: list, layer: list, seed: int, seconds: float, trace: bool,
            device, start: float = START) -> dict:
    """One run of a cell on `device`; the result line as a dict."""
    import torch

    from . import tracing

    driver = importlib.import_module(
        f"pllbench.drivers.{traffic['driver']}").Driver(
            config, traffic, seed, device)
    driver.warm()
    tracing.sync(device)
    setup_s = time.perf_counter() - start
    window_s, traced = None, None
    if trace:
        traced = driver.traced()
    else:
        window_s = driver.window(seconds)
    tracing.sync(device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peaks = json.loads((HERE / "peaks.json").read_text()).get(kind)
    run = Run(config, traffic, setup_s, window_s, driver.units,
              getattr(driver, "latencies", []),
              getattr(driver, "work_per_unit", None), traced, peaks)
    metrics = {}
    for spec in (layer if trace else e2e):
        value = metric_reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    out = {}
    if traced is not None:
        prof = traced.profile
        dev["busy_s"] = tracing.union_s((s, e) for _, s, e in prof.device)
        dev["window_s"] = (prof.end - prof.start) / 1e9
        out["breakdown"] = {"device_ops": tracing.device_ops(prof),
                            "idle_gaps": tracing.idle_gaps(prof)}
        lost = traced.lost_rows()
        if lost:
            print(f"[pllbench] per-layer metrics of the trace left out: "
                  f"{lost}", file=sys.stderr)
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = driver.check(limits)
    print(f"[pllbench] the check took {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    result = {"correct": all(c.ok for c in checks),
              "attempted": driver.units, "failed": driver.failed,
              "metrics": metrics, "device": dev}
    result.update(out)
    if cuda:
        result["card"] = card_power(device)
    result["checks"] = {c.name: {"value": float(c.value),
                                 "limit": float(c.limit),
                                 "relation": c.relation}
                        for c in checks}
    return result


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    cell, config, traffic, limits, e2e, layer = load_cell(root,
                                                          args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"[pllbench] {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if importlib.util.find_spec("libpll2_tpu_torch") is None:
        print("[pllbench] the program libpll2_tpu_torch is not in this "
              "checkout", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(cell, config, traffic, limits, e2e, layer, args.seed,
                     args.seconds, bool(args.trace), torch.device("cuda", 0))
    leaked = forbidden_modules()
    if leaked:
        print(f"[pllbench] the process loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"[check] {name} {float(c['value'])!r} {c['relation']} "
              f"{float(c['limit'])!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
