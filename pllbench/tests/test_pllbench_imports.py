"""Nothing the harness runs imports JAX or the JAX package: an AST walk
over every file of the benchmark, its tests too, a run of every cell in a
fresh process whose sys.modules is then read, and the exits of the
harness without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

from pllbench import run

from . import tiny

PACKAGE = tiny.ROOT / "pllbench"


def test_no_module_imports_jax():
    paths = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["paths"]
    files = [p for d in paths for p in (tiny.ROOT / d).rglob("*.py")]
    assert PACKAGE / "run.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(run.FORBIDDEN), (path, tops)


def test_a_run_of_every_cell_loads_no_jax():
    code = ("import json, sys\n"
            "from pllbench.tests import tiny\n"
            "from pllbench import run\n"
            "for cell, s in (('dna_eval', 0.2), ('protein_eval', 0.2),\n"
            "                ('dna_search', 3.0)):\n"
            "    assert tiny.execute(cell, s)['correct']\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def harness(cwd):
    return subprocess.run(
        [sys.executable, "-m", "pllbench.run", "--workload", "dna_eval",
         "--seed", str(tiny.SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = harness(tiny.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "pllbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = harness(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
