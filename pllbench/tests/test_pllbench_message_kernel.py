"""The message sweep's kernel share (message_kernel_share.smooth and
.search): the readers' arithmetic over the program's counters, None for a
program without them or with no sweep counted, and the traced runs of
both cells at a CPU test's size, where every sweep is the dense path's."""
import importlib.util

import pytest
import torch

from pllbench import run

from . import tiny
from .test_pllbench_partitioned import execute as execute_smooth

NAMES = ("message_kernel_share.smooth", "message_kernel_share.search")


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        tiny.ROOT / "pllbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", NAMES)
def test_reader_arithmetic(monkeypatch, name):
    from libpll2_tpu_torch import engine
    read = metric(name).read
    fn = engine.message_sweep
    monkeypatch.setattr(fn, "kernel_sweeps", 39)
    monkeypatch.setattr(fn, "dense_sweeps", 13)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(fn, "dense_sweeps", 0)
    assert read(None) == pytest.approx(100.0)
    monkeypatch.setattr(fn, "kernel_sweeps", 0)
    assert read(None) is None
    # a program from before the kernel keeps no counters
    monkeypatch.delattr(fn, "kernel_sweeps")
    assert read(None) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_names_its_cell(name):
    """Each is listed for the one cell whose end-to-end metric it moves."""
    cell = {"message_kernel_share.smooth": "dna_smooth",
            "message_kernel_share.search": "dna_search"}[name]
    *_, layer = run.load_cell(tiny.ROOT, cell)
    assert name in {m["name"] for m in layer}


def test_traced_runs_read_the_dense_path_on_the_cpu():
    """On CPU tensors every sweep is the dense path's: 0 %."""
    result = execute_smooth("dna_smooth", 0.3, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["message_kernel_share.smooth"]["value"] == 0.0
    torch.set_num_threads(1)
    result = run.execute(*tiny.cell("dna_search"), tiny.SEED, 0.3, True,
                         torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["metrics"]["message_kernel_share.search"]["value"] == 0.0
