"""The all-edge body's metrics (newton_ms.smooth, newton_kernel_share.smooth):
the readers' arithmetic over the program's `libpll2.newton` spans and
engine.newton_choice's counters, None for a program without them, and the
traced smoothing run at a CPU test's size, where every class is the plain
path's."""
import sys
from types import SimpleNamespace

import pytest

from pllbench import run

from . import tiny
from .test_pllbench_message_kernel import metric
from .test_pllbench_partitioned import execute as execute_smooth
from .test_pllbench_spans import held, record  # noqa: F401 (a fixture)
from .test_pllbench_spans import run as traced

NAMES = ("newton_ms.smooth", "newton_kernel_share.smooth")


def test_share_arithmetic(monkeypatch):
    from libpll2_tpu_torch import engine
    read = metric("newton_kernel_share.smooth").read
    fn = engine.newton_choice
    monkeypatch.setattr(fn, "kernel_classes", 36)
    monkeypatch.setattr(fn, "plain_classes", 12)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(fn, "plain_classes", 0)
    assert read(None) == pytest.approx(100.0)
    monkeypatch.setattr(fn, "kernel_classes", 0)
    assert read(None) is None                   # no class smoothed yet


def test_share_reads_100_after_kernel_smoothing(monkeypatch):
    """A smoothing call whose every class took the kernel reads 100: the
    choice faked to take it on the CPU, with counters of its own from 0,
    and the kernel's plain version in its place."""
    import numpy as np
    import torch

    import chip_smoke
    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.ops import newton_edges as ne
    from libpll2_tpu_torch.tree.generate import random_newick

    def take_it(parts, device):
        return True
    take_it.kernel_classes = take_it.plain_classes = 0
    monkeypatch.setattr(engine, "newton_choice", take_it)
    monkeypatch.setattr(ne, "newton_edges", ne.newton_edges_reference)
    cfg, full, model, bl, tipchars, _ = chip_smoke.message_inputs(
        random_newick(10, np.random.default_rng(3)), 64, 5,
        torch.device("cpu"))
    pw = torch.ones(cfg.sites_padded)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32)
    engine.optimize_branch_lengths(full, cfg, model, bl, tipchars, pw, inv,
                                   rounds=1, newton_iters=2)
    assert take_it.kernel_classes == full.n_colors
    assert metric("newton_kernel_share.smooth").read(None) == 100.0


def test_readers_without_the_program_parts(monkeypatch, held):  # noqa: F811
    """A program from before the kernel (no newton_choice, no counters, no
    `libpll2.newton` span) reads None on both."""
    from libpll2_tpu_torch import engine
    share = metric("newton_kernel_share.smooth").read
    ms = metric("newton_ms.smooth").read
    monkeypatch.delattr(engine.newton_choice, "kernel_classes")
    assert share(None) is None
    monkeypatch.delattr(engine, "newton_choice")
    assert share(None) is None
    monkeypatch.setitem(sys.modules, "libpll2_tpu_torch.engine", None)
    monkeypatch.delattr(sys.modules["libpll2_tpu_torch"], "engine")
    assert share(None) is None
    held(record("libpll2.message_sweep", 1.0, 1.0))
    assert ms(traced()) is None                 # no such span
    assert ms(SimpleNamespace(trace=None)) is None


def test_newton_ms_per_call(held):  # noqa: F811
    held(record("libpll2.newton", 9.0, 1.5), record("libpll2.newton", 9.0,
                                                    2.5),
         record("libpll2.message_sweep", 9.0, 100.0))
    assert metric("newton_ms.smooth").read(traced(units=2)) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("name", NAMES)
def test_reader_names_its_cell(name):
    """Each is listed for dna_smooth, the one cell that smooths."""
    *_, layer = run.load_cell(tiny.ROOT, "dna_smooth")
    assert name in {m["name"] for m in layer}
    assert {m["layer"] for m in layer if m["name"] == name} == \
        {"all-edge body"}


def test_traced_run_reads_the_plain_path_on_the_cpu():
    """On CPU tensors every class is the plain path's: 0 %, and the span
    is read where the trace has CUDA events only (None here)."""
    result = execute_smooth("dna_smooth", 0.3, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["newton_kernel_share.smooth"]["value"] == 0.0
