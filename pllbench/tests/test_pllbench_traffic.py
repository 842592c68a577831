"""Each traffic mix's work is fixed by --seed: the same seed gives the same
inputs, start trees and branch-length bank, another seed other ones."""
import numpy as np
import pytest
import torch

from pllbench.drivers import common, eval_loop, spr_climb

from . import tiny


@pytest.mark.parametrize("workload", ["dna_eval", "protein_eval"])
def test_eval_loop_is_fixed_by_the_seed(workload):
    _, config, traffic, *_ = tiny.cell(workload)
    cpu = torch.device("cpu")
    a = eval_loop.Driver(config, traffic, tiny.SEED, cpu)
    b = eval_loop.Driver(config, traffic, tiny.SEED, cpu)
    c = eval_loop.Driver(config, traffic, tiny.SEED + 1, cpu)
    assert torch.equal(a.bank, b.bank) and torch.equal(a.tipchars, b.tipchars)
    assert not torch.equal(a.bank, c.bank)
    assert a.sample().tolist() == b.sample().tolist()
    ratio = (a.bank.double() / torch.as_tensor(
        a.program.default_branch_lengths)).numpy()
    lo, hi = traffic["scale"]
    assert ratio.min() >= lo * (1 - 1e-6) and ratio.max() <= hi * (1 + 1e-6)


def test_spr_climb_is_fixed_by_the_seed():
    _, config, traffic, *_ = tiny.cell("dna_search")
    cpu = torch.device("cpu")
    a = spr_climb.Driver(config, traffic, tiny.SEED, cpu)
    b = spr_climb.Driver(config, traffic, tiny.SEED, cpu)
    c = spr_climb.Driver(config, traffic, tiny.SEED + 1, cpu)
    assert a.starts == b.starts and a.warm_start == b.warm_start
    assert a.starts != c.starts
    assert len(set(a.starts)) == len(a.starts) == traffic["starts"]
    assert all(np.array_equal(a.chars[k], b.chars[k]) for k in a.chars)


@pytest.mark.parametrize("workload", ["dna_eval", "protein_eval"])
def test_full_size_inputs_are_fixed_by_the_seed(workload):
    _, config, *_ = tiny.cell(workload)
    full = dict(config, tips=tiny.run.load_cell(tiny.ROOT, workload)[1]["tips"],
                sites=tiny.run.load_cell(tiny.ROOT, workload)[1]["sites"])
    a = common.make_inputs(full, tiny.SEED)
    b = common.make_inputs(full, tiny.SEED)
    c = common.make_inputs(full, 7)
    assert a.newick == b.newick
    assert all(np.array_equal(a.chars[k], b.chars[k]) for k in a.chars)
    assert len(a.chars) == full["tips"]
    assert all(v.shape == (full["sites"],) for v in a.chars.values())
    assert any(not np.array_equal(a.chars[k], c.chars[k]) for k in a.chars)
