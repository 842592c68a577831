"""What the drivers share: a configuration's inputs drawn from the seed,
the program's objects built from them through its public entry points,
and the record of a run's checks.

The inputs are the benchmark's (inputs.py); the program receives a newick
string, tip codes by label and the model's parameters, and builds its own
configuration, model and schedules from them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .. import inputs
from ..reference import model as ref_model
from ..reference import newick


@dataclasses.dataclass
class Inputs:
    newick: str                     # the data tree
    tree: newick.Tree               # the same, read by the reference
    chars: Dict[str, np.ndarray]    # tip label -> [sites] uint64 codes


@dataclasses.dataclass
class Check:
    """One number the run compares, with its limit: value <= limit, or
    value >= limit where the limit is a floor."""
    name: str
    value: float
    limit: float
    floor: bool = False

    @property
    def relation(self) -> str:
        return ">=" if self.floor else "<="

    @property
    def ok(self) -> bool:
        if not np.isfinite(self.value):
            return False
        return self.value >= self.limit if self.floor \
            else self.value <= self.limit


def make_inputs(config: dict, seed: int) -> Inputs:
    """The data tree and the alignment of `config` from `seed`."""
    gen = inputs.rng(seed, 0)
    tips, sites = config["tips"], config["sites"]
    m = config["model"]
    shape = config["tree"]
    if shape["kind"] == "random":
        text = inputs.random_newick(tips, gen, shape["min_bl"],
                                    shape["max_bl"])
    elif shape["kind"] == "balanced":
        text = inputs.balanced_newick(tips, shape["branch_length"])
    else:
        raise ValueError(f"unknown tree kind {shape['kind']!r}")
    tree = newick.parse(text)
    kind = config["alignment"]["kind"]
    if kind == "simulated":
        rates = ref_model.gamma_rates(m["alpha"], m["rate_cats"])
        chars = inputs.simulate_alignment(tree, sites, gen, m["subst"],
                                          m["freqs"], rates)
    elif kind == "random":
        codes = inputs.random_tipchars(tips, sites, gen, m["states"])
        chars = {f"t{i}": codes[i] for i in range(tips)}
    else:
        raise ValueError(f"unknown alignment kind {kind!r}")
    return Inputs(text, tree, chars)


def port_config(config: dict, inner_count: int):
    """The program's PartitionConfig of the cell: the configuration's
    dtype, the program's defaults otherwise (its kernels on the card)."""
    from libpll2_tpu_torch.config import PartitionConfig
    tips = config["tips"]
    return PartitionConfig(
        tips=tips, clv_buffers=inner_count, states=config["model"]["states"],
        sites=config["sites"], rate_matrices=1, prob_matrices=2 * tips - 3,
        rate_cats=config["model"]["rate_cats"], scale_buffers=inner_count,
        dtype=getattr(torch, config["dtype"]))


def port_model(config: dict, device: torch.device):
    """The program's model, which it builds from the parameters itself."""
    from libpll2_tpu_torch import engine
    from libpll2_tpu_torch.models.gamma import compute_gamma_cats
    m = config["model"]
    return engine.make_model([m["subst"]], [m["freqs"]],
                             compute_gamma_cats(m["alpha"], m["rate_cats"]),
                             dtype=getattr(torch, config["dtype"]),
                             device=device)


def reference_logl(config: dict, tree: newick.Tree, lengths,
                   chars, device, precision: str = "f64") -> np.ndarray:
    """The reference's logL of `tree` for each row of `lengths`."""
    from ..reference import likelihood
    m = config["model"]
    return likelihood.loglikelihood(tree, lengths, chars, m["subst"],
                                    m["freqs"], m["alpha"], m["rate_cats"],
                                    device=device, precision=precision)


def rel_gaps(program: np.ndarray, reference: np.ndarray) -> List[float]:
    program = np.asarray(program, dtype=np.float64)
    return list(np.abs(program - reference) / np.abs(reference))
