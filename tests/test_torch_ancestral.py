"""Marginal ancestral states in the port (ops/likelihood.node_ancestral and
Partition.compute_node_ancestral) against libpll2_tpu, on the CPU in f64:
random CLVs and scalers through both functions, then every edge of a tree
in both directions through both partitions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jpll
import libpll2_tpu_torch as ppll
from libpll2_tpu import tree as JT
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.ops import likelihood as jlik
from libpll2_tpu_torch import tree as PT
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import likelihood as plik

from .test_torch_partition import make


@pytest.mark.parametrize("states", [4, 20])
@pytest.mark.parametrize("per_rate", [False, True])
def test_node_ancestral_function(states, per_rate):
    """Random CLVs (padding columns zero), random scalers (per-rate: up to
    six apart, past SCALE_RATE_MAXDIFF) and a random P-matrix."""
    rng = np.random.default_rng(states * 10 + per_rate)
    R, sites = 4, 100
    kw = dict(tips=5, clv_buffers=3, states=states, sites=sites,
              rate_matrices=1, prob_matrices=7, rate_cats=R,
              scale_buffers=3, per_rate_scalers=per_rate)
    pcfg, jcfg = PartitionConfig(**kw), JConfig(**kw)
    T = pcfg.sites_padded
    clv = rng.uniform(0, 1, (2, R, states, T))
    clv[..., sites:] = 0.0
    shape = (2, R, T) if per_rate else (2, T)
    scalers = rng.integers(0, 7, shape).astype(np.int32)
    pmat = rng.dirichlet(np.ones(states), (R, states))
    freqs = np.tile(rng.dirichlet(np.ones(states)), (R, 1))
    weights = rng.dirichlet(np.ones(R))
    want = np.asarray(jlik.node_ancestral(
        jnp.asarray(clv[0]), jnp.asarray(scalers[0]), jnp.asarray(clv[1]),
        jnp.asarray(scalers[1]), jnp.asarray(pmat), jnp.asarray(freqs),
        jnp.asarray(weights), jcfg))
    t = torch.as_tensor
    got = plik.node_ancestral(t(clv[0]), t(scalers[0]), t(clv[1]),
                              t(scalers[1]), t(pmat), t(freqs), t(weights),
                              pcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got[:sites].sum(axis=1), 1.0, atol=1e-12)
    assert np.all(got[sites:] == 0.0)


def edge_pairs(tree):
    """Every edge of an unrooted tree in both directions, as (node,
    scaler, other, scaler, pmatrix); a tip is only ever `other`."""
    pairs = []
    for node in tree.nodes:
        for half in ([node] if node.next is None else node.roundabout()):
            back = half.back
            if half.next is not None:
                pairs.append((half.clv_index, half.scaler_index,
                              back.clv_index, back.scaler_index,
                              half.pmatrix_index))
    return pairs


@pytest.mark.parametrize("name", ["dna", "lg4x", "per_rate", "repeats",
                                  "pinv"])
def test_every_edge_of_a_partition(name):
    pj, tree_j, pi = make(jpll, JT, name)
    pp, tree_p, _ = make(ppll, PT, name)
    pairs = edge_pairs(tree_j)
    assert pairs == edge_pairs(tree_p)
    for pair in pairs:
        want = pj.compute_node_ancestral(*pair, pi)
        got = pp.compute_node_ancestral(*pair, pi)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
