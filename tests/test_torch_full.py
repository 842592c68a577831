"""The all-edge engine core of the port against libpll2_tpu on the CPU:
compile_tree_full byte-equal, and all_edge_loglikelihoods (the logL
across every branch of one message sweep) equal to each other and to the
JAX package's at f64 rtol 1e-9 (the engine budget of test_torch_engine);
f32 at 5e-6 (bench.py's f32 budget)."""
import numpy as np
import pytest
import torch

from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import tree as T

from .test_torch_engine import CASES, both
from .test_torch_host import both_configs, newick_of


@pytest.mark.parametrize("kind,n,seed", [
    ("random", 5, 0), ("random", 17, 1), ("balanced", 24, 0),
    ("caterpillar", 14, 0)])
def test_compile_tree_full_byte_equal(kind, n, seed):
    jt, jcfg, pt, pcfg = both_configs(newick_of(kind, n, seed))
    ref = jengine.compile_tree_full(jt, jcfg)
    got = engine.compile_tree_full(pt, pcfg)
    assert convert.full_program_mismatches(got, ref) == []
    assert got.level_ops.dtype == np.int32


def test_full_program_mismatches_detects_difference():
    jt, jcfg, _, _ = both_configs(newick_of("random", 12, 3))
    _, _, pt, pcfg = both_configs(newick_of("random", 12, 4), sites=301)
    mism = convert.full_program_mismatches(
        engine.compile_tree_full(pt, pcfg),
        jengine.compile_tree_full(jt, jcfg))
    assert "level_ops" in mism and "cfg_ext.sites" in mism


def all_edges(case, dt):
    """(port [E], JAX [E] or None, port forward logL) on shared inputs."""
    spec = dict(CASES[case])
    newick = spec.pop("newick")()
    jargs, pargs = both(newick, 256, 2, dt, **spec)
    (_, jcfg, *jrest), (pprog, pcfg, *prest) = jargs, pargs
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jcfg)
    pfull = engine.compile_tree_full(T.parse_newick_string(newick), pcfg)
    assert convert.full_program_mismatches(pfull, jfull) == []
    got = engine.all_edge_loglikelihoods(pfull, pcfg, *prest)
    assert got.shape == (pprog.num_branches,)
    want = np.asarray(jengine.all_edge_loglikelihoods(jfull, jcfg, *jrest))
    return got, want, engine.loglikelihood(*pargs).item()


@pytest.mark.parametrize("case", list(CASES))
def test_all_edge_loglikelihoods_f64(case):
    got, want, forward = all_edges(case, "f64")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    np.testing.assert_allclose(got.numpy(), got[0].item(), rtol=1e-9)
    np.testing.assert_allclose(got[0].item(), forward, rtol=1e-9)


def test_all_edge_loglikelihoods_f32():
    got, want, forward = all_edges("per_rate_scaled", "f32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-6)
    np.testing.assert_allclose(got.numpy(), forward, rtol=5e-6)
