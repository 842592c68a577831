"""The port's empirical amino-acid models against libpll2_tpu's: every
table equal bit for bit (both packages read their own copy of the same
published constants), and a protein log-likelihood (LG, and the LG4X
mixture with one matrix per rate category) against the JAX package at f64
rtol 1e-9 (the engine budget of test_torch_engine: same formulas, sums in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.models import aa as jaa
from libpll2_tpu.tree.generate import random_tipchars
from libpll2_tpu_torch import engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.models import aa
from libpll2_tpu_torch.tree.generate import random_newick


def test_model_names_equal():
    assert aa.available_models() == jaa.available_models()
    assert len(aa.AA_MODEL_NAMES) == 28 and len(aa.AA_MIXTURE_NAMES) == 2


@pytest.mark.parametrize("name", jaa.AA_MODEL_NAMES + jaa.AA_MIXTURE_NAMES)
def test_tables_equal(name):
    rates, freqs = aa.aa_model(name)
    jrates, jfreqs = jaa.aa_model(name)
    mixture = name in jaa.AA_MIXTURE_NAMES
    assert rates.shape == ((4, 190) if mixture else (190,))
    assert freqs.shape == ((4, 20) if mixture else (20,))
    for got, want in ((rates, jrates), (freqs, jfreqs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_name_spellings_and_unknown():
    np.testing.assert_array_equal(aa.aa_model("Q.pfam")[0],
                                  aa.aa_model("q_pfam")[0])
    rates, _ = aa.aa_model("lg")
    rates[0] = -1.0                       # a copy: the table is untouched
    assert aa.aa_model("lg")[0][0] != -1.0
    with pytest.raises(KeyError, match="unknown AA model"):
        aa.aa_model("no_such_model")


@pytest.mark.parametrize("name", ["lg", "lg4x"])
def test_protein_loglikelihood_f64(name):
    rng = np.random.default_rng(6)
    newick = random_newick(14, rng)
    jt, pt = jtree.parse_newick_string(newick), T.parse_newick_string(newick)
    n, sites = pt.tip_count, 200
    rates, freqs = (np.atleast_2d(x) for x in jaa.aa_model(name))
    common = dict(tips=n, clv_buffers=pt.inner_count, states=20, sites=sites,
                  rate_matrices=len(rates), prob_matrices=2 * n - 3,
                  rate_cats=4, scale_buffers=pt.inner_count)
    jcfg = JConfig(**common, dtype=jnp.float64)
    pcfg = PartitionConfig(**common, dtype=torch.float64)
    indices = None if len(rates) == 1 else [0, 1, 2, 3]
    gamma = pll.compute_gamma_cats(0.7, 4)
    jmodel = jengine.make_model(rates, freqs, gamma, params_indices=indices,
                                dtype=jnp.float64)
    prates, pfreqs = (np.atleast_2d(x) for x in aa.aa_model(name))
    pmodel = engine.make_model(prates, pfreqs, gamma, params_indices=indices,
                               device="cpu")
    jprog, pprog = jengine.compile_tree(jt, jcfg), engine.compile_tree(pt,
                                                                       pcfg)
    tipchars = jengine.pad_tipchars(
        random_tipchars(n, sites, rng, states=20), jcfg)
    pw = np.zeros(jcfg.sites_padded)
    pw[:sites] = rng.integers(1, 4, sites)
    inv = np.full(jcfg.sites_padded, -1, np.int32)
    bl = jprog.default_branch_lengths
    want = float(jengine.loglikelihood(
        jprog, jcfg, jmodel, jnp.asarray(bl), jnp.asarray(tipchars),
        jnp.asarray(pw), jnp.asarray(inv)))
    got = engine.loglikelihood(
        pprog, pcfg, pmodel, torch.as_tensor(bl), torch.as_tensor(tipchars),
        torch.as_tensor(pw), torch.as_tensor(inv))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-9)
    if name == "lg4x":
        assert pmodel.params_indices.tolist() == [0, 1, 2, 3]
        assert pmodel.eigenvals.shape == (4, 20)


def test_build_case_protein():
    """build_case builds protein cases the way it builds DNA ones: LG, or
    a four-matrix mixture with one matrix per rate category."""
    cfg, program, model, *args = engine.build_case(
        12, 130, dtype=torch.float64, states=20, device="cpu")
    assert cfg.states == 20 and model.eigenvals.shape == (1, 20)
    assert int(args[1].max()) < 1 << 20
    logl = engine.loglikelihood(program, cfg, model, *args)
    assert np.isfinite(logl.item())
    cfg4, program4, model4, *args4 = engine.build_case(
        12, 130, dtype=torch.float64, states=20, aa_model_name="lg4x",
        device="cpu")
    assert cfg4.rate_matrices == 4
    assert model4.params_indices.tolist() == [0, 1, 2, 3]
    assert engine.loglikelihood(program4, cfg4, model4, *args4).item() \
        != logl.item()
    with pytest.raises(ValueError, match="states"):
        engine.build_case(12, 130, states=7, device="cpu")
