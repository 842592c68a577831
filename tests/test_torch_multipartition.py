"""The port's multipartition module against libpll2_tpu.multipartition on
the CPU: three mixed partitions over one 8-taxon topology (GTR DNA; GTR
DNA with +I and per-rate scalers; LG protein), the JAX models carried
across by convert.model_from_jax and the same numpy tips and weights.

Tolerances: f64 rtol 1e-9 — the same f64 formulas in another summation
order (the port batches the edges the JAX package maps over one at a
time); f32 rtol 1e-5 — f32 rounding through the tree depth and the site
sum, over three partitions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import multipartition as jmulti
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.models.aa import aa_model
from libpll2_tpu_torch import convert, engine, multipartition
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.tree.generate import random_newick, random_tipchars

from .test_torch_engine import both, invariant_of

N_TIPS = 8
SCALERS = [1.0, 0.7, 1.6]
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                       torch.float32)}


def make_case(seed, dt="f64", bl_scale=1.0):
    """(JAX (mp, models, bl, tipchars, pws, invs), the port's same)."""
    jdt, pdt = DTYPES[dt]
    rng = np.random.default_rng(seed)
    newick = random_newick(N_TIPS, rng)
    jt, pt = jtree.parse_newick_string(newick), T.parse_newick_string(newick)
    lg_rates, lg_freqs = aa_model("lg")
    specs = [
        dict(states=4, sites=61, alpha=0.8, subst=[1.2, 2.1, 0.7, 1.3, 2.5,
                                                   1.0],
             freqs=[0.3, 0.25, 0.2, 0.25]),
        dict(states=4, sites=83, alpha=1.4, subst=[1.0, 4.0, 1.0, 1.0, 4.0,
                                                   1.0],
             freqs=[0.2, 0.3, 0.3, 0.2], pinv=0.2, per_rate=True),
        dict(states=20, sites=37, alpha=0.75, subst=lg_rates,
             freqs=lg_freqs),
    ]
    jcfgs, pcfgs, jmodels, pmodels = [], [], [], []
    tips, pws, invs = [], [], []
    for s in specs:
        common = dict(tips=N_TIPS, clv_buffers=pt.inner_count,
                      states=s["states"], sites=s["sites"], rate_matrices=1,
                      prob_matrices=2 * N_TIPS - 3, rate_cats=4,
                      scale_buffers=pt.inner_count,
                      per_rate_scalers=s.get("per_rate", False))
        jcfg = JConfig(**common, dtype=jdt)
        jmodel = jengine.make_model(
            [s["subst"]], [s["freqs"]], pll.compute_gamma_cats(s["alpha"], 4),
            prop_invar=[s.get("pinv", 0.0)], dtype=jdt)
        raw = random_tipchars(N_TIPS, s["sites"], rng, states=s["states"])
        raw[:, :s["sites"] // 6] = raw[0, :s["sites"] // 6]
        tipchars = jengine.pad_tipchars(raw, jcfg)
        pw = np.zeros(jcfg.sites_padded)
        pw[:jcfg.sites] = rng.integers(1, 4, jcfg.sites)
        inv = invariant_of(tipchars) if "pinv" in s else \
            np.full(jcfg.sites_padded, -1, np.int32)
        jcfgs.append(jcfg)
        pcfgs.append(PartitionConfig(**common, dtype=pdt))
        jmodels.append(jmodel)
        pmodels.append(convert.model_from_jax(convert.model_arrays(jmodel),
                                              device="cpu"))
        tips.append(tipchars)
        pws.append(pw)
        invs.append(inv)
    jmp = jmulti.compile_multipartition(jt, jcfgs)
    pmp = multipartition.compile_multipartition(pt, pcfgs)
    bl = jmp.programs[0].default_branch_lengths * bl_scale
    jargs = (jmp, tuple(jmodels), jnp.asarray(bl, jdt),
             tuple(jnp.asarray(t) for t in tips),
             tuple(jnp.asarray(w, jdt) for w in pws),
             tuple(jnp.asarray(i) for i in invs))
    pargs = (pmp, pmodels, torch.as_tensor(bl, dtype=pdt),
             [torch.as_tensor(t) for t in tips],
             [torch.as_tensor(w, dtype=pdt) for w in pws],
             [torch.as_tensor(i) for i in invs])
    return jargs, pargs


def scalers_of(kind, lib):
    if kind == "linked":
        return None
    return jnp.asarray(SCALERS, jnp.float64) if lib == "jax" \
        else torch.tensor(SCALERS, dtype=torch.float64)


def test_compile_multipartition_programs_equal():
    (jmp, *_), (pmp, *_) = make_case(3)
    assert pmp.n_partitions == 3
    assert convert.multipartition_mismatches(pmp, jmp) == []
    (other, *_), _ = make_case(4)
    assert "programs[0].level_ops" in convert.multipartition_mismatches(
        pmp, other)


def test_compile_multipartition_refuses_differing_taxa():
    _, (pmp, *_) = make_case(3)
    tree = T.parse_newick_string(random_newick(N_TIPS + 1,
                                               np.random.default_rng(0)))
    with pytest.raises(ValueError, match="same taxa"):
        multipartition.compile_multipartition(tree, pmp.cfgs)
    import dataclasses
    odd = dataclasses.replace(pmp.cfgs[1], tips=N_TIPS + 1)
    with pytest.raises(ValueError, match="same taxa"):
        multipartition.compile_multipartition(
            T.parse_newick_string(random_newick(N_TIPS,
                                                np.random.default_rng(0))),
            [pmp.cfgs[0], odd])


@pytest.mark.parametrize("kind", ["linked", "scaled"])
def test_loglikelihood_f64(kind):
    jargs, pargs = make_case(17)
    got = multipartition.loglikelihood(*pargs, scalers_of(kind, "torch"))
    want = float(jmulti.loglikelihood(*jargs, scalers_of(kind, "jax")))
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-9)
    # the total is the sum of the partitions' own calls
    pmp, models, bl, tips, pws, invs = pargs
    s = [1.0] * 3 if kind == "linked" else SCALERS
    parts = sum(engine.loglikelihood(
        pmp.programs[k], pmp.cfgs[k], models[k], bl * s[k], tips[k], pws[k],
        invs[k]).item() for k in range(3))
    np.testing.assert_allclose(got.item(), parts, rtol=1e-12)


def test_loglikelihood_takes_a_plain_list_of_scalers():
    _, pargs = make_case(17)
    a = multipartition.loglikelihood(*pargs, SCALERS)
    b = multipartition.loglikelihood(*pargs, scalers_of("scaled", "torch"))
    assert a.item() == b.item()


def test_loglikelihood_f32():
    jargs, pargs = make_case(19, "f32")
    got = multipartition.loglikelihood(*pargs, scalers_of("scaled", "torch"))
    want = float(jmulti.loglikelihood(*jargs, scalers_of("scaled", "jax")))
    # the partitions' f32 site terms, summed in f64
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["linked", "scaled"])
def test_branch_derivatives_f64(kind):
    jargs, pargs = make_case(23)
    d1, d2 = multipartition.branch_derivatives(*pargs,
                                               scalers_of(kind, "torch"))
    j1, j2 = jmulti.branch_derivatives(*jargs, scalers_of(kind, "jax"))
    assert d1.dtype == d2.dtype == torch.float64
    assert d1.shape == d2.shape == pargs[2].shape
    np.testing.assert_allclose(d1.numpy(), np.asarray(j1), rtol=1e-9,
                               atol=1e-9 * float(np.abs(j1).max()))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j2), rtol=1e-9)


def test_branch_derivatives_central_differences():
    _, pargs = make_case(23)
    pmp, models, bl, *rest = pargs
    s = scalers_of("scaled", "torch")
    d1, _ = multipartition.branch_derivatives(*pargs, s)
    h = 1e-6
    for e in (0, 3, len(bl) - 1):
        up, down = bl.clone(), bl.clone()
        up[e] += h
        down[e] -= h
        fd = (multipartition.loglikelihood(pmp, models, up, *rest, s)
              - multipartition.loglikelihood(pmp, models, down, *rest, s)
              ).item() / (2 * h)
        np.testing.assert_allclose(d1[e].item(), -fd, rtol=2e-5, atol=1e-7)


def test_branch_derivatives_chunked_equals_whole(monkeypatch):
    _, pargs = make_case(23)
    whole = multipartition.branch_derivatives(*pargs)
    monkeypatch.setattr(engine, "EDGE_CHUNK_BYTES", 1 << 16)
    chunks = engine._edge_chunks(pargs[0].cfgs, torch.arange(13))
    assert len(chunks) > 1
    parts = multipartition.branch_derivatives(*pargs)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


@pytest.mark.parametrize("kind", ["linked", "scaled"])
def test_optimize_branch_lengths_f64(kind):
    jargs, pargs = make_case(29, bl_scale=2.0)
    got_bl, got = multipartition.optimize_branch_lengths(
        *pargs, scalers_of(kind, "torch"), rounds=3, newton_iters=6)
    want_bl, want = jmulti.optimize_branch_lengths(
        *jargs, scalers_of(kind, "jax"), rounds=3, newton_iters=6)
    np.testing.assert_allclose(got_bl.numpy(), np.asarray(want_bl),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-9)
    before = multipartition.loglikelihood(*pargs,
                                          scalers_of(kind, "torch")).item()
    assert got.item() > before
    pmp, models, _, *rest = pargs
    again = multipartition.loglikelihood(pmp, models, got_bl, *rest,
                                         scalers_of(kind, "torch")).item()
    np.testing.assert_allclose(got.item(), again, rtol=1e-12)


@pytest.mark.parametrize("kind", ["linked", "scaled"])
def test_optimize_branch_lengths_f32_from_far_starts(kind):
    """f32 Newton steps from lengths x 30 overshoot on some edges to where
    their summed logL is not finite; each such edge keeps its start, so no
    length comes back NaN and the total is not below the start's."""
    _, pargs = make_case(29, "f32", bl_scale=30.0)
    before = multipartition.loglikelihood(*pargs,
                                          scalers_of(kind, "torch")).item()
    bl, logl = multipartition.optimize_branch_lengths(
        *pargs, scalers_of(kind, "torch"), rounds=2, newton_iters=6)
    assert not torch.isnan(bl).any()
    assert np.isfinite(logl.item()) and logl.item() >= before


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_one_partition_is_the_engine_call(dt):
    """A one-partition MultiPartition smooths and differentiates bit for
    bit as engine's one-partition entry points, its results in f64."""
    newick = random_newick(12, np.random.default_rng(5))
    _, (_, cfg, model, bl, tips, pw, inv) = both(newick, 150, 3, dt,
                                                 bl_scale=3.0)
    tree = T.parse_newick_string(newick)
    mp = multipartition.compile_multipartition(tree, [cfg])
    full = engine.compile_tree_full(tree, cfg)
    kw = dict(rounds=2, newton_iters=4)
    want_bl, want = engine.optimize_branch_lengths(full, cfg, model, bl,
                                                   tips, pw, inv, **kw)
    got_bl, got = multipartition.optimize_branch_lengths(
        mp, [model], bl, [tips], [pw], [inv], **kw)
    assert torch.equal(got_bl, want_bl)
    assert got.dtype == torch.float64 and got.item() == want.item()
    want_d = engine.branch_derivatives(full, cfg, model, bl, tips, pw, inv)
    got_d = multipartition.branch_derivatives(mp, [model], bl, [tips], [pw],
                                              [inv])
    for a, b in zip(got_d, want_d):
        assert a.dtype == torch.float64 and torch.equal(a, b.double())
