"""The all-edge engine of the port against libpll2_tpu on the CPU:
compile_tree_full byte-equal; all_edge_loglikelihoods (the logL across
every branch of one message sweep) equal to each other and to the JAX
package's at f64 rtol 1e-9 (the engine budget of test_torch_engine), f32
at 5e-6 (bench.py's f32 budget); optimize_branch_lengths,
score_placements and branch_derivatives against the JAX package's at f64
rtol 1e-9, with and without per-rate scalers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.tree.generate import (balanced_newick, random_newick,
                                             random_tipchars)

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


def full_case(case, sites=200, seed=4):
    """(JAX args, port args) of the all-edge entry points on shared f64
    inputs: (full program, cfg, model, bl, tipchars, weights, invariant)."""
    spec = dict(CASES[case])
    newick = spec.pop("newick")()
    jargs, pargs = both(newick, sites, seed, "f64", **spec)
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jargs[1])
    pfull = engine.compile_tree_full(T.parse_newick_string(newick), pargs[1])
    return (jfull,) + jargs[1:], (pfull,) + pargs[1:]


ALL_EDGE_CASES = ["random24", "pinv", "per_rate_scaled", "asc_lewis"]


@pytest.mark.parametrize("case", ALL_EDGE_CASES)
def test_branch_derivatives_f64(case):
    jargs, pargs = full_case(case)
    d1, d2 = engine.branch_derivatives(*pargs)
    j1, j2 = jengine.branch_derivatives(*jargs)
    assert d1.shape == d2.shape == (pargs[0].edge_rows.shape[0],)
    assert d1.dtype == torch.float64
    np.testing.assert_allclose(d1.numpy(), np.asarray(j1), rtol=1e-9,
                               atol=1e-9 * float(np.abs(j1).max()))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j2), rtol=1e-9)


def test_branch_derivatives_central_differences():
    """d1 of -lnL against central differences of engine.loglikelihood."""
    spec = dict(CASES["random24"])
    newick = spec.pop("newick")()
    _, pargs = both(newick, 120, 1, "f64")
    prog, cfg, model, bl, *rest = pargs
    pfull = engine.compile_tree_full(T.parse_newick_string(newick), cfg)
    d1, _ = engine.branch_derivatives(pfull, cfg, model, bl, *rest)
    h = 1e-6
    for e in (0, 7, len(bl) - 1):
        up, down = bl.clone(), bl.clone()
        up[e] += h
        down[e] -= h
        fd = (engine.loglikelihood(prog, cfg, model, up, *rest)
              - engine.loglikelihood(prog, cfg, model, down, *rest)) / (2 * h)
        np.testing.assert_allclose(d1[e].item(), -fd.item(), rtol=1e-6)


@pytest.mark.parametrize("case", ALL_EDGE_CASES)
def test_optimize_branch_lengths_f64(case):
    jargs, pargs = full_case(case)
    kw = dict(rounds=2, newton_iters=4)
    before = engine.all_edge_loglikelihoods(*pargs)[0].item()
    bl, logl = engine.optimize_branch_lengths(*pargs, **kw)
    jbl, jlogl = jengine.optimize_branch_lengths(*jargs, **kw)
    np.testing.assert_allclose(bl.numpy(), np.asarray(jbl), rtol=1e-9)
    np.testing.assert_allclose(logl.item(), float(jlogl), rtol=1e-9)
    if "bl_scale" not in CASES[case]:
        # (from lengths x 30 on random data, two short rounds of guarded
        # steps are not yet uphill in either package)
        assert logl.item() > before
    # the returned logL is the tree's logL at the returned lengths
    again = engine.all_edge_loglikelihoods(pargs[0], pargs[1], pargs[2], bl,
                                           *pargs[4:])
    np.testing.assert_allclose(again.numpy(), logl.item(), rtol=1e-9)


def test_optimize_branch_lengths_smooths_five_colours():
    """All n_colors classes are smoothed (a balanced 24-taxon tree needs
    five), as in the JAX package."""
    newick = balanced_newick(24)
    jargs, pargs = both(newick, 150, 2, "f64")
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jargs[1])
    pfull = engine.compile_tree_full(T.parse_newick_string(newick), pargs[1])
    assert pfull.n_colors == 5
    bl, logl = engine.optimize_branch_lengths(pfull, *pargs[1:], rounds=1,
                                              newton_iters=3)
    jbl, jlogl = jengine.optimize_branch_lengths(jfull, *jargs[1:], rounds=1,
                                                 newton_iters=3)
    assert (bl != pargs[3]).all()
    np.testing.assert_allclose(bl.numpy(), np.asarray(jbl), rtol=1e-9)
    np.testing.assert_allclose(logl.item(), float(jlogl), rtol=1e-9)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_smoothing_keeps_the_start_where_the_logl_is_not_finite(n_parts):
    """Where f32 Newton steps end at a length at which an edge's sumtable
    terms cancel (its logL NaN, as at min_branch after an overshoot), the
    edge keeps its start length; an end with a finite logL is kept.  Over
    two partitions the summed logL is judged: a partition whose logL is
    finite at the end does not save an edge whose other partition's is
    NaN there."""
    spec = dict(CASES["random24"])
    newick = spec.pop("newick")()
    _, (_, cfg, model, _, _, pw, inv) = both(newick, 64, 1, "f32")
    R, S, T = cfg.rate_cats, cfg.states, cfg.sites_padded
    # L(t) = 1e-3 - 1.5e-3 exp(-k t) at every site and rate: < 0 near 0
    st = torch.zeros((2, R, S, T), dtype=torch.float32)
    st[:, :, 0], st[:, :, 1] = 1e-3, -1.5e-3
    # L(t) = 1e-3: finite at every length
    flat = torch.zeros((2, R, S, T), dtype=torch.float32)
    flat[:, :, 0] = 1e-3
    evals = torch.tensor([0.0, -1.0, -1.0, -1.0]).expand(R, S)
    part = engine._Part(None, cfg, model, evals, None, pw, inv, None)
    sumtables = [flat, st][-n_parts:]
    got = engine._finite_or_start([part] * n_parts, sumtables,
                                  torch.tensor([0.5, 0.5]),
                                  torch.tensor([1e-8, 30.0]))
    assert got.tolist() == [0.5, 30.0]
    kept = engine._finite_or_start([part], [flat], torch.tensor([0.5, 0.5]),
                                   torch.tensor([1e-8, 30.0]))
    assert kept.tolist() == [pytest.approx(1e-8), 30.0]


@pytest.mark.parametrize("case", ALL_EDGE_CASES)
def test_score_placements_f64(case):
    """A tip CLV with zero scalers regrafted onto every edge, priced by
    both packages on the same inputs."""
    jargs, pargs = full_case(case)
    cfg = pargs[1]
    rng = np.random.default_rng(8)
    sub = jengine.pad_tipchars(random_tipchars(1, cfg.sites, rng),
                               dataclasses.replace(jargs[1], tips=1))
    sub_clv = np.broadcast_to(
        ((sub[0][None, :] >> np.arange(4)[:, None]) & 1).astype(np.float64),
        (4, 4, cfg.sites_padded)).copy()
    shape = (4, cfg.sites_padded) if cfg.per_rate_scalers \
        else (cfg.sites_padded,)
    sub_scal = rng.integers(0, 2, shape).astype(np.int32)
    got = engine.score_placements(
        *pargs, torch.as_tensor(sub_clv), torch.as_tensor(sub_scal), 0.13)
    want = jengine.score_placements(
        *jargs, jnp.asarray(sub_clv), jnp.asarray(sub_scal),
        jnp.float64(0.13))
    assert got.shape == (pargs[0].edge_rows.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


@pytest.mark.parametrize("per_rate", [False, True])
def test_score_placements_roundtrip(per_rate):
    """Regrafting a pruned tip onto the edge it came from gives the logL
    of the tree whose two attachment half-edges are equal (SPR split
    semantics; the JAX package's test_asc_score_placements_roundtrip)."""
    rng = np.random.default_rng(21)
    newick = random_newick(11, rng)
    _, pargs = both(newick, 90, 3, "f64", per_rate=per_rate, bl_scale=8.0)
    prog, cfg, model, bl, tipchars, pw, inv = pargs
    raw = tipchars[:, :cfg.sites].numpy().astype(np.uint64)
    (full_r, cfg_r, tip_r, sub_clv, sub_scaler, sub_len, origin,
     halved) = chip_smoke.placement_inputs(newick, raw, cfg, "cpu")
    # `both` scaled the branch lengths; scale the remainder's alike
    bl_r = torch.as_tensor(full_r.default_branch_lengths * 8.0)
    scores = engine.score_placements(
        full_r, cfg_r, model, bl_r, tip_r, pw, inv, sub_clv, sub_scaler,
        sub_len * 8.0)
    prog2 = engine.compile_tree(halved, cfg)
    want = engine.loglikelihood(
        prog2, cfg, model, torch.as_tensor(prog2.default_branch_lengths
                                           * 8.0), tipchars, pw, inv)
    np.testing.assert_allclose(scores[origin].item(), want.item(),
                               rtol=1e-10)
    assert int((scores > scores[origin]).sum()) < len(scores)
