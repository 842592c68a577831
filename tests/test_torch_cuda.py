"""The CUDA kernels (both tree-sweep forms, edge scorer, matrix-unit
probe) against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when torch.cuda.is_available() is False
(decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

import chip_smoke
from libpll2_tpu_torch import engine, search_fast
from libpll2_tpu_torch.ops import edge_score, partials_tree
from libpll2_tpu_torch.probes import mma as mma_probe
from libpll2_tpu_torch.tree.generate import random_newick

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("states,per_rate,bl_scale", [
    (4, False, 1.0), (4, False, 30.0), (4, True, 30.0), (2, False, 1.0),
    (10, True, 1.0), (16, False, 1.0), (20, False, 1.0)])
def test_kernel_matches_plain(cuda_device, states, per_rate, bl_scale):
    """Every state count the kernel is built for.  CLV rows rtol 1e-5
    (f32 sums in another order), scalers exact."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, per_rate=per_rate,
        bl_scale=bl_scale, random_model=True)
    prog = program.vmem_prog
    before = partials_tree.sweep.launches
    clv, scal = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
    torch.cuda.synchronize()
    assert partials_tree.sweep.launches == before + 1
    want_clv, want_scal = partials_tree.sweep_reference(tip_b, pmatrix, prog,
                                                        cfg, tb)
    torch.testing.assert_close(scal, want_scal, rtol=0, atol=0)
    torch.testing.assert_close(clv, want_clv, rtol=1e-5, atol=0)


def test_loglikelihood_kernel_vs_dense_f64(cuda_device):
    """The bench's budget, 5e-6 relative, at 128 taxa x 8192 sites."""
    cfg, program, model, *args = engine.build_case(
        128, 8192, dtype=torch.float32, device=cuda_device)
    before = partials_tree.sweep.launches
    got = engine.loglikelihood(program, cfg, model, *args).item()
    assert partials_tree.sweep.launches == before + 1
    cfg, program, model, *args = engine.build_case(
        128, 8192, dtype=torch.float64, device=cuda_device, use_kernel=False)
    want = engine.loglikelihood(program, cfg, model, *args).item()
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) < 5e-6


@pytest.mark.parametrize("states,tips,sites,radius", [
    (4, 40, 2048, 4), (20, 20, 512, 3)])
def test_edge_scorer_matches_plain(cuda_device, states, tips, sites, radius):
    """Every ball group of one round, DNA and S = 20: -inf patterns equal,
    scores within 2e-5 on max(1, |s|), t3 within rtol 2e-3 / atol 2e-5
    (the JAX kernel test's bounds)."""
    if states == 4:
        _, start, chars, cfg, model = chip_smoke.search_inputs(
            cuda_device, tips=tips, sites=sites)
    else:
        start, chars, cfg, model = chip_smoke.protein_search_inputs(
            cuda_device, tips=tips, sites=sites)
    prog = search_fast.compile_spr(start, cfg, radius=radius)
    before = edge_score.edge_scores.launches
    r = chip_smoke.score_round_both(prog, model, chars, timed=False)
    torch.cuda.synchronize()
    assert edge_score.edge_scores.launches - before == r["launches"] > 0
    assert r["same_inf"] and r["finite"] > 100
    assert r["max_rel_err"] <= 2e-5
    assert r["t3_excess"] <= 0.0


def test_spr_round_launches_edge_scorer(cuda_device):
    _, start, chars, cfg, model = chip_smoke.search_inputs(
        cuda_device, tips=32, sites=1024)
    prog = search_fast.compile_spr(start, cfg, radius=3)
    tm = {}
    _, logl, applied = search_fast.spr_round(prog, model, chars, timings=tm)
    assert tm["scorer"] == "kernel" and tm["edge_score_launches"] > 0
    assert np.isfinite(logl) and applied > 0


@pytest.mark.parametrize("states,bl_scale", [(4, 1.0), (4, 30.0), (20, 1.0)])
def test_mma_kernel_matches_plain(cuda_device, states, bl_scale):
    """The tensor-core form on the cases it is built for: rows within
    chip_smoke.mma_bound of each site's largest entry where the scalers
    agree, scaling-compensated values within 2e-3 where a rescue flipped;
    and the same against the "fma" kernel."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, bl_scale=bl_scale,
        random_model=True)
    prog = program.vmem_prog
    before = dict(partials_tree.sweep.launches_by_mode)
    mma = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="mma")
    fma = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="fma")
    torch.cuda.synchronize()
    after = partials_tree.sweep.launches_by_mode
    assert after["mma"] == before["mma"] + 1
    assert after["fma"] == before["fma"] + 1
    plain = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
    for other in (plain, fma):
        rel, _, comp, _ = chip_smoke.compare_rows_site(mma[0], other[0],
                                                       mma[1], other[1])
        assert rel <= chip_smoke.mma_bound(prog.n_ops)
        assert comp <= chip_smoke.COMP_RTOL
    if bl_scale > 1:
        assert int(plain[1].max()) > 0


def test_mma_kernel_refuses_per_rate_scalers(cuda_device):
    newick = random_newick(16, np.random.default_rng(0))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 512, 0, cuda_device, per_rate=True)
    with pytest.raises(ValueError, match="per-site scalers only"):
        partials_tree.sweep(tip_b, pmatrix, program.vmem_prog, cfg, tb,
                            mode="mma")


@pytest.mark.parametrize("states", [4, 20])
def test_loglikelihood_mma_vs_dense_f64(cuda_device, states):
    """The bench's budget, 5e-6 relative, through the tensor-core form."""
    cfg, program, model, *args = engine.build_case(
        64, 4096, dtype=torch.float32, device=cuda_device, states=states,
        sweep_mode="mma")
    before = partials_tree.sweep.launches_by_mode["mma"]
    got = engine.loglikelihood(program, cfg, model, *args).item()
    assert partials_tree.sweep.launches_by_mode["mma"] == before + 1
    cfg, program, model, *args = engine.build_case(
        64, 4096, dtype=torch.float64, device=cuda_device, states=states,
        use_kernel=False)
    want = engine.loglikelihood(program, cfg, model, *args).item()
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) < 5e-6


@pytest.mark.parametrize("unit", mma_probe.UNITS)
@pytest.mark.parametrize("variant", range(len(mma_probe.VARIANTS)))
def test_probe_kernel_matches_plain(cuda_device, variant, unit):
    """Every variant on every unit against the plain chain, within
    CHAIN_TOL of the largest entry; all CTAs equal."""
    tb = 64
    a, b = mma_probe.probe_inputs(variant, tb, seed=variant,
                                  device=cuda_device)
    before = mma_probe.chain.launches
    got = mma_probe.chain(variant, unit, a, b, grid=5, nrep=64)
    torch.cuda.synchronize()
    assert mma_probe.chain.launches == before + 1
    want = mma_probe.chain_reference(a, b, 64, unit)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= mma_probe.CHAIN_TOL
    assert bool((got == got[0]).all())
