"""The CUDA kernels (both tree-sweep forms with f32 and bf16 pools and the
"fma" form's generic instantiation, edge scorer and its generic-state
form, matrix-unit probe, build-cache probe, construct probe: k0-k3 and
c0-c4) against their plain PyTorch versions, on the card; one
multi-partition round and one fit step on the kernel paths; the default
f64 config on the dense path.

Marked `cuda`: each test skips when torch.cuda.is_available() is False
(decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from libpll2_tpu_torch import engine, fit, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.ops import edge_score, partials_tree
from libpll2_tpu_torch.probes import cache as cache_probe
from libpll2_tpu_torch.probes import constructs as construct_probe
from libpll2_tpu_torch.probes import mma as mma_probe
from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rates", [4, 1, 3])
@pytest.mark.parametrize("bl_scale", [1.0, 30.0])
@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [2, 4, 10, 16, 20])
def test_kernel_matches_plain(cuda_device, states, per_rate, bl_scale, rates):
    """Every state count the "fma" kernel is built for, per-site and
    per-rate scalers, mild and heavy rescaling; rate counts 1 and 4 (the
    compile-time instantiations) and 3 (the run-time one, lanes padded to
    4).  CLV rows rtol 1e-5 (f32 sums in another order), scalers exact."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, per_rate=per_rate,
        bl_scale=bl_scale, random_model=True, rates=rates)
    prog = program.vmem_prog
    before = partials_tree.sweep.launches
    clv, scal = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
    torch.cuda.synchronize()
    assert partials_tree.sweep.launches == before + 1
    want_clv, want_scal = partials_tree.sweep_reference(tip_b, pmatrix, prog,
                                                        cfg, tb)
    torch.testing.assert_close(scal, want_scal, rtol=0, atol=0)
    torch.testing.assert_close(clv, want_clv, rtol=1e-5, atol=0)
    if bl_scale > 1:
        assert int(want_scal.max()) > 0


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("shape,tb", [
    ("random", 64), ("random", 32), ("caterpillar", 64), ("balanced", 32)])
def test_fma_carry_on_and_off_bit_equal(cuda_device, shape, tb, per_rate):
    """The "fma" kernel with parents handed on in registers and with every
    parent stored and reloaded: the same rows and scalers, bit for bit, at
    two site blocks; and both within 1e-5 of the plain version."""
    newick = {"random": random_newick(90, np.random.default_rng(3)),
              "caterpillar": chip_smoke.caterpillar(70),
              "balanced": balanced_newick(64)}[shape]
    cfg, program, pmatrix, tip_b, _tb = chip_smoke.sweep_inputs(
        newick, 4096, 11, cuda_device, bl_scale=20.0, per_rate=per_rate)
    tip_b = engine.block_tips(
        tip_b.permute(1, 0, 2).reshape(cfg.tips, -1), cfg, tb)
    prog = program.vmem_prog
    assert partials_tree.carry_flags(prog)[:, 2].sum() > 0
    on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="fma")
    off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="fma",
                              carry=False)
    torch.cuda.synchronize()
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    plain = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
    torch.testing.assert_close(on[1], plain[1], rtol=0, atol=0)
    torch.testing.assert_close(on[0], plain[0], rtol=1e-5, atol=0)
    assert int(plain[1].max()) > 0


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [2, 4, 5, 10, 16, 20, 32])
def test_bf16_kernels_match_plain(cuda_device, states, per_rate):
    """Both forms with a bf16 pool (every form that takes the case) against
    the plain version at bf16 on a scale-heavy caterpillar: rows within
    2^-7 of each site's largest entry (compensated where a rescue
    flipped), the register carry on and off bit-equal, f32 exports."""
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        chip_smoke.caterpillar(64), 2048, states, cuda_device,
        states=states, per_rate=per_rate, bl_scale=30.0, random_model=True,
        dtype=torch.bfloat16)
    prog = program.vmem_prog
    plain = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
    modes = [m for m in partials_tree.MODES
             if partials_tree.unsupported(prog, cfg, mode=m) is None]
    assert "fma" in modes
    for mode in modes:
        before = partials_tree.sweep.launches_bf16[mode]
        on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode=mode)
        off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode=mode,
                                  carry=False)
        torch.cuda.synchronize()
        assert partials_tree.sweep.launches_bf16[mode] == before + 2
        assert on[0].dtype == torch.float32
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
        rel, _, comp, _ = chip_smoke.compare_rows_site(on[0], plain[0],
                                                       on[1], plain[1])
        assert rel <= chip_smoke.BF16_ROW_BOUND
        assert comp <= chip_smoke.BF16_ROW_BOUND
    assert int(plain[1].max()) > 0


def test_loglikelihood_bf16_vs_dense_bf16(cuda_device):
    """The bf16 forward step through the form `choose` picks against the
    dense bf16 path on the same inputs: within chip_smoke.BF16_SLICE_RTOL
    (1e-6) relative."""
    cfg, program, model, *args = engine.build_case(
        128, 8192, dtype=torch.bfloat16, device=cuda_device)
    before = sum(partials_tree.sweep.launches_bf16.values())
    got = engine.loglikelihood(program, cfg, model, *args).item()
    assert sum(partials_tree.sweep.launches_bf16.values()) == before + 1
    dense = dataclasses.replace(cfg, use_kernel=False)
    want = engine.loglikelihood(program, dense, model, *args).item()
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) < chip_smoke.BF16_SLICE_RTOL


def test_loglikelihood_kernel_vs_dense_f64(cuda_device):
    """The bench's budget, 5e-6 relative, at 128 taxa x 8192 sites, through
    the form `choose` picks."""
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
    assert edge_score.edge_scores.launches - before \
        == len(r["forms"]) * r["launches"] > 0
    assert r["same_inf"] and r["finite"] > 100
    assert r["max_rel_err"] <= 2e-5
    assert r["t3_excess"] <= 0.0


@pytest.mark.parametrize("states,tips,sites,radius", [
    (4, 24, 4096, 3), (4, 16, 1000, 3), (20, 20, 512, 3)])
def test_edge_scorer_forms_match_plain(cuda_device, states, tips, sites,
                                       radius):
    """Both forms of the scorer kernel (the sumtable resident in a
    cluster's shared memory, 16-byte and 4-byte site loads; re-read in
    every pass) against the plain version, at chip_smoke's bounds; the
    resident form's shared memory as the host plans it."""
    from libpll2_tpu_torch import _build
    if states == 4:
        _t, start, chars, cfg, model = chip_smoke.search_inputs(
            cuda_device, tips=tips, sites=sites, seed=5)
    else:
        start, chars, cfg, model = chip_smoke.protein_search_inputs(
            cuda_device, tips=tips, sites=sites)
    prog = search_fast.compile_spr(start, cfg, radius=radius)
    T = prog.cfg_ext.sites_padded
    limit = _build.max_shared_memory(cuda_device)
    form, cluster = edge_score.plan(cfg.rate_cats, states, T, limit)
    assert form == "resident"
    for k in edge_score.CLUSTER_SIZES:
        assert _build.library().edge_score_resident_smem(
            cfg.rate_cats, states, T, k) == edge_score.resident_smem_bytes(
                cfg.rate_cats, states, T, k)
    before = dict(edge_score.edge_scores.launches_by_form)
    r = chip_smoke.score_round_both(prog, model, chars, timed=False)
    after = edge_score.edge_scores.launches_by_form
    assert r["forms"] == ("resident", "reread")
    assert after["resident"] - before["resident"] == r["launches"] > 0
    assert after["reread"] - before["reread"] == r["launches"]
    assert r["same_inf"] and r["finite"] > 0
    assert r["max_rel_err"] <= chip_smoke.SCORE_RTOL
    assert r["t3_excess"] <= 0.0


def test_edge_scorer_resident_refused_where_nothing_fits(cuda_device):
    """form="resident" raises where even eight CTAs cannot hold the
    sumtable; the planned form there is the re-reading one, which runs."""
    start, chars, cfg, model = chip_smoke.protein_search_inputs(
        cuda_device, tips=8, sites=5200)
    prog = search_fast.compile_spr(start, cfg, radius=2)
    r = chip_smoke.score_round_both(prog, model, chars, timed=False)
    assert r["form"] == "reread" and r["forms"] == ("reread",)
    assert r["same_inf"] and r["max_rel_err"] <= chip_smoke.SCORE_RTOL
    R, S, T = 4, 20, prog.cfg_ext.sites_padded
    z = torch.zeros
    args = (z((1, 2, R, S, T)), z((1, 2, T), dtype=torch.int32),
            z((2, R, S, T)), z((2, T), dtype=torch.int32), z((1, R, S, S)),
            z((1, 1, 12), dtype=torch.int32), z((1, 2), dtype=torch.int32),
            torch.ones(1), torch.eye(R * S), torch.eye(R * S),
            z((R * S, 2)), torch.ones(T))
    args = tuple(x.to(cuda_device) for x in args)
    with pytest.raises(ValueError, match="resident form cannot take"):
        edge_score.edge_scores(*args, newton_iters=1, log_thresh=-20.0,
                               form="resident")


def test_spr_round_launches_edge_scorer(cuda_device):
    _, start, chars, cfg, model = chip_smoke.search_inputs(
        cuda_device, tips=32, sites=1024)
    prog = search_fast.compile_spr(start, cfg, radius=3)
    tm = {}
    _, logl, applied = search_fast.spr_round(prog, model, chars, timings=tm)
    assert tm["scorer"] == "kernel" and tm["edge_score_launches"] > 0
    assert np.isfinite(logl) and applied > 0


@pytest.mark.parametrize("rates", [4, 3])
@pytest.mark.parametrize("bl_scale", [1.0, 30.0])
@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [3, 5, 6, 7, 9, 12, 17, 32])
def test_generic_kernel_matches_plain(cuda_device, states, per_rate,
                                      bl_scale, rates):
    """The "fma" form's generic instantiation (every SMAX bound: 8, 16,
    32) at state counts without one of their own, as
    test_kernel_matches_plain holds the specialised ones: CLV rows rtol
    1e-5, scalers exact, one generic launch."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, per_rate=per_rate,
        bl_scale=bl_scale, random_model=True, rates=rates)
    prog = program.vmem_prog
    assert partials_tree.generic(cfg)
    before = partials_tree.sweep.launches_generic
    clv, scal = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
    torch.cuda.synchronize()
    assert partials_tree.sweep.launches_generic == before + 1
    want_clv, want_scal = partials_tree.sweep_reference(tip_b, pmatrix, prog,
                                                        cfg, tb)
    torch.testing.assert_close(scal, want_scal, rtol=0, atol=0)
    torch.testing.assert_close(clv, want_clv, rtol=1e-5, atol=0)
    if bl_scale > 1:
        assert int(want_scal.max()) > 0


@pytest.mark.parametrize("states", [5, 32])
def test_generic_edge_scorer_matches_plain(cuda_device, states):
    """The scorer's generic-state form, both forms where the resident one
    is planned, at chip_smoke's bounds; the shared memory both forms need
    as the host computes it."""
    from libpll2_tpu_torch import _build
    _t, start, chars, cfg, model = chip_smoke.odd_search_inputs(
        cuda_device, states, tips=20, sites=512)
    prog = search_fast.compile_spr(start, cfg, radius=3)
    T = prog.cfg_ext.sites_padded
    lib = _build.library()
    for k in edge_score.CLUSTER_SIZES:
        assert lib.edge_score_resident_smem(4, states, T, k) == \
            edge_score.resident_smem_bytes(4, states, T, k)
    assert lib.edge_score_reread_smem(4, states) == \
        edge_score.reread_smem_bytes(4, states)
    before = edge_score.edge_scores.launches_generic
    r = chip_smoke.score_round_both(prog, model, chars, timed=False)
    assert edge_score.edge_scores.launches_generic - before \
        == len(r["forms"]) * r["launches"] > 0
    assert r["same_inf"] and r["finite"] > 100
    assert r["max_rel_err"] <= chip_smoke.SCORE_RTOL
    assert r["t3_excess"] <= 0.0


@pytest.mark.parametrize("block", [-1, -2])
@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("states", [8, 9, 16, 17, 32])
def test_generic_row_groups_at_their_edges(cuda_device, states, dtype,
                                           per_rate, block):
    """The generic form's row groups where they change (8 | 9 states: one
    group of two sites a thread to two groups of one and the j loop's
    bound 8 to 32; 16, specialised, beside 17: two groups to four), at the
    two smallest site blocks that fit (8 and 16 sites from 9 states on;
    16 and 32 at 8 states, where a thread holds two sites, and at the
    specialised 16), f32 and bf16 pools,
    per-site and per-rate rescues (branch lengths x 30): rows within 1e-5
    of plain (bf16 within 2^-7 of each site's largest entry), scalers
    exact, carry on and off bit-equal, and the rows at the other of the two
    blocks bit for bit (a column's rows do not depend on its CTA)."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, _tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, per_rate=per_rate,
        bl_scale=30.0, random_model=True, dtype=dtype)
    prog = program.vmem_prog
    tb = partials_tree.fitting_blocks(prog, cfg)[block]
    tip_b = engine.block_tips(
        tip_b.permute(1, 0, 2).reshape(cfg.tips, -1), cfg, tb)
    on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
    off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, carry=False)
    want = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
    torch.cuda.synchronize()
    assert int(want[1].max()) > 0
    torch.testing.assert_close(on[1], want[1], rtol=0, atol=0)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    if dtype == torch.bfloat16:
        rel, mism, comp, _ = chip_smoke.compare_rows_site(on[0], want[0],
                                                          on[1], want[1])
        assert mism == 0 and rel <= chip_smoke.BF16_ROW_BOUND
    else:
        torch.testing.assert_close(on[0], want[0], rtol=1e-5, atol=0)
    if partials_tree.generic(cfg):
        assert partials_tree.generic_groups(cfg) == (1 if states <= 8 else
                                                     2 if states <= 16 else 4)
        other = partials_tree.fitting_blocks(prog, cfg)[-3 - block]
        tips_o = engine.block_tips(
            tip_b.permute(1, 0, 2).reshape(cfg.tips, -1), cfg, other)
        got = partials_tree.sweep(tips_o, pmatrix, prog, cfg, other)
        for a, b in zip(got, on):
            assert torch.equal(unblock_rows(a), unblock_rows(b))


def unblock_rows(rows):
    """Sweep rows [E, NT, ..., TB] as [E, ..., NT * TB]."""
    moved = rows.movedim(1, -2)
    return moved.reshape(*moved.shape[:-2], -1)


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("states,rates", [(9, 32), (12, 20), (17, 16),
                                          (24, 9), (32, 12), (32, 32)])
def test_generic_row_groups_across_warps(cuda_device, states, rates, dtype,
                                         per_rate):
    """Many rates at many states: a site's G * lanes threads span two or
    four warps, so a per-site rescue ANDs the warps' words through shared
    memory (partials_tree.generic_spans_warps); per-rate rescues stay in a
    warp.  Rows against plain as above (branch lengths x 30), scalers
    exact, carry on and off bit-equal, one generic launch a call."""
    newick = random_newick(40, np.random.default_rng(states))
    cfg, program, pmatrix, tip_b, tb = chip_smoke.sweep_inputs(
        newick, 2048, states, cuda_device, states=states, per_rate=per_rate,
        bl_scale=30.0, random_model=True, rates=rates, dtype=dtype)
    prog = program.vmem_prog
    lanes = partials_tree.rate_lanes(rates)
    assert partials_tree.generic_groups(cfg) * lanes > 32
    assert partials_tree.generic_spans_warps(cfg) == (not per_rate)
    before = partials_tree.sweep.launches_generic
    on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb)
    off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, carry=False)
    want = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb)
    torch.cuda.synchronize()
    assert partials_tree.sweep.launches_generic == before + 2
    assert int(want[1].max()) > 0
    torch.testing.assert_close(on[1], want[1], rtol=0, atol=0)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    if dtype == torch.bfloat16:
        rel, mism, comp, _ = chip_smoke.compare_rows_site(on[0], want[0],
                                                          on[1], want[1])
        assert mism == 0 and rel <= chip_smoke.BF16_ROW_BOUND
    else:
        torch.testing.assert_close(on[0], want[0], rtol=1e-5, atol=0)


def test_generic_layout_sizes_match_the_host(cuda_device):
    """The row-group form's P layout and staging rule as the library
    computes them, against partials_tree's copies."""
    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch.config import PartitionConfig
    lib = _build.library()
    for states in (3, 5, 9, 12, 17, 24, 32):
        for rates in (1, 3, 4, 8, 16, 32):
            cfg = PartitionConfig(tips=4, clv_buffers=2, states=states,
                                  sites=64, rate_matrices=1, prob_matrices=5,
                                  rate_cats=rates, scale_buffers=2,
                                  dtype=torch.float32)
            groups = partials_tree.generic_groups(cfg)
            if not groups:
                continue
            assert lib.tree_sweep_generic_matrix_floats(rates, states,
                                                        groups) == \
                partials_tree.generic_matrix_floats(cfg)
            assert bool(lib.tree_sweep_generic_staged(rates, states,
                                                      groups)) == \
                partials_tree.generic_staged(cfg)


@pytest.mark.parametrize("trim", [0, 2])
def test_generic_scorer_four_sites_and_one(cuda_device, trim):
    """The scorer's generic form on every chunk of a 5-state round: at the
    round's own width (the later passes four sites a thread) and with two
    sites cut off every row (not a multiple of 4: one site a thread),
    against the plain version at chip_smoke's bounds."""
    from libpll2_tpu_torch.probes import variants
    inputs = chip_smoke.odd_search_inputs(cuda_device, 5, tips=24,
                                          sites=1024)
    checked = 0
    for args, log_thresh in variants.round_chunks(cuda_device, inputs):
        (away, away_s, base, base_s, halves, ops, rows, t0, lbd, rbd, xw,
         pw) = args
        T_ = pw.shape[0] - trim
        args = (away[..., :T_].contiguous(), away_s[..., :T_].contiguous(),
                base[..., :T_].contiguous(), base_s[..., :T_].contiguous(),
                halves, ops, rows, t0, lbd, rbd, xw, pw[:T_].contiguous())
        kw = dict(newton_iters=3, log_thresh=log_thresh)
        for form in ("resident", "reread"):
            got = edge_score.edge_scores(*args, form=form, **kw)
            want = edge_score.edge_scores_reference(*args, **kw)
            valid = (ops[..., edge_score.OP_VALID] == 1).cpu().numpy()
            same, fin, err, rel, excess, _ = chip_smoke.compare_scores(
                got, want, valid)
            assert same and rel <= chip_smoke.SCORE_RTOL and excess <= 0.0
            checked += fin
    assert checked > 100


def test_default_f64_runs_dense_on_the_card(cuda_device):
    """The default config (f64, use_kernel None) on the card: the dense
    path, equal to the explicit dense call bit for bit, one warning naming
    the reason, no tree-sweep launch; use_kernel=True still raises."""
    import warnings
    cfg, program, model, bl, *site = engine.build_case(
        64, 4096, dtype=torch.float64, device=cuda_device)
    assert cfg.use_kernel is None
    before = partials_tree.sweep.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = engine.loglikelihood(program, cfg, model, bl, *site)
    torch.cuda.synchronize()
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]
    assert len(msgs) == 1 and "f32 or bf16" in msgs[0]
    assert partials_tree.sweep.launches == before
    dense = engine.loglikelihood(
        program, dataclasses.replace(cfg, use_kernel=False), model, bl,
        *site)
    assert torch.equal(got, dense) and got.device.type == "cuda"
    with pytest.raises(ValueError, match="f32 or bf16"):
        engine.loglikelihood(program, dataclasses.replace(
            cfg, use_kernel=True), model, bl, *site)


def test_generic_spr_round_on_the_kernel(cuda_device):
    """A 5-state round on the card takes the scorer kernel (the gate and
    the kernel agree) and applies moves."""
    _t, start, chars, cfg, model = chip_smoke.odd_search_inputs(
        cuda_device, 5, tips=32, sites=1024)
    prog = search_fast.compile_spr(start, cfg, radius=3)
    tm = {}
    before = edge_score.edge_scores.launches_generic
    _, logl, applied = search_fast.spr_round(prog, model, chars, timings=tm)
    assert tm["scorer"] == "kernel" and tm["edge_score_launches"] > 0
    assert edge_score.edge_scores.launches_generic - before \
        == tm["edge_score_launches"]
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


@pytest.mark.parametrize("shape,tb", [
    ("random", 256), ("random", 32), ("caterpillar", 64), ("balanced", 128)])
def test_mma_carry_on_and_off_bit_equal(cuda_device, shape, tb):
    """The small-span kernel with parents handed on in registers and with
    every parent stored and reloaded: the same rows and scalers, bit for
    bit, at every site block; and both within the bound of the plain
    version."""
    newick = {"random": random_newick(90, np.random.default_rng(3)),
              "caterpillar": chip_smoke.caterpillar(70),
              "balanced": balanced_newick(64)}[shape]
    cfg, program, pmatrix, tip_b, _tb = chip_smoke.sweep_inputs(
        newick, 4096, 11, cuda_device, bl_scale=20.0)
    tip_b = engine.block_tips(
        tip_b.permute(1, 0, 2).reshape(cfg.tips, -1), cfg, tb)
    prog = program.vmem_prog
    flags = partials_tree.carry_flags(prog)
    assert flags[:, 2].sum() > 0
    on = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="mma")
    off = partials_tree.sweep(tip_b, pmatrix, prog, cfg, tb, mode="mma",
                              carry=False)
    torch.cuda.synchronize()
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    plain = partials_tree.sweep_reference(tip_b, pmatrix, prog, cfg, tb,
                                          carry=True)
    rel, _, comp, _ = chip_smoke.compare_rows_site(on[0], plain[0], on[1],
                                                   plain[1])
    assert rel <= chip_smoke.mma_bound(prog.n_ops)
    assert comp <= chip_smoke.COMP_RTOL
    assert int(plain[1].max()) > 0


def test_mma_fragments_kernel_matches_plain(cuda_device):
    """The prologue kernel that splits P into TF32 (hi, lo) in fragment
    order, in both layouts, against its plain version: bit for bit."""
    from libpll2_tpu_torch.config import PartitionConfig
    for states in (4, 20):
        cfg = PartitionConfig(tips=4, clv_buffers=2, states=states, sites=8,
                              rate_matrices=1, prob_matrices=5, rate_cats=4,
                              scale_buffers=2, dtype=torch.float32)
        pm = torch.as_tensor(np.random.default_rng(states).uniform(
            0, 1, (7, 4, states, states)).astype(np.float32),
            device=cuda_device)
        got = partials_tree.pmatrix_fragments(pm, cfg)
        want = partials_tree.pmatrix_fragments_reference(pm, cfg)
        assert got.shape == want.shape and torch.equal(got, want)


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


@pytest.mark.parametrize("variant,unit", [
    (v, u) for v in range(len(mma_probe.VARIANTS))
    for u in mma_probe.units_of(v)])
def test_probe_kernel_matches_plain(cuda_device, variant, unit):
    """Every variant on every unit against the plain products, every slot
    within CHAIN_TOL of the slot's largest entry; all CTAs equal; the
    launch counted under the form that ran; the shared memory the C side
    asks for is what the wrapper checked."""
    from libpll2_tpu_torch import _build
    tb = 64
    sites_on_m = mma_probe.VARIANTS[variant].sites_on_m
    a, b = mma_probe.probe_inputs(variant, tb, seed=variant,
                                  device=cuda_device)
    form = mma_probe.form(variant, unit)
    before = mma_probe.chain.launches, dict(mma_probe.chain.launches_by_form)
    got = mma_probe.chain(variant, unit, a, b, grid=5, nrep=64)
    torch.cuda.synchronize()
    assert mma_probe.chain.launches == before[0] + 1
    assert mma_probe.chain.launches_by_form == {
        f: n + (f == form) for f, n in before[1].items()}
    want = mma_probe.chain_reference(a, b, 64, unit, sites_on_m)
    assert got.shape == (5,) + tuple(want.shape)
    for s in range(mma_probe.NBUF):
        err = ((got[:, s] - want[s]).abs().max()
               / want[s].abs().max()).item()
        assert err <= mma_probe.CHAIN_TOL, (s, err)
    assert bool((got == got[0]).all())
    assert _build.library().mma_probe_smem(
        variant, mma_probe.UNITS.index(unit), tb) == \
        mma_probe.smem_bytes(variant, unit, tb)


def test_cache_probe_kernel_matches_plain(cuda_device):
    """One exact doubling and one rounded addition in both: equal bits, on
    the 16-byte path, on an offset view (not 16-byte aligned: one element
    a thread) and on a length that is not a multiple of 4 (a tail)."""
    x = cache_probe.probe_input(seed=5, device=cuda_device)
    before = cache_probe.scale_shift.launches
    got = cache_probe.scale_shift(x)
    torch.cuda.synchronize()
    assert cache_probe.scale_shift.launches == before + 1
    assert torch.equal(got, cache_probe.scale_shift_reference(x))
    with pytest.raises(ValueError, match="contiguous"):
        cache_probe.scale_shift(x.t())
    flat = x.flatten()
    for view in (flat[1:4094], flat[4:4099], flat[:7], flat[3:4]):
        assert view.is_contiguous()
        got = cache_probe.scale_shift(view)
        torch.cuda.synchronize()
        assert torch.equal(got, cache_probe.scale_shift_reference(view))
    assert flat[1:].data_ptr() % 16 != 0
    assert cache_probe.scale_shift.launches == before + 5


@pytest.mark.parametrize("tb", [32, 256])
@pytest.mark.parametrize("variant", construct_probe.VARIANTS)
def test_construct_probe_kernel_matches_plain(cuda_device, variant, tb):
    """Relative to each site's largest entry, within
    construct_probe.tolerance (TF32 operands for c0, the compensated
    split's bound for c1-c3); c3's scalers equal or compensated."""
    n_ops = 96
    p, pool = construct_probe.probe_inputs(tb, seed=tb, device=cuda_device)
    before = construct_probe.constructs.launches
    out, scal = construct_probe.constructs(variant, p, pool, n_ops, grid=3)
    torch.cuda.synchronize()
    assert construct_probe.constructs.launches == before + 1
    assert bool((out == out[0]).all()) and bool((scal == scal[0]).all())
    want = construct_probe.constructs_reference(variant, p, pool, n_ops)
    err, mismatches = construct_probe.site_error((out[0], scal[0]), want)
    assert err <= construct_probe.tolerance(variant, n_ops)
    assert mismatches <= 2
    if variant == "c3":
        assert int(want[1].max()) >= 2            # the rescue fired


@pytest.mark.parametrize("n_ops", [0, 1, 37, 128])
@pytest.mark.parametrize("sites", [64, 4096])
@pytest.mark.parametrize("variant", construct_probe.K_VARIANTS)
def test_static2_kernel_matches_plain(cuda_device, variant, sites, n_ops):
    """tools/static2probe.py's k0-k3 on wgmma (one tile; 64 tiles over
    fewer CTAs than the card holds) against static2_reference, relative to
    each site's largest entry, within 2e-5 + 4e-7 per op (bf16 products
    exact in f32, one truncating accumulator); one launch a call."""
    pcm, pool = construct_probe.static2_inputs(sites, seed=sites + n_ops,
                                               device=cuda_device)
    before = construct_probe.static2.launches
    got = construct_probe.static2(variant, pcm, pool, n_ops)
    torch.cuda.synchronize()
    assert construct_probe.static2.launches == before + 1
    assert got.shape == (16, sites) and got.dtype == torch.float32
    want = construct_probe.static2_reference(variant, pcm, pool, n_ops)
    assert construct_probe.static2_error(got, want) <= \
        construct_probe.static2_tolerance(n_ops)


def test_static2_smem_a_matches_plain(cuda_device):
    """probes/variants.py's static2_smem_a (the site tile in shared memory,
    read by descriptors) against the plain version within the register
    form's bound, for every variant whose A tiles fit beside pcm."""
    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch.probes import variants
    lib, _info = variants.variant_library("static2_smem_a")
    limit = _build.max_shared_memory(cuda_device)
    n_ops, sites = 37, 4096
    pcm, pool = construct_probe.static2_inputs(sites, seed=9,
                                               device=cuda_device)
    ran = []
    for variant in construct_probe.K_VARIANTS:
        if construct_probe.static2_smem_bytes(variant, False) > limit:
            continue
        got = construct_probe.static2(variant, pcm, pool, n_ops, lib=lib)
        want = construct_probe.static2_reference(variant, pcm, pool, n_ops)
        assert construct_probe.static2_error(got, want) <= \
            construct_probe.static2_tolerance(n_ops)
        ran.append(variant)
    assert ran == ["k0", "k1", "k2"]


def test_spr_round_multi_on_the_kernel_path(cuda_device):
    """One two-partition round: each partition's score phase launches the
    edge scorer, and the round's total is the exact total of the new
    trees."""
    _truth, start, chars, cfg, model = chip_smoke.search_inputs(
        cuda_device, tips=32, sites=512)
    progs = search_fast.compile_spr_multi(start, [cfg, cfg], radius=3)
    tm = {}
    new, logl, applied = search_fast.spr_round_multi(
        progs, [model, model], [chars, chars], timings=tm)
    assert tm["scorer"] == ["kernel", "kernel"]
    assert all(n > 0 for n in tm["edge_score_launches"])
    assert applied > 0 and np.isfinite(logl)
    exact = search_fast._total_logl(new, [model, model], [chars, chars])
    assert abs(logl - exact) <= 5e-6 * abs(exact)


def test_fit_step_on_the_kernel_path(cuda_device):
    """One Adam step with the CUDA sweep in the forward pass; its gradient
    within 1e-4 (of each leaf's largest entry) of the dense f64 path's."""
    case = engine.build_case(32, 4096, dtype=torch.float32,
                             device=cuda_device)
    cfg, program, _model, bl, tipchars, pw, inv = case
    full = engine.compile_tree_full(
        T.parse_newick_string(balanced_newick(32)), cfg)
    rates = np.array([0.2, 0.6, 1.1, 2.1])
    params = fit.pack([[1.5, 1.5, 0.8, 1.2, 2.5, 1.0]], [[0.3, 0.2, 0.3, 0.2]],
                      bl, alpha=0.7, dtype=torch.float32, device=cuda_device)
    leaves = fit.FitParams(*(x.clone().requires_grad_() for x in params))
    before = partials_tree.sweep.launches
    fit.loglikelihood_fn(program, cfg, leaves, rates, tipchars, pw, inv,
                         fit_alpha=True, full_program=full).backward()
    assert partials_tree.sweep.launches == before + 1
    _, ref = chip_smoke.dense_f64_gradient(case, params, rates, cuda_device)
    for leaf, want in zip(leaves, ref):
        gap = (leaf.grad.double() - want).abs().max() / want.abs().max()
        assert gap.item() < 1e-4
    out = fit.fit_model(program, cfg, params, rates, tipchars, pw, inv,
                        steps=2, lr=0.02, fit_alpha=True, full_program=full)
    assert out.logl[1] > out.logl[0] and bool(torch.isfinite(out.grad_norm))
    # no FullTreeProgram on the card: the dense path under use_kernel=None,
    # warned, no sweep launch (R13); refused under use_kernel=True
    before = partials_tree.sweep.launches
    with pytest.warns(UserWarning, match="autograd"):
        dense = fit.fit_model(program, cfg, params, rates, tipchars, pw, inv,
                              steps=1)
    assert partials_tree.sweep.launches == before
    assert bool(torch.isfinite(dense.logl).all())
    with pytest.raises(ValueError, match="full_program"):
        fit.fit_model(program, dataclasses.replace(cfg, use_kernel=True),
                      params, rates, tipchars, pw, inv, steps=1)
