"""The port at state counts without a kernel instantiation of their own
(libpll-2's any-state partitions: 5-state DNA with gaps, Dayhoff-6,
multistate morphology up to 32 states) against the JAX package on the CPU.

  * the tree sweep's plain version (partials_tree.sweep_reference, which
    the CUDA kernels are held to on the card) against the JAX package's
    static Pallas kernel in interpret mode, at S in {3, 5, 6, 32}, per-site
    and per-rate scalers, on a scale-heavy caterpillar: scaler rows
    exactly; CLV rows relative to the largest entry of their site, each
    side within 1e-6 of the f64 sweep (scaling-compensated; measured
    3.9e-7 to 7.7e-7 for the port, 4.0e-7 to 8.1e-7 for the Pallas kernel,
    which forms f32 products from bf16 split terms), so the two within
    2e-6 of each other (measured up to 1.3e-6 over the 22 ops);
  * the edge scorer's plain version against the JAX Pallas scorer in
    interpret mode, each behind its package's _score_group: at S = 5 at
    tests/test_edge_score_kernel.py's bounds (scores 2e-5 on max(1, |s|),
    t3 rtol 2e-3 / atol 2e-5).  At S = 32 the sumtable's sum over 128
    eigen-terms cancels, and in f32 both scorers lie further from the f64
    result than from each other's bound (measured on max(1, |s|): the
    port's 7.2e-5, the Pallas kernel's 3.0e-4), so both are held to the
    JAX package's f64 scorer instead: scores within 2e-4 (the port) and
    6e-4 (the Pallas kernel), t3 at rtol 2e-3 / atol 2e-5;
  * the slice at S = 5: engine.loglikelihood (dense f64, rtol 1e-9; the
    f32 tree sweep's plain version, within 5e-6 of the JAX f64 value, the
    card's budget against dense f64), one optimize_root_branch and one
    spr_round in f64 (rtol 1e-9), the model carried across by
    convert.model_from_jax;
  * the gate: for every S from 2 to 32, neither kernel refuses a small
    case for its state count, and search_fast.use_edge_kernel on a CUDA
    device answers as edge_score.unsupported does (a device object, no
    launch); where the scorer refuses a case for shared memory the gate
    returns False, or raises when the kernel was asked for; the padded
    tips hold the gap mask as an int32 (-1 at 32 states).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import search_fast as jsf
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.ops import partials_pallas_tree as ppt
from libpll2_tpu.ops import pmatrix as jpmatrix
from libpll2_tpu_torch import convert, engine, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import gap_state_int32
from libpll2_tpu_torch.ops import edge_score, partials_tree
from libpll2_tpu_torch.tree.generate import random_newick, random_tipchars

from .test_torch_host import caterpillar_newick
from .test_torch_search import DTYPES, group_scores, make_case

TB = 128
CPU = torch.device("cpu")


def random_model(states, seed):
    """GTR exchangeabilities and frequencies for `states` states."""
    rng = np.random.default_rng(1000 + seed)
    subst = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    subst[-1] = 1.0
    return subst, rng.dirichlet(np.full(states, 5.0))


def configs(tree, states, sites, **kw):
    n = tree.tip_count
    common = dict(tips=n, clv_buffers=tree.inner_count, states=states,
                  sites=sites, rate_matrices=1, prob_matrices=2 * n - 3,
                  rate_cats=4, scale_buffers=tree.inner_count, **kw)
    return common


def sweep_build(states, per_rate, seed, n=24, sites=256, bl_scale=30.0):
    """Both packages' programs plus shared numpy inputs: blocked tips
    [NT, tips, TB] and the JAX f32 P-matrix buffer, on an n-taxon
    caterpillar (deep enough for 3-state sites to rescue)."""
    rng = np.random.default_rng(seed)
    newick = caterpillar_newick(n)
    jt, pt = jtree.parse_newick_string(newick), T.parse_newick_string(newick)
    common = configs(pt, states, sites, per_rate_scalers=per_rate)
    jcfg = JConfig(**common, dtype=jnp.float32)
    pcfg = PartitionConfig(**common, dtype=torch.float32)
    jprog = jengine.compile_tree(jt, jcfg)
    pprog = engine.compile_tree(pt, pcfg)
    subst, freqs = random_model(states, seed)
    model = jengine.make_model([subst], [freqs],
                               pll.compute_gamma_cats(0.8, 4),
                               dtype=jnp.float32)
    tipchars = jengine.pad_tipchars(
        random_tipchars(n, sites, rng, states=states), jcfg)
    nt = jcfg.sites_padded // TB
    tip_b = np.ascontiguousarray(
        tipchars.reshape(n, nt, TB).transpose(1, 0, 2))
    num_slots = int(jprog.pmatrix_indices.max()) + 1
    new = jpmatrix.compute_pmatrices(
        jnp.asarray(jprog.default_branch_lengths * bl_scale, jnp.float32),
        model.eigenvals, model.eigenvecs, model.inv_eigenvecs, model.rates,
        model.prop_invar, model.params_indices, dtype=jnp.float32)
    pmats = jnp.zeros((num_slots, 4, states, states), jnp.float32).at[
        jnp.asarray(jprog.pmatrix_indices)].set(new)
    return jcfg, jprog, pcfg, pprog, tip_b, np.array(pmats)


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [3, 5, 6, 32])
def test_sweep_reference_matches_static(states, per_rate):
    jcfg, jprog, pcfg, pprog, tip_b, pmats = sweep_build(states, per_rate,
                                                         states)
    assert partials_tree.generic(pcfg)
    assert partials_tree.unsupported(pprog.vmem_prog, pcfg) is None
    want = ppt.sweep_static(jnp.asarray(tip_b), jnp.asarray(pmats),
                            jprog.vmem_prog, jcfg, TB, interpret=True)
    clv, scal = partials_tree.sweep_reference(
        torch.as_tensor(tip_b), torch.as_tensor(pmats), pprog.vmem_prog,
        pcfg, TB)
    assert scal.shape[2] == (4 if per_rate else 1)
    assert int(scal.max()) > 0                 # rescues fired
    np.testing.assert_array_equal(scal.numpy(), np.asarray(want[1]))
    # the f64 sweep rescues at another threshold: compare its rows with
    # the f32 rows times 2^(-30 * scaler)
    c64, _ = partials_tree.sweep_reference(
        torch.as_tensor(tip_b), torch.as_tensor(pmats).double(),
        pprog.vmem_prog, dataclasses.replace(pcfg, dtype=torch.float64), TB)
    exact = c64.numpy()
    comp = np.exp2(-30.0 * scal.double().numpy()[:, :, :, None, :])
    got, ref = clv.double().numpy(), np.asarray(want[0], np.float64)
    # [E, NT, R, S, TB]: relative to the largest entry of each site
    mag = np.abs(exact).max(axis=(2, 3), keepdims=True)
    assert (np.abs(got * comp - exact) / mag).max() <= 1e-6
    assert (np.abs(ref * comp - exact) / mag).max() <= 1e-6
    assert (np.abs(got - ref) * comp / mag).max() <= 2e-6


def assert_scores_close(got, want, valid, score_rtol):
    """Finite scores on max(1, |s|) and t3 at the R3 bounds; returns the
    slots compared."""
    (s, t3), (ws, wt3) = got, want
    assert np.all(np.isneginf(s[~valid]))
    np.testing.assert_array_equal(np.isneginf(s[valid]),
                                  np.isneginf(ws[valid]))
    fin = valid & np.isfinite(s) & np.isfinite(ws)
    rel = np.abs(s[fin] - ws[fin]) / np.maximum(1.0, np.abs(ws[fin]))
    assert rel.max() <= score_rtol, rel.max()
    np.testing.assert_allclose(t3[fin], wt3[fin], rtol=2e-3, atol=2e-5)
    return int(fin.sum())


@pytest.mark.parametrize("states", [5, 32])
def test_edge_scorer_plain_vs_pallas_interpret(states):
    """The plain scorer (edge_scores on CPU tensors) against the JAX Pallas
    scorer in interpret mode, each behind its package's _score_group; at
    S = 32 both against the JAX f64 scorer (module docstring)."""
    c = odd_case(states, dt="f32")
    assert edge_score.unsupported(4, states) is None
    before = edge_score.edge_scores.launches
    groups = group_scores(c, use_kernel=True)
    compared = 0
    if states == 5:
        for valid, got, want in groups:
            compared += assert_scores_close(got, want, valid, 2e-5)
    else:
        exact = group_scores(odd_case(states, dt="f64"), use_kernel=False)
        for (valid, got, pallas), (_, _, want) in zip(groups, exact):
            compared += assert_scores_close(got, want, valid, 2e-4)
            assert_scores_close(pallas, want, valid, 6e-4)
    assert compared > 100
    assert edge_score.edge_scores.launches == before     # no kernel on CPU


def odd_case(states, n=12, sites=256, seed=5, dt="f64", start_seed=9):
    """test_torch_search.make_case at `states` states under random_model."""
    subst, freqs = random_model(states, seed)
    return make_case(n, sites, seed, dt, start_seed, subst, freqs)


def forward_inputs(c, program, cfg, xp, dtype):
    """(branch lengths, tipchars, pattern weights, invariant) of the start
    tree for one package (xp: jnp or a torch-tensor maker)."""
    n = c.ptree.tip_count
    raw = np.zeros((n, cfg.sites), dtype=np.uint64)
    for node in c.ptree.nodes[:n]:
        raw[node.clv_index] = c.chars[node.label]
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites] = 1.0
    return (xp(program.default_branch_lengths, dtype),
            xp(engine.pad_tipchars(raw, cfg), None), xp(pw, dtype),
            xp(np.full(cfg.sites_padded, -1, np.int32), None))


def jx(x, dtype):
    return jnp.asarray(x, dtype)


def px(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def odd5():
    """The S = 5 slice in f64: both packages' forward programs and inputs
    on the start tree."""
    c = odd_case(5)
    jprog = jengine.compile_tree(c.jtree, c.jcfg)
    pprog = engine.compile_tree(c.ptree, c.pcfg)
    assert convert.program_mismatches(pprog, jprog) == []
    return (c, jprog, pprog,
            forward_inputs(c, jprog, c.pcfg, jx, jnp.float64),
            forward_inputs(c, pprog, c.pcfg, px, torch.float64))


def test_slice_loglikelihood(odd5):
    c, jprog, pprog, jargs, pargs = odd5
    want = float(jengine.loglikelihood(jprog, c.jcfg, c.jmodel, *jargs))
    got = engine.loglikelihood(pprog, c.pcfg, c.pmodel, *pargs).item()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # f32 through the tree sweep's plain version (the kernel path's
    # control flow on the CPU: kernel_choice takes the generic "fma" form)
    cfg32 = dataclasses.replace(c.pcfg, dtype=torch.float32, use_kernel=True)
    assert engine.kernel_choice(pprog, cfg32, CPU)[1] == "fma"
    model32 = convert.model_from_jax(
        {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in convert.model_arrays(c.pmodel).items()}, device="cpu")
    bl, tips, pw, inv = pargs
    got32 = engine.loglikelihood(pprog, cfg32, model32, bl.float(), tips,
                                 pw.float(), inv).item()
    assert abs(got32 - want) <= 5e-6 * abs(want)


def test_slice_optimize_root_branch(odd5):
    c, jprog, pprog, jargs, pargs = odd5
    jbl, jl = jengine.optimize_root_branch(jprog, c.jcfg, c.jmodel, *jargs)
    pbl, pl = engine.optimize_root_branch(pprog, c.pcfg, c.pmodel, *pargs)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-9)
    np.testing.assert_allclose(pbl.numpy(), np.asarray(jbl), rtol=1e-9)


def test_slice_spr_round(odd5):
    c = odd5[0]
    jp = jsf.compile_spr(c.jtree, c.jcfg, radius=3)
    pp = search_fast.compile_spr(c.ptree, c.pcfg, radius=3)
    _jnew, jl, ja = jsf.spr_round(jp, c.jmodel, c.chars)
    _pnew, pl, pa = search_fast.spr_round(pp, c.pmodel, c.chars)
    assert pa == ja > 0
    np.testing.assert_allclose(pl, jl, rtol=1e-9)


def gate_case(states, rate_cats=4, n=6, sites=64):
    tree = T.parse_newick_string(random_newick(n, np.random.default_rng(0)))
    cfg = PartitionConfig(**{**configs(tree, states, sites),
                             "rate_cats": rate_cats},
                          dtype=torch.float32)
    return cfg, engine.compile_tree(tree, cfg).vmem_prog


@pytest.mark.parametrize("states", range(2, 33))
def test_kernels_take_every_state_count(states):
    """Neither kernel refuses a small case for its state count, and the
    SPR gate on a CUDA device answers as the scorer does: an SPR round
    on the card cannot launch into the scorer's refusal."""
    cfg, prog = gate_case(states)
    assert partials_tree.unsupported(prog, cfg, mode="fma") is None
    assert partials_tree.choose(prog, cfg)[1] == "fma"
    reason = edge_score.unsupported(cfg.rate_cats, states)
    assert reason is None
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32)
    cuda = torch.device("cuda")
    assert search_fast.use_edge_kernel(cfg, inv, cuda) is True
    assert search_fast.use_edge_kernel(cfg, inv, CPU) is False
    kernel_on = dataclasses.replace(cfg, use_kernel=True)
    assert search_fast.use_edge_kernel(kernel_on, inv, CPU) is True
    # the padding columns hold the gap mask as an int32 (all ones, -1, at
    # 32 states) and decode to every state
    pad = engine.pad_tipchars(np.zeros((cfg.tips, 0), np.uint64), cfg)
    assert pad.dtype == np.int32
    assert (pad == gap_state_int32(states)).all()
    decoded = engine.expand_tipchars(torch.as_tensor(pad[:1, :1]), states,
                                     torch.float64)
    assert decoded.sum().item() == states


def test_gate_follows_the_scorers_shared_memory():
    """At 32 rates and 32 states neither scorer form fits an H100's
    shared memory: the scorer says why, the gate takes the plain scorer
    under use_kernel=None and raises under use_kernel=True; the sweep
    names the bytes it would need where its pool does not fit.  (At 16
    rates the generic form fits since its pass 0 holds the columns in
    registers.)"""
    cfg, prog = gate_case(32, rate_cats=32)
    reason = edge_score.unsupported(32, 32)
    assert reason is not None and "bytes of shared memory" in reason
    assert edge_score.reread_smem_bytes(32, 32) > partials_tree.SMEM_LIMIT
    assert edge_score.unsupported(16, 32) is None
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32)
    with pytest.warns(UserWarning, match="bytes of shared memory"):
        assert search_fast.use_edge_kernel(cfg, inv, torch.device("cuda")) \
            is False
    with pytest.warns(UserWarning, match="plain scorer prices"):
        assert search_fast.plain_scorer_reason(
            cfg, inv, torch.device("cuda")) == reason
    with pytest.raises(ValueError, match="bytes of shared memory"):
        search_fast.use_edge_kernel(dataclasses.replace(cfg, use_kernel=True),
                                    inv, torch.device("cuda"))
    small = partials_tree.unsupported(prog, cfg, smem_limit=4096)
    assert small is not None and "bytes of shared memory" in small
    assert partials_tree.unsupported(prog, cfg) is None


def test_round_records_why_the_plain_scorer_ran(odd5):
    """A round's timings name the reason its slots went to the plain
    scorer (here f64, outside the scorer's contract); the gate finds no
    reason where the scorer runs."""
    c = odd5[0]
    pp = search_fast.compile_spr(c.ptree, c.pcfg, radius=3)
    tm = {}
    search_fast.spr_round(pp, c.pmodel, c.chars, timings=tm)
    assert tm["scorer"] == "plain"
    assert "contract" in tm["scorer_reason"]
    cfg32 = dataclasses.replace(pp.cfg_ext, dtype=torch.float32,
                                use_kernel=True)
    inv = torch.full((cfg32.sites_padded,), -1, dtype=torch.int32)
    assert search_fast.plain_scorer_reason(cfg32, inv, CPU) is None
    off = dataclasses.replace(cfg32, use_kernel=False)
    assert search_fast.plain_scorer_reason(off, inv, CPU) == \
        "use_kernel=False"
