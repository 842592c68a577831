"""The SPR search of the port against libpll2_tpu's search_fast on the
CPU: the same simulated alignment, start tree and model (carried across by
convert.model_from_jax) go through both packages.

Tolerances: f64 paths at rtol 1e-9 (the same formulas in f64, summed in
another order); the edge scorer's plain version against the JAX Pallas
kernel in interpret mode at the JAX test's f32 bounds (scores 2e-5 on
max(1, |s|), t3 rtol 2e-3 / atol 2e-5, tests/test_edge_score_kernel.py);
a short f64 climb ends within 1e-8 (relative) of the JAX climb's logL."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import search_fast as jsf
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.constants import AB_LEWIS
from libpll2_tpu.ops import edge_score_pallas as jesp
from libpll2_tpu_torch import convert, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import edge_score
from libpll2_tpu_torch.tree.compare import rf_distance
from libpll2_tpu_torch.tree.generate import (balanced_newick, random_newick,
                                             simulate_alignment)

SUBST = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
FREQS = [0.28, 0.24, 0.22, 0.26]
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


@dataclasses.dataclass
class Case:
    jtree: object
    ptree: object
    chars: dict
    jcfg: object
    pcfg: object
    jmodel: object
    pmodel: object


def make_case(n=12, sites=256, seed=5, dt="f64", start_seed=9, subst=SUBST,
              freqs=FREQS, **cfg_kw):
    """Simulated alignment down a random truth tree under GTR (`subst`,
    `freqs`; the state count is len(freqs)) + Gamma(0.8); a random start
    tree over the same labels, parsed by both packages; the port's model
    carried across from the JAX one."""
    rng = np.random.default_rng(seed)
    rates = pll.compute_gamma_cats(0.8, 4)
    truth = T.parse_newick_string(random_newick(n, rng))
    chars = simulate_alignment(truth, sites, rng, subst, freqs, rates)
    start = random_newick(n, np.random.default_rng(start_seed))
    jt, pt = jtree.parse_newick_string(start), T.parse_newick_string(start)
    common = dict(tips=n, clv_buffers=pt.inner_count, states=len(freqs),
                  sites=sites, rate_matrices=1, prob_matrices=2 * n - 3,
                  rate_cats=4, scale_buffers=pt.inner_count, **cfg_kw)
    jdt, pdt = DTYPES[dt]
    jmodel = jengine.make_model([subst], [freqs], rates, dtype=jdt)
    return Case(jt, pt, chars, JConfig(**common, dtype=jdt),
                PartitionConfig(**common, dtype=pdt), jmodel,
                convert.model_from_jax(convert.model_arrays(jmodel),
                                       device="cpu"))


def newick(tree):
    return T.export_newick(tree.vroot, precision=None)


@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("n,seed", [(12, 0), (17, 1)])
def test_compile_spr_byte_equal(radius, n, seed):
    c = make_case(n=n, start_seed=seed)
    ref = jsf.compile_spr(c.jtree, c.jcfg, radius=radius)
    got = search_fast.compile_spr(c.ptree, c.pcfg, radius=radius)
    assert convert.spr_program_mismatches(got, ref) == []
    if radius is not None:
        # pinned shapes (a hill-climb's recompile) stay byte-equal too
        kw = dict(min_level_shape=(ref.level_ops.shape[0] + 3, 40),
                  radius=radius, min_ball_slots=ref.ball_slots + 5,
                  min_group_shapes=tuple(g.shape_key
                                         for g in ref.ball_groups))
        assert convert.spr_program_mismatches(
            search_fast.compile_spr(c.ptree, c.pcfg, **kw),
            jsf.compile_spr(c.jtree, c.jcfg, **kw)) == []


def test_spr_program_mismatches_detects_difference():
    a, b = make_case(start_seed=1), make_case(start_seed=2)
    mism = convert.spr_program_mismatches(
        search_fast.compile_spr(a.ptree, a.pcfg, radius=2),
        jsf.compile_spr(b.jtree, b.jcfg, radius=2))
    assert "tree" in mism and "level_ops" in mism
    assert any(m.startswith("ball_groups[0].") for m in mism)


def group_scores(c, use_kernel):
    """Per ball group: (valid mask, port (scores, t3), JAX (scores, t3))
    of the base state of the start tree, radius 3, newton_iters 3."""
    jp = jsf.compile_spr(c.jtree, c.jcfg, radius=3)
    pp = search_fast.compile_spr(c.ptree, c.pcfg, radius=3)
    cfgx = jp.cfg_ext
    tip = jsf._tipchars_for(jp, c.chars)
    pw, inv = jsf._aux_arrays(jp)
    bl = jnp.asarray(jp.branch_lengths, cfgx.dtype)
    base = jsf._spr_base_jit(cfgx, c.jmodel, jnp.asarray(jp.level_ops),
                             jnp.asarray(jp.pmatrix_slots), bl, tip)
    cpu = torch.device("cpu")
    ptip, ppw, pinv = search_fast._site_arrays(pp, c.chars, cpu)
    pbl = torch.as_tensor(pp.branch_lengths, dtype=pp.cfg_ext.dtype)
    pbase = search_fast._spr_base(
        pp.cfg_ext, c.pmodel, search_fast._long(pp.level_ops, cpu),
        search_fast._long(pp.pmatrix_slots, cpu), pbl, ptip)
    out = []
    for g in jp.ball_groups:
        want = jsf._spr_ball_scores(
            cfgx, c.jmodel, *base, bl, pw, inv,
            tuple(jnp.asarray(a) for a in g.ball_levels),
            jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
            jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges),
            ball_slots=jp.ball_slots, newton_iters=3, use_kernel=use_kernel,
            kernel_interpret=use_kernel)
        L = search_fast._long
        got = search_fast._score_group(
            pp.cfg_ext, c.pmodel, *pbase, pbl, ppw, pinv,
            tuple(L(a, cpu) for a in g.ball_levels), L(g.score_ops, cpu),
            L(g.sub_rows, cpu), L(g.edge_pos, cpu), L(g.merge_edges, cpu),
            ball_slots=pp.ball_slots, newton_iters=3, use_kernel=use_kernel)
        out.append((g.score_ops[..., search_fast.BOP_VALID] == 1,
                    tuple(x.numpy() for x in got),
                    tuple(np.asarray(x) for x in want)))
    return out


@pytest.mark.parametrize("per_rate", [False, True])
def test_score_group_f64(per_rate):
    """The ball recursion + plain scorer against JAX's XLA scorer."""
    c = make_case(per_rate_scalers=per_rate)
    compared = 0
    for valid, (s, t3), (ws, wt3) in group_scores(c, use_kernel=False):
        np.testing.assert_array_equal(np.isneginf(s), np.isneginf(ws))
        assert np.all(np.isneginf(s[~valid]))
        fin = valid & np.isfinite(ws)
        np.testing.assert_allclose(s[fin], ws[fin], rtol=1e-9)
        np.testing.assert_allclose(t3[fin], wt3[fin], rtol=1e-9)
        compared += int(fin.sum())
    assert compared > 100


def test_edge_scorer_plain_vs_pallas_interpret():
    """edge_scores on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, each behind its package's _score_group."""
    c = make_case(dt="f32")
    before = edge_score.edge_scores.launches
    compared = 0
    for valid, (s, t3), (ws, wt3) in group_scores(c, use_kernel=True):
        assert np.all(np.isneginf(s[~valid]))
        np.testing.assert_array_equal(np.isneginf(s[valid]),
                                      np.isneginf(ws[valid]))
        fin = valid & np.isfinite(s) & np.isfinite(ws)
        rel = np.abs(s[fin] - ws[fin]) / np.maximum(1.0, np.abs(ws[fin]))
        assert rel.max() <= 2e-5, rel.max()
        np.testing.assert_allclose(t3[fin], wt3[fin], rtol=2e-3, atol=2e-5)
        compared += int(fin.sum())
    assert compared > 100
    assert edge_score.edge_scores.launches == before     # no kernel on CPU


@pytest.mark.parametrize("states,sites,want", [
    (4, 512, ("resident", 1)), (4, 4096, ("resident", 4)),
    (4, 16384, ("resident", 8)), (20, 512, ("resident", 4)),
    (20, 4096, ("resident", 8)), (20, 16384, ("reread", 0))])
def test_edge_score_plan(states, sites, want):
    """Form and cluster size under an H100's 232,448-byte block limit: the
    smallest cluster whose CTA fits a third of the limit, else the smallest
    that fits at all, else the re-reading form; the CTA never exceeds the
    limit, and a smaller cluster than planned would exceed its budget."""
    limit = 232448
    assert edge_score.plan(4, states, sites, limit) == want
    form, k = want
    need = edge_score.resident_smem_bytes
    if form == "resident":
        assert need(4, states, sites, k) <= limit
        budget = limit // edge_score.RESIDENT_CTAS_PER_SM
        if need(4, states, sites, k) > budget:
            assert all(need(4, states, sites, c) > budget
                       for c in edge_score.CLUSTER_SIZES)
            budget = limit
        smaller = [c for c in edge_score.CLUSTER_SIZES if c < k]
        assert all(need(4, states, sites, c) > budget for c in smaller)
    else:
        assert k == 0
        assert need(4, states, sites, edge_score.CLUSTER_SIZES[-1]) > limit
    # the stripe and the constants are all of a CTA's shared memory
    span = 4 * states
    stripe = -(-sites // max(k, 1))
    assert need(4, states, sites, max(k, 1)) >= 4 * span * stripe
    assert edge_score.plan(4, states, sites, 1024) == ("reread", 0)


def scorer_args(c, group=0, chunk=4):
    """The edge scorer's arguments for the first `chunk` candidates of one
    ball group of the start tree, radius 3 (CPU tensors, f32)."""
    pp = search_fast.compile_spr(c.ptree, c.pcfg, radius=3)
    cpu = torch.device("cpu")
    cfgx = pp.cfg_ext
    ptip, ppw, _ = search_fast._site_arrays(pp, c.chars, cpu)
    pbl = torch.as_tensor(pp.branch_lengths, dtype=cfgx.dtype)
    L = search_fast._long
    base_clv, base_scal, pmatrix, halves = search_fast._spr_base(
        cfgx, c.pmodel, L(pp.level_ops, cpu), L(pp.pmatrix_slots, cpu), pbl,
        ptip)
    g = pp.ball_groups[group]
    cb = min(chunk, g.score_ops.shape[0])
    R, S, T = cfgx.rate_cats, cfgx.states, ptip.shape[-1]
    scratch = torch.zeros((cb, pp.ball_slots, R, S, T), dtype=torch.float32)
    sscr = torch.zeros((cb, pp.ball_slots, T), dtype=torch.int32)
    search_fast._recurse(
        cfgx, c.pmodel, base_clv, base_scal, pmatrix, pbl,
        tuple(L(a, cpu) for a in g.ball_levels), L(g.merge_edges, cpu),
        torch.arange(cb), scratch, sscr)
    t0 = torch.clamp(pbl[L(g.edge_pos[:cb], cpu)], 1e-8, 100.0)
    return (scratch, sscr, base_clv, base_scal, halves.contiguous(),
            torch.as_tensor(g.score_ops[:cb]).contiguous(),
            torch.as_tensor(g.sub_rows[:cb]).contiguous(), t0,
            *edge_score.model_constants(c.pmodel, cfgx), ppw), \
        g.score_ops[:cb, :, search_fast.BOP_VALID] == 1, cfgx


@pytest.mark.parametrize("stripes", [1, 2, 4, 8])
def test_edge_scores_reference_striped(stripes):
    """Summing per stripe of ceil(T / k) sites and adding the stripes in
    order, as the resident form's cluster does, moves a score by f32
    rounding only: 1e-6 relative (sums of a few thousand f32 terms in
    another order), t3 by 1e-5."""
    c = make_case(dt="f32")
    args, valid, cfgx = scorer_args(c)
    kw = dict(newton_iters=3, log_thresh=cfgx.log_scale_threshold)
    s0, t0 = edge_score.edge_scores_reference(*args, **kw)
    s1, t1 = edge_score.edge_scores_reference(*args, stripes=stripes, **kw)
    assert torch.equal(torch.isneginf(s0), torch.isneginf(s1))
    assert bool(torch.isneginf(s1[~torch.as_tensor(valid)]).all())
    fin = torch.isfinite(s0)
    assert int(fin.sum()) > 10
    assert float(((s1[fin] - s0[fin]).abs() / s0[fin].abs()).max()) <= 1e-6
    assert float(((t1[fin] - t0[fin]).abs() / t0[fin].abs()).max()) <= 1e-5
    if stripes == 1:
        assert torch.equal(s0, s1) and torch.equal(t0, t1)
    with pytest.raises(ValueError, match="stripes"):
        edge_score.edge_scores_reference(*args, stripes=0, **kw)


def test_edge_scorer_striped_vs_pallas_interpret():
    """The plain version summing in a cluster's stripe order against the
    Pallas kernel in interpret mode, at the bounds of
    test_edge_scorer_plain_vs_pallas_interpret."""
    c = make_case(dt="f32")
    valid, _got, (ws, wt3) = group_scores(c, use_kernel=True)[0]
    args, _, cfgx = scorer_args(c, chunk=valid.shape[0])
    s, t3 = (x.numpy() for x in edge_score.edge_scores_reference(
        *args, newton_iters=3, log_thresh=cfgx.log_scale_threshold,
        stripes=4))
    np.testing.assert_array_equal(np.isneginf(s[valid]),
                                  np.isneginf(ws[valid]))
    fin = valid & np.isfinite(s) & np.isfinite(ws)
    assert int(fin.sum()) > 20
    rel = np.abs(s[fin] - ws[fin]) / np.maximum(1.0, np.abs(ws[fin]))
    assert rel.max() <= 2e-5, rel.max()
    np.testing.assert_allclose(t3[fin], wt3[fin], rtol=2e-3, atol=2e-5)


def test_edge_scores_form_keyword():
    """On CPU tensors every form is the plain version; an unknown form is
    refused before any device is looked at."""
    c = make_case(dt="f32")
    args, _valid, cfgx = scorer_args(c, chunk=2)
    kw = dict(newton_iters=2, log_thresh=cfgx.log_scale_threshold)
    want = edge_score.edge_scores_reference(*args, **kw)
    before = (edge_score.edge_scores.launches,
              dict(edge_score.edge_scores.launches_by_form))
    for form in (None, "resident", "reread"):
        got = edge_score.edge_scores(*args, form=form, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert before == (edge_score.edge_scores.launches,
                      edge_score.edge_scores.launches_by_form)
    with pytest.raises(ValueError, match="unknown edge scorer form"):
        edge_score.edge_scores(*args, form="cluster", **kw)


def test_model_constants_equal():
    c = make_case(dt="f32")
    got = edge_score.model_constants(c.pmodel, c.pcfg)
    want = jesp.model_constants(c.jmodel, c.jcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_edge_scores_rejects_mixed_devices_and_shapes():
    away = torch.zeros((1, 3, 4, 4, 8))
    args = [away, torch.zeros((1, 3, 8), dtype=torch.int32),
            torch.zeros((2, 4, 4, 8)), torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((3, 4, 4, 4)),
            torch.zeros((1, 2, 12), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), torch.ones(1),
            torch.eye(16), torch.eye(16), torch.zeros((16, 2)), torch.ones(8)]
    s, t3 = edge_score.edge_scores(*args, newton_iters=2, log_thresh=-20.0)
    assert torch.all(torch.isneginf(s)) and torch.all(t3 == 1.0)
    bad = list(args)
    bad[11] = torch.ones(9)
    with pytest.raises(ValueError, match="pw"):
        edge_score.edge_scores(*bad, newton_iters=2, log_thresh=-20.0)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(TypeError, match="away_scal"):
        edge_score.edge_scores(*bad, newton_iters=2, log_thresh=-20.0)
    bad = list(args)
    bad[0] = away.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        edge_score.edge_scores(*bad, newton_iters=2, log_thresh=-20.0)


def test_use_edge_kernel_follows_contract():
    c = make_case(dt="f32")
    inv = torch.full((c.pcfg.sites_padded,), -1, dtype=torch.int32)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    use = search_fast.use_edge_kernel
    assert use(c.pcfg, inv, cuda) and not use(c.pcfg, inv, cpu)
    marked = inv.clone()
    marked[3] = 2
    assert not use(c.pcfg, marked, cuda)
    for kw in (dict(dtype=torch.float64), dict(per_rate_scalers=True),
               dict(asc_bias=AB_LEWIS)):
        cfg = dataclasses.replace(c.pcfg, **kw)
        assert not use(cfg, inv, cuda)
        with pytest.raises(ValueError, match="edge scorer"):
            use(dataclasses.replace(cfg, use_kernel=True), inv, cpu)
    assert use(dataclasses.replace(c.pcfg, use_kernel=True), inv, cpu)
    assert not use(dataclasses.replace(c.pcfg, use_kernel=False), inv, cuda)


@pytest.mark.parametrize("radius,kw", [
    (None, {}), (3, {}), (3, dict(per_rate_scalers=True)),
    (3, dict(asc_bias=AB_LEWIS))])
def test_spr_round_f64(radius, kw, monkeypatch):
    """One round: the same moves applied and the same exact logL.  The
    port's selection counts (the JAX package's timings keys) are taken
    from its first greedy selection's own inputs and outputs."""
    c = make_case(n=14, **kw)
    jp = jsf.compile_spr(c.jtree, c.jcfg, radius=radius)
    pp = search_fast.compile_spr(c.ptree, c.pcfg, radius=radius)
    jtm, ptm = {}, {}
    real = search_fast._select_improving

    def counted(scores, cand_of, edge_of, logl0, eps, *args, **kw):
        chosen, idx = real(scores, cand_of, edge_of, logl0, eps, *args,
                           **kw)
        if "n_chosen" not in ptm:
            imp = scores > logl0 + eps
            ptm.update(n_improving=int(np.sum(imp)),
                       n_cand_improving=int(len(np.unique(cand_of[imp]))),
                       n_chosen=len(chosen))
        return chosen, idx

    monkeypatch.setattr(search_fast, "_select_improving", counted)
    jnew, jl, ja = jsf.spr_round(jp, c.jmodel, c.chars, timings=jtm)
    pnew, pl, pa = search_fast.spr_round(pp, c.pmodel, c.chars, timings=ptm)
    assert pa == ja > 0
    np.testing.assert_allclose(pl, jl, rtol=1e-9)
    for key in ("n_improving", "n_cand_improving", "n_chosen", "n_applied"):
        assert ptm[key] == jtm[key], key
    assert ptm["scorer"] == "plain"
    # the refined attachment branches agree to rounding, so the new trees
    # differ only in the last digits of those lengths
    assert set(convert.spr_program_mismatches(pnew, jnew)) <= {
        "tree", "branch_lengths"}
    assert T.export_newick(pnew.tree.vroot) == \
        jtree.export_newick(jnew.tree.vroot)
    np.testing.assert_allclose(pnew.branch_lengths, jnew.branch_lengths,
                               rtol=1e-9)


def test_spr_round_f32_kernel_path_matches_plain():
    """f32 with use_kernel=True on CPU tensors: the chunked edge-scorer
    path (its plain version) selects like the plain scorer."""
    c = make_case(n=14, dt="f32")
    out = {}
    for use in (True, False):
        cfg = dataclasses.replace(c.pcfg, use_kernel=use)
        prog = search_fast.compile_spr(c.ptree, cfg, radius=3)
        tm = {}
        new, logl, applied = search_fast.spr_round(prog, c.pmodel, c.chars,
                                                   timings=tm)
        out[use] = (newick(new.tree), logl, applied, tm)
    assert out[True][3]["scorer"] == "kernel"
    assert out[True][3]["edge_score_launches"] == 0      # CPU: plain version
    assert out[False][3]["scorer"] == "plain"
    assert out[True][2] == out[False][2] > 0
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-5)


@pytest.fixture
def four_classes(monkeypatch):
    """Smooth only colour classes 0-3, as the JAX package does (it builds
    no mask for a fifth class), so that smoothed lengths and climbs can be
    compared with it on trees whose colouring needs five."""
    real = search_fast.compile_spr

    def compile_spr(*args, **kw):
        prog = real(*args, **kw)
        return dataclasses.replace(prog, color_masks=prog.color_masks[:4])

    monkeypatch.setattr(search_fast, "compile_spr", compile_spr)


def test_hill_climb_f64(tmp_path, four_classes):
    c = make_case(n=14, sites=256)
    kw = dict(max_rounds=4, radius=3, smooth_every=2)
    jtree_, jl, jstats = jsf.hill_climb(c.jtree, c.jcfg, c.jmodel, c.chars,
                                        **kw)
    ptree, pl, pstats = search_fast.hill_climb(
        c.ptree, c.pcfg, c.pmodel, c.chars, checkpoint_dir=tmp_path, **kw)
    trace = pstats["logl_trace"]
    assert all(b >= a for a, b in zip(trace, trace[1:]))
    np.testing.assert_allclose(pl, jl, rtol=1e-8)
    np.testing.assert_allclose(trace, jstats["logl_trace"], rtol=1e-8)
    assert pstats["rounds"] == jstats["rounds"]
    assert pstats["moves"] == jstats["moves"]
    assert rf_distance(ptree, T.parse_newick_string(
        jtree.export_newick(jtree_.vroot, precision=None))) == 0
    assert {"setup", "score", "select"} <= set(pstats["phase_timings"][0])
    # checkpoint: one record per round and the latest tree
    records = [json.loads(line) for line in
               (tmp_path / "search_trace.jsonl").read_text().splitlines()]
    assert [r["round"] for r in records] == list(
        range(1, pstats["rounds"] + 1))
    assert records[-1]["logl"] == trace[-2]
    latest = T.parse_newick_string((tmp_path / "latest.newick").read_text())
    assert rf_distance(latest, ptree) == 0


def test_hill_climb_all_classes_monotone():
    """The same climb smoothing every colour class: monotone and finite."""
    c = make_case(n=14, sites=256)
    _, pl, pstats = search_fast.hill_climb(
        c.ptree, c.pcfg, c.pmodel, c.chars, max_rounds=4, radius=3,
        smooth_every=2)
    trace = pstats["logl_trace"]
    assert np.isfinite(pl) and pl == trace[-1]
    assert all(b >= a for a, b in zip(trace, trace[1:]))


def test_smooth_and_evaluate_tree_f64(four_classes):
    c = make_case(n=14)
    jl, jprog = jsf.evaluate_tree(c.jtree, c.jcfg, c.jmodel, c.chars)
    pl, pprog = search_fast.evaluate_tree(c.ptree, c.pcfg, c.pmodel, c.chars)
    np.testing.assert_allclose(pl, jl, rtol=1e-9)
    np.testing.assert_allclose(pprog.branch_lengths, jprog.branch_lengths,
                               rtol=1e-9)
    raw, _ = search_fast.evaluate_tree(c.ptree, c.pcfg, c.pmodel, c.chars,
                                       smooth_rounds=0)
    assert pl > raw


def balanced24_case():
    """A balanced 24-taxon tree, whose greedy edge colouring needs five
    classes, with an alignment simulated down it."""
    rng = np.random.default_rng(24)
    newick_text = balanced_newick(24)
    jt, pt = (jtree.parse_newick_string(newick_text),
              T.parse_newick_string(newick_text))
    rates = pll.compute_gamma_cats(0.8, 4)
    chars = simulate_alignment(pt, 128, rng, SUBST, FREQS, rates)
    common = dict(tips=24, clv_buffers=pt.inner_count, states=4, sites=128,
                  rate_matrices=1, prob_matrices=45, rate_cats=4,
                  scale_buffers=pt.inner_count)
    jmodel = jengine.make_model([SUBST], [FREQS], rates, dtype=jnp.float64)
    return Case(jt, pt, chars, JConfig(**common, dtype=jnp.float64),
                PartitionConfig(**common, dtype=torch.float64), jmodel,
                convert.model_from_jax(convert.model_arrays(jmodel),
                                       device="cpu"))


def test_color_masks_cover_every_class():
    """One mask per colour class: classes 0-3 as the JAX package builds
    them, the fifth from compile_tree_full's edge_colors (the JAX package
    leaves it out and never smooths its branches)."""
    c = balanced24_case()
    ref = jsf.compile_spr(c.jtree, c.jcfg, radius=2)
    got = search_fast.compile_spr(c.ptree, c.pcfg, radius=2)
    colors = jengine.compile_tree_full(c.jtree, c.jcfg).edge_colors
    assert int(colors.max()) + 1 == 5 and ref.color_masks.shape[0] == 4
    assert got.color_masks.shape == (5, len(colors))
    np.testing.assert_array_equal(got.color_masks[:4], ref.color_masks)
    for k in range(5):
        np.testing.assert_array_equal(got.color_masks[k], colors == k)
    assert got.color_masks.sum(axis=0).tolist() == [1] * len(colors)
    assert not ref.color_masks.any(axis=0).all()    # JAX misses class 4
    assert convert.spr_program_mismatches(got, ref) == []
    # a program whose extra mask is wrong is told apart
    bad = dataclasses.replace(got, color_masks=np.concatenate(
        [got.color_masks[:4], ~got.color_masks[4:]]))
    assert "color_masks" in convert.spr_program_mismatches(bad, ref)


def test_smooth_branches_moves_every_branch_of_five_colours():
    c = balanced24_case()
    prog = search_fast.compile_spr(c.ptree, c.pcfg, radius=2)
    before = prog.branch_lengths.copy()
    after = search_fast.smooth_branches(prog, c.pmodel, c.chars, rounds=1)
    assert (after.branch_lengths != before).all()
    # the JAX package leaves the fifth class where it was
    jprog = jsf.compile_spr(c.jtree, c.jcfg, radius=2)
    jafter = jsf.smooth_branches(jprog, c.jmodel, c.chars, rounds=1)
    stuck = np.asarray(jafter.branch_lengths) == before
    np.testing.assert_array_equal(stuck, prog.color_masks[4])


def test_smoothing_that_lowers_logl_is_dropped(monkeypatch):
    """hill_climb promises a monotone trace; a class of branches moves at
    once, which can lower the logL, so the climb keeps a smoothing only if
    the exact logL did not fall."""
    c = make_case(n=12)
    prog = search_fast.compile_spr(c.ptree, c.pcfg, radius=2)
    lengths = prog.branch_lengths.copy()
    newick_before = newick(prog.tree)
    good, kept = search_fast._smooth_if_better(prog, c.pmodel, c.chars,
                                               rounds=1)
    assert kept and (good.branch_lengths != lengths).any()
    search_fast._write_lengths(prog, lengths)
    real = search_fast.smooth_branches

    def worse(p, *args, **kw):
        out = real(p, *args, **kw)
        bad = np.full_like(out.branch_lengths, 5.0)
        search_fast._write_lengths(out, bad)
        return dataclasses.replace(out, branch_lengths=bad)

    monkeypatch.setattr(search_fast, "smooth_branches", worse)
    same, kept = search_fast._smooth_if_better(prog, c.pmodel, c.chars,
                                               rounds=1)
    assert not kept and same is prog
    np.testing.assert_array_equal(same.branch_lengths, lengths)
    assert newick(same.tree) == newick_before     # the tree is restored
