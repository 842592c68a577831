"""The `*_multi` forms of the port's SPR search (K partitions over one
topology, unlinked branch lengths) against libpll2_tpu.search_fast on the
CPU: the same two simulated alignments (different site counts and models),
start tree and models go through both packages.

Tolerances: the K programs byte-equal (colour classes 0-3, the rest by
`edge_colors`); one f64 round's summed logL at 1e-8 relative (the same f64
formulas summed in another order, over two partitions); a short climb's
total against independent engine evaluations of each partition's final
tree at its own lengths within 1e-6 absolute (the JAX test's bound)."""
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
from libpll2_tpu_torch import convert, engine, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.tree.generate import random_newick, simulate_alignment

from .test_torch_search import FREQS, SUBST, four_classes  # noqa: F401

SUBST2 = [0.8, 1.9, 1.2, 0.9, 2.4, 1.0]
FREQS2 = [0.21, 0.27, 0.31, 0.21]


@dataclasses.dataclass
class MultiCase:
    jtree: object
    ptree: object
    chars_list: list
    jcfgs: list
    pcfgs: list
    jmodels: list
    pmodels: list


def make_multi(n=8, sites=(120, 72), seed=5, start_seed=31, dt="f64",
               **cfg_kw):
    rng = np.random.default_rng(seed)
    rates = pll.compute_gamma_cats(0.8, 4)
    truth = T.parse_newick_string(random_newick(n, rng))
    jdt, pdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    start = random_newick(n, np.random.default_rng(start_seed))
    jt, pt = jtree.parse_newick_string(start), T.parse_newick_string(start)
    case = MultiCase(jt, pt, [], [], [], [], [])
    for s, (sub, fr) in zip(sites, ((SUBST, FREQS), (SUBST2, FREQS2))):
        case.chars_list.append(simulate_alignment(truth, s, rng, sub, fr,
                                                  rates))
        common = dict(tips=n, clv_buffers=pt.inner_count, states=4, sites=s,
                      rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
                      scale_buffers=pt.inner_count, **cfg_kw)
        case.jcfgs.append(JConfig(**common, dtype=jdt))
        case.pcfgs.append(PartitionConfig(**common, dtype=pdt))
        jmodel = jengine.make_model([sub], [fr], rates, dtype=jdt)
        case.jmodels.append(jmodel)
        case.pmodels.append(convert.model_from_jax(
            convert.model_arrays(jmodel), device="cpu"))
    return case


@pytest.mark.parametrize("n,start_seed", [(8, 31), (14, 2)])
def test_compile_spr_multi_byte_equal(n, start_seed):
    c = make_multi(n=n, start_seed=start_seed)
    ref = jsf.compile_spr_multi(c.jtree, c.jcfgs, radius=3)
    got = search_fast.compile_spr_multi(c.ptree, c.pcfgs, radius=3)
    assert len(got) == 2
    assert convert.spr_programs_mismatches(got, ref) == []
    # each partition owns its tree copy
    assert got[0].tree is not got[1].tree
    pins = [{"min_level_shape": (p.level_ops.shape[0] + 2, 24),
             "min_ball_slots": p.ball_slots + 3} for p in ref]
    assert convert.spr_programs_mismatches(
        search_fast.compile_spr_multi(c.ptree, c.pcfgs, radius=3, pins=pins),
        jsf.compile_spr_multi(c.jtree, c.jcfgs, radius=3, pins=pins)) == []
    assert convert.spr_programs_mismatches(got[:1], ref) == ["n_partitions"]


def test_compile_spr_multi_refuses_differing_taxa():
    c = make_multi()
    odd = dataclasses.replace(c.pcfgs[1], tips=9)
    with pytest.raises(ValueError, match="same taxa"):
        search_fast.compile_spr_multi(c.ptree, [c.pcfgs[0], odd], radius=3)


def test_spr_round_multi_requires_radius():
    c = make_multi()
    progs = search_fast.compile_spr_multi(c.ptree, c.pcfgs)
    with pytest.raises(ValueError, match="radius-compiled"):
        search_fast.spr_round_multi(progs, c.pmodels, c.chars_list)
    with pytest.raises(ValueError, match="models"):
        search_fast.spr_round_multi(progs, c.pmodels[:1], c.chars_list)


@pytest.mark.parametrize("n,start_seed", [(8, 31), (14, 2)])
def test_spr_round_multi_f64(n, start_seed, four_classes):  # noqa: F811
    """One round: the same moves applied and the same summed logL."""
    c = make_multi(n=n, start_seed=start_seed)
    jp = jsf.compile_spr_multi(c.jtree, c.jcfgs, radius=3)
    pp = search_fast.compile_spr_multi(c.ptree, c.pcfgs, radius=3)
    tm = {}
    jnew, jl, ja = jsf.spr_round_multi(jp, c.jmodels, c.chars_list)
    pnew, pl, pa = search_fast.spr_round_multi(pp, c.pmodels, c.chars_list,
                                               timings=tm)
    assert pa == ja > 0
    np.testing.assert_allclose(pl, jl, rtol=1e-8)
    assert tm["scorer"] == ["plain", "plain"]
    assert tm["edge_score_launches"] == [0, 0]
    assert {"setup", "score", "select", "apply"} <= set(tm)
    for k in range(2):
        assert T.export_newick(pnew[k].tree.vroot) == \
            jtree.export_newick(jnew[k].tree.vroot)
        np.testing.assert_allclose(pnew[k].branch_lengths,
                                   jnew[k].branch_lengths, rtol=1e-8)
    # one topology, the partitions' own attachment lengths
    assert T.export_newick(pnew[0].tree.vroot, precision=None) != \
        T.export_newick(pnew[1].tree.vroot, precision=None)


def test_spr_round_multi_f32_kernel_path_counts_per_partition():
    """f32 with use_kernel=True on CPU tensors: each partition's score
    phase goes through the edge scorer (its plain version here)."""
    c = make_multi(n=10, dt="f32")
    cfgs = [dataclasses.replace(cfg, use_kernel=True) for cfg in c.pcfgs]
    pp = search_fast.compile_spr_multi(c.ptree, cfgs, radius=3)
    tm = {}
    new, logl, applied = search_fast.spr_round_multi(
        pp, c.pmodels, c.chars_list, timings=tm)
    assert tm["scorer"] == ["kernel", "kernel"]
    assert tm["edge_score_launches"] == [0, 0]      # CPU: plain version
    assert np.isfinite(logl) and applied > 0


def engine_logl(prog, cfg, model, chars):
    """Independent evaluation by engine.loglikelihood of a program's tree
    at its own lengths."""
    t = T.parse_newick_string(T.export_newick(prog.tree.vroot,
                                              precision=None))
    program = engine.compile_tree(t, cfg)
    raw = np.zeros((t.tip_count, cfg.sites), dtype=np.uint64)
    for node in t.nodes[:t.tip_count]:
        raw[node.clv_index] = chars[node.label][:cfg.sites]
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites] = 1.0
    return engine.loglikelihood(
        program, cfg, model,
        torch.as_tensor(program.default_branch_lengths, dtype=cfg.dtype),
        torch.as_tensor(engine.pad_tipchars(raw, cfg)),
        torch.as_tensor(pw, dtype=cfg.dtype),
        torch.full((cfg.sites_padded,), -1, dtype=torch.int32)).item()


def test_hill_climb_multi():
    c = make_multi()
    tree, total, stats = search_fast.hill_climb_multi(
        c.ptree, c.pcfgs, c.pmodels, c.chars_list, max_rounds=8, radius=3)
    tr = stats["logl_trace"]
    assert all(b >= a for a, b in zip(tr, tr[1:])), tr
    assert stats["moves"] >= 1 and total == tr[-1]
    assert set(stats) >= {"programs", "phase_timings", "round_secs",
                          "logl_trace", "rounds", "moves"}
    assert len(stats["round_secs"]) == stats["rounds"] == \
        len(stats["phase_timings"])
    check = sum(engine_logl(p, c.pcfgs[k], c.pmodels[k], c.chars_list[k])
                for k, p in enumerate(stats["programs"]))
    assert abs(total - check) < 1e-6, (total, check)
    # partitions keep their OWN lengths (unlinked): they must differ
    bl0, bl1 = (p.branch_lengths for p in stats["programs"])
    assert not np.allclose(bl0, bl1)
    assert tree is stats["programs"][0].tree


def test_hill_climb_multi_follows_jax(four_classes):  # noqa: F811
    """With four colour classes pinned, the climb takes the JAX climb's
    moves and ends at its total."""
    c = make_multi()
    kw = dict(max_rounds=3, radius=3, smooth_every=2)
    _, jl, jstats = jsf.hill_climb_multi(c.jtree, c.jcfgs, c.jmodels,
                                         c.chars_list, **kw)
    _, pl, pstats = search_fast.hill_climb_multi(
        c.ptree, c.pcfgs, c.pmodels, c.chars_list, **kw)
    assert pstats["rounds"] == jstats["rounds"]
    assert pstats["moves"] == jstats["moves"]
    np.testing.assert_allclose(pl, jl, rtol=1e-8)


def test_smoothing_guard_is_on_the_summed_logl(monkeypatch):
    """A smoothing that raises one partition and lowers the sum is dropped
    for every partition; lengths and trees are put back."""
    c = make_multi()
    progs = search_fast.compile_spr_multi(c.ptree, c.pcfgs, radius=3)
    good, kept = search_fast._smooth_all_if_better(progs, c.pmodels,
                                                   c.chars_list)
    assert kept
    before = [T.export_newick(p.tree.vroot, precision=None) for p in good]
    real = search_fast.smooth_branches

    def one_worse(prog, model, labels, **kw):
        out = real(prog, model, labels, **kw)
        if model is c.pmodels[1]:
            bl = out.branch_lengths * 40.0
            search_fast._write_lengths(out, bl)
            out = dataclasses.replace(out, branch_lengths=bl)
        return out

    monkeypatch.setattr(search_fast, "smooth_branches", one_worse)
    same, kept = search_fast._smooth_all_if_better(good, c.pmodels,
                                                   c.chars_list)
    assert not kept
    for a, b, nw in zip(same, good, before):
        assert a is b
        assert T.export_newick(a.tree.vroot, precision=None) == nw
