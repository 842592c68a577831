"""The batched multi-partition forward (multipartition.loglikelihood: one
sweep a group of partitions): on the CPU at 12 taxa, seven partitions of
37-300 sites in two groups (20 states and 4 states), each with its own
seeded random model and multiplier, against the benchmark's plain
reference (pllbench/reference/partitioned.py) and the per-partition
engine.loglikelihood; the groups, the batched P-matrices, the per-block
P base of the plain sweep, the spans and counters, and the graph path
through a stand-in.  On the card (marked `cuda`, skipped without one):
the batched sweep's rows against per-partition launches bit for bit
("fma" and "mma" forced, 4 and 20 states), a table of one partition
against no table, and replayed calls against eager ones bit for bit.

On a GPU machine:

    python -m pytest tests/test_torch_multipartition_batched.py -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

from libpll2_tpu_torch import engine, forward_graph, multipartition, spans
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import AB_FELSENSTEIN, AB_LEWIS, \
    AB_STAMATAKIS
from libpll2_tpu_torch.models.aa import aa_model
from libpll2_tpu_torch.models.gamma import compute_gamma_cats
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.ops import pmatrix as pmatrix_ops
from libpll2_tpu_torch.tree.generate import random_newick
from pllbench import inputs
from pllbench.reference import model as ref_model
from pllbench.reference import newick, partitioned

N_TIPS = 12
# (states, sites): two groups, 20 states and 4 states, 37-300 sites
SPECS = [(20, 37), (4, 300), (20, 129), (4, 64), (20, 250), (4, 77),
         (20, 100)]
# The reference takes the exact means of the Gamma categories, the program
# libpll-2's approximation of them; the two rate sets differ by up to
# 1.4e-8 relative (PERF.md section 2), which moves a logL by about as much.
REF_RTOL = 1e-7
# The same f64 arithmetic batched otherwise (einsum over blocks against
# over one partition, site sums in another order): 1e-12 relative.
SAME_RTOL = 1e-12


@dataclasses.dataclass
class Case:
    mp: multipartition.MultiPartition
    models: list
    bl: torch.Tensor
    tipchars: list
    pw: list
    inv: list
    scalers: torch.Tensor
    ref_tree: newick.Tree
    chars: dict
    bounds: np.ndarray
    ref_models: list
    perm: np.ndarray

    def args(self, bl=None, scaled=True):
        return (self.mp, self.models, self.bl if bl is None else bl,
                self.tipchars, self.pw, self.inv,
                self.scalers if scaled else None)


def make_case(device="cpu", dtype=torch.float64, specs=SPECS, seed=5,
              extra=None, **cfg_kw) -> Case:
    """Seeded random models (LG exchangeabilities with random frequencies
    at 20 states, random GTR at 4), alpha and multipliers; sites simulated
    down a random tree by the benchmark's generator."""
    rng = np.random.default_rng(seed)
    text = random_newick(N_TIPS, rng)
    ref_tree = newick.parse(text)
    lg, _ = aa_model("lg")
    ref_models, cfgs, models = [], [], []
    tree_p = T.parse_newick_string(text)
    for i, (states, sites) in enumerate(specs):
        subst = list(lg) if states == 20 else \
            rng.uniform(0.3, 3.0, states * (states - 1) // 2).tolist()
        freqs = rng.dirichlet(np.full(states, 8.0)).tolist()
        alpha = float(np.exp(rng.uniform(np.log(0.3), np.log(1.5))))
        scaler = float(np.exp(rng.uniform(np.log(0.5), np.log(2.0))))
        ref_models.append(partitioned.PartitionModel(subst, freqs, alpha,
                                                     scaler))
        kw = dict(cfg_kw, **(extra[i] if extra else {}))
        pinv = kw.pop("pinv", 0.0)
        cfgs.append(PartitionConfig(
            tips=N_TIPS, clv_buffers=tree_p.inner_count, states=states,
            sites=sites, rate_matrices=1, prob_matrices=2 * N_TIPS - 3,
            rate_cats=4, scale_buffers=tree_p.inner_count, dtype=dtype,
            **kw))
        models.append(engine.make_model(
            [subst], [freqs], compute_gamma_cats(alpha, 4),
            prop_invar=[pinv], dtype=dtype, device=device))
    bounds = np.concatenate([[0], np.cumsum([s for _, s in specs])])
    chars = {}
    for i, m in enumerate(ref_models):
        rates = ref_model.gamma_rates(m.alpha, 4)
        scaled = newick.parse(newick.write(
            ref_tree, [t * m.scaler for t in ref_tree.lengths]))
        part = inputs.simulate_alignment(scaled, specs[i][1], rng, m.subst,
                                         m.freqs, rates)
        for label, codes in part.items():
            chars.setdefault(label, []).append(codes)
    chars = {k: np.concatenate(v) for k, v in chars.items()}
    mp = multipartition.compile_multipartition(tree_p, cfgs)
    order = sorted(tree_p.nodes[:N_TIPS], key=lambda n: n.clv_index)
    tipchars, pws, invs = [], [], []
    for i, cfg in enumerate(cfgs):
        codes = np.stack([chars[n.label][bounds[i]:bounds[i + 1]]
                          for n in order])
        tips = engine.pad_tipchars(codes, cfg)
        inv = np.full(cfg.sites_padded, -1, np.int32)
        if models[i].prop_invar.max() > 0:
            first = tips[0]
            single = (first > 0) & ((first & (first - 1)) == 0)
            same = (tips == first).all(axis=0) & single
            inv = np.where(same, np.log2(np.maximum(first, 1)), -1
                           ).astype(np.int32)
        pw = np.zeros(cfg.sites_padded)
        pw[:cfg.sites_alloc] = 1.0
        tipchars.append(torch.as_tensor(tips, device=device))
        pws.append(torch.as_tensor(pw, dtype=dtype, device=device))
        invs.append(torch.as_tensor(inv, device=device))
    n_edges = len(ref_tree.lengths)
    probe = engine.compile_tree(T.parse_newick_string(newick.write(
        ref_tree, [float(k + 1) for k in range(n_edges)])), cfgs[0])
    perm = np.rint(probe.default_branch_lengths).astype(np.int64) - 1
    bl = torch.as_tensor(np.asarray(ref_tree.lengths)[perm], dtype=dtype,
                         device=device)
    scalers = torch.tensor([m.scaler for m in ref_models],
                           dtype=torch.float64, device=device)
    return Case(mp, models, bl, tipchars, pws, invs, scalers, ref_tree,
                chars, bounds, ref_models, perm)


def reference(c: Case, bl, scaled=True):
    lengths = np.empty(len(c.perm))
    lengths[c.perm] = bl.double().cpu().numpy()
    models = c.ref_models if scaled else [
        dataclasses.replace(m, scaler=1.0) for m in c.ref_models]
    return partitioned.partition_loglikelihoods(
        c.ref_tree, lengths[None], c.chars, c.bounds, models, 4,
        block_sites=256)[0]


def per_partition(c: Case, bl, scaled=True):
    """engine.loglikelihood of each partition alone at t * s_k."""
    s = c.scalers if scaled else torch.ones_like(c.scalers)
    return np.array([engine.loglikelihood(
        c.mp.programs[k], c.mp.cfgs[k], c.models[k],
        bl * s[k].to(bl.dtype), c.tipchars[k], c.pw[k], c.inv[k]).item()
        for k in range(c.mp.n_partitions)])


@pytest.fixture(scope="module")
def case():
    return make_case()


def test_groups_and_one_compile(case):
    mp = case.mp
    assert [g.members for g in mp.groups] == [(0, 2, 4, 6), (1, 3, 5)]
    assert all(p is mp.programs[0] for p in mp.programs)
    assert all(f.level_ops is mp.fulls[0].level_ops for f in mp.fulls)
    g = mp.groups[0]
    assert g.cfg.sites_padded == sum(c.sites_padded for c in
                                     (mp.cfgs[k] for k in g.members))
    assert g.block == 128 and g.cfg.states == 20
    # the schedule's P columns are branch positions
    ops = g.program.vmem_prog.ops
    assert ops[:, 7:9].max() < g.program.num_branches
    assert g.pad_columns == sum(c.sites_padded - c.sites for c in
                                (mp.cfgs[k] for k in g.members))


@pytest.mark.parametrize("scaled", [False, True], ids=["linked", "scaled"])
def test_against_the_reference(case, scaled):
    got = multipartition.loglikelihood(*case.args(scaled=scaled))
    parts = multipartition._forward(*case.args(scaled=scaled))
    want = reference(case, case.bl, scaled)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(parts.numpy(), want, rtol=REF_RTOL)
    np.testing.assert_allclose(got.item(), want.sum(), rtol=REF_RTOL)
    np.testing.assert_allclose(got.item(), parts.sum().item(), rtol=0)


@pytest.mark.parametrize("scaled", [False, True], ids=["linked", "scaled"])
def test_per_partition_sums_equal_engine(case, scaled):
    for f in (1.0, 0.6, 1.7):
        bl = case.bl * f
        parts = multipartition._forward(*case.args(bl, scaled))
        np.testing.assert_allclose(parts.numpy(),
                                   per_partition(case, bl, scaled),
                                   rtol=SAME_RTOL)


def test_batched_pmatrices_equal_per_partition(case):
    """The P stage's [Kg, E, R, S, S] against compute_pmatrices of each
    partition at t * s_k, in branch order: the same f64 formula, batched
    over partitions and rate categories (entries at most 1: 1e-15)."""
    mp, device = case.mp, torch.device("cpu")
    choices = [multipartition._choice(g, device) for g in mp.groups]
    stages = multipartition._stages(mp, case.models, case.tipchars, case.pw,
                                    case.inv, choices, device)
    packed = multipartition._packed(mp, case.bl, case.scalers)
    for g, pm in zip(mp.groups, stages[0](packed)):
        assert pm.shape == (len(g.members), len(case.bl), 4, g.cfg.states,
                            g.cfg.states) and pm.is_contiguous()
        for i, k in enumerate(g.members):
            m = case.models[k]
            want = pmatrix_ops.compute_pmatrices(
                case.bl * case.scalers[k], m.eigenvals, m.eigenvecs,
                m.inv_eigenvecs, m.rates, m.prop_invar, m.params_indices)
            torch.testing.assert_close(pm[i], want, rtol=0, atol=1e-15)


def test_plain_sweep_with_a_block_table(case):
    """sweep_reference over the concatenated columns with the per-block P
    base against the plain sweep of each partition alone (f64, another
    einsum batching: 1e-12 of each row's largest entry)."""
    mp, device = case.mp, torch.device("cpu")
    g = mp.groups[0]
    tb = 64
    lay = g.layout(device, tb)
    choices = [multipartition._choice(x, device) for x in mp.groups]
    stages = multipartition._stages(mp, case.models, case.tipchars, case.pw,
                                    case.inv, choices, device)
    pm = stages[0](multipartition._packed(mp, case.bl, case.scalers))[0]
    tips = engine.block_tips(torch.cat([case.tipchars[k] for k in g.members],
                                       dim=1), g.cfg, tb)
    prog = g.program.vmem_prog
    clv, scal = partials_tree.sweep_reference(
        tips, pm.view(-1, *pm.shape[2:]), prog, g.cfg, tb,
        p_base=lay.p_base)
    start = 0
    for i, k in enumerate(g.members):
        n = mp.cfgs[k].sites_padded // tb
        alone = engine.block_tips(case.tipchars[k], mp.cfgs[k], tb)
        want_clv, want_scal = partials_tree.sweep_reference(
            alone, pm[i], prog, mp.cfgs[k], tb)
        got = clv[:, start:start + n]
        scale = want_clv.abs().amax(dim=(2, 3), keepdim=True)
        assert float(((got - want_clv).abs() / scale).max()) < 1e-12
        assert torch.equal(scal[:, start:start + n], want_scal)
        start += n
    assert start == tips.shape[0]


MODES = {
    "pinv": [dict(pinv=0.2)] * len(SPECS),
    "per_rate": [dict(per_rate_scalers=True)] * len(SPECS),
    "lewis": [dict(asc_bias=AB_LEWIS)] * len(SPECS),
    "felsenstein": [dict(asc_bias=AB_FELSENSTEIN)] * len(SPECS),
    "stamatakis": [dict(asc_bias=AB_STAMATAKIS)] * len(SPECS),
    "mixed": [dict(pinv=0.2), dict(per_rate_scalers=True), {},
              dict(asc_bias=AB_LEWIS), dict(per_rate_scalers=True), {},
              dict(asc_bias=AB_LEWIS)],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_per_partition(mode):
    """+I, per-rate scalers, the three asc-bias corrections and a mix of
    them (one group a mode): each partition's sum equals its own
    engine.loglikelihood, at lengths long enough to rescue (x 8)."""
    c = make_case(extra=MODES[mode], seed=11)
    keys = {multipartition._group_key(cfg) for cfg in c.mp.cfgs}
    assert len(c.mp.groups) == len(keys)
    bl = c.bl * 8.0
    parts = multipartition._forward(*c.args(bl))
    np.testing.assert_allclose(parts.numpy(), per_partition(c, bl),
                               rtol=SAME_RTOL)


def test_f32_against_the_reference():
    """f32 partitions: their site terms in f32 (1e-5: f32 rounding through
    the tree and the sites), their sums in f64."""
    c = make_case(dtype=torch.float32)
    got = multipartition.loglikelihood(*c.args())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), reference(c, c.bl).sum(),
                               rtol=1e-5)


COUNTERS = ("groups", "real_columns", "pad_columns", forward_graph.EAGER,
            forward_graph.CAPTURE, forward_graph.REPLAY)


def counts():
    return {k: getattr(multipartition.loglikelihood, k) for k in COUNTERS}


def test_span_and_counters():
    """One group here: the call counts one group, its partitions' sites and
    padding, and records libpll2.multi.forward with the P-matrix, sweep and
    root spans inside it."""
    c = make_case(specs=[s for s in SPECS if s[0] == 20])
    before = counts()
    spans.clear()
    with spans.recording():
        multipartition.loglikelihood(*c.args())
    recs = spans.records()
    spans.clear()
    after = counts()
    cfgs = c.mp.cfgs
    assert after["groups"] - before["groups"] == 1
    assert after["real_columns"] - before["real_columns"] == \
        sum(cfg.sites for cfg in cfgs)
    assert after["pad_columns"] - before["pad_columns"] == \
        sum(cfg.sites_padded - cfg.sites for cfg in cfgs)
    assert after[forward_graph.EAGER] - before[forward_graph.EAGER] == 1
    outer = [r for r in recs if r.name == "libpll2.multi.forward"]
    assert len(outer) == 1 and outer[0].parent is None
    inner = {r.name for r in recs if r.parent == outer[0].id}
    assert inner == {"libpll2.pmatrix", "libpll2.sweep", "libpll2.root"}


def test_graph_path_through_a_capture_stand_in(monkeypatch):
    """With eligibility forced and capture replaced by a stand-in that runs
    the stages it is given (use_kernel=True: the sweep's kernel form is
    chosen, its plain version runs on CPU tensors): eager, capture, then
    replays, each equal to the eager stages bit for bit; another model
    list is another key."""
    c = make_case(dtype=torch.float32, use_kernel=True)

    class Stages:
        def __init__(self, stages):
            self.stages = stages

        def replay(self, packed):
            pm, sweep, root = self.stages
            pmats = pm(packed)
            return root(sweep(pmats), pmats)

    monkeypatch.setattr(forward_graph, "eligible", lambda *a: True)
    monkeypatch.setattr(forward_graph, "capture",
                        lambda stages, eager, device, packed:
                        (eager(), Stages(stages)))
    multipartition._graphs.clear()
    before = counts()
    device = torch.device("cpu")
    choices = [multipartition._choice(g, device) for g in c.mp.groups]
    assert None not in choices
    for f in (1.0, 0.8, 1.3, 0.9):
        bl = c.bl * f
        pm, sweep, root = multipartition._stages(
            c.mp, c.models, c.tipchars, c.pw, c.inv, choices, device)
        packed = multipartition._packed(c.mp, bl, c.scalers)
        pmats = pm(packed)
        want = root(sweep(pmats), pmats).sum()
        assert torch.equal(multipartition.loglikelihood(*c.args(bl)), want)
    after = counts()
    assert {k: after[k] - before[k] for k in COUNTERS[3:]} == {
        forward_graph.EAGER: 1, forward_graph.CAPTURE: 1,
        forward_graph.REPLAY: 2}
    multipartition.loglikelihood(c.mp, list(reversed(c.models)), c.bl,
                                 c.tipchars, c.pw, c.inv, c.scalers)
    assert counts()[forward_graph.EAGER] - after[forward_graph.EAGER] == 1
    multipartition._graphs.clear()


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def card_case(device, states, mode, sites=None):
    """Three partitions of one group at `states`, f32, the form forced;
    sites a multiple of the "mma" small kernel's block where it runs."""
    sizes = sites or ([300, 130, 512] if states == 20 else [1000, 250, 700])
    return make_case(device, torch.float32,
                     specs=[(states, n) for n in sizes], seed=states,
                     use_kernel=True, sweep_mode=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("states", [4, 20])
@pytest.mark.parametrize("mode", ["fma", "mma"])
def test_batched_rows_equal_per_partition_launches(cuda_device, states,
                                                   mode):
    c = card_case(cuda_device, states, mode)
    g = c.mp.groups[0]
    tb, got_mode = multipartition._choice(g, cuda_device)
    assert got_mode == mode
    lay = g.layout(cuda_device, tb)
    choices = [(tb, mode)]
    pm = multipartition._stages(c.mp, c.models, c.tipchars, c.pw, c.inv,
                                choices, cuda_device)[0](
        multipartition._packed(c.mp, c.bl, c.scalers))[0]
    prog = g.program.vmem_prog
    tips = engine.block_tips(torch.cat(c.tipchars, dim=1), g.cfg, tb)
    before = partials_tree.sweep.launches
    clv, scal = partials_tree.sweep(tips, pm.view(-1, *pm.shape[2:]), prog,
                                    g.cfg, tb, mode=mode, p_base=lay.p_base)
    assert partials_tree.sweep.launches == before + 1
    start = 0
    for i, k in enumerate(g.members):
        alone = engine.block_tips(c.tipchars[k], c.mp.cfgs[k], tb)
        want_clv, want_scal = partials_tree.sweep(
            alone, pm[i].contiguous(), prog, c.mp.cfgs[k], tb, mode=mode)
        n = alone.shape[0]
        assert torch.equal(clv[:, start:start + n], want_clv)
        assert torch.equal(scal[:, start:start + n], want_scal)
        start += n
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("states,mode", [(4, "fma"), (4, "mma"),
                                         (20, "fma"), (20, "mma"),
                                         (5, "fma")])
def test_one_partition_table_gives_todays_rows(cuda_device, states, mode):
    """A table of one partition (p_base all 0) against no table, bit for
    bit, on each form (5 states: the generic one)."""
    c = card_case(cuda_device, states, mode,
                  sites=[1024] if mode == "mma" else [700])
    g = c.mp.groups[0]
    tb, _ = multipartition._choice(g, cuda_device)
    pm = multipartition._stages(c.mp, c.models, c.tipchars, c.pw, c.inv,
                                [(tb, mode)], cuda_device)[0](
        multipartition._packed(c.mp, c.bl, c.scalers))[0][0].contiguous()
    tips = engine.block_tips(c.tipchars[0], c.mp.cfgs[0], tb)
    prog = g.program.vmem_prog
    zeros = torch.zeros(tips.shape[0], dtype=torch.int32, device=cuda_device)
    a = partials_tree.sweep(tips, pm, prog, c.mp.cfgs[0], tb, mode=mode)
    b = partials_tree.sweep(tips, pm, prog, c.mp.cfgs[0], tb, mode=mode,
                            p_base=zeros)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("states", [4, 20])
def test_replay_equals_eager(cuda_device, states):
    """Calls through the graph path (eager, capture, replays) against the
    eager stages of each call, bit for bit; one sweep launch a call."""
    c = card_case(cuda_device, states, None)
    multipartition._graphs.clear()
    choices = [multipartition._choice(g, cuda_device) for g in c.mp.groups]
    factors = (1.0, 0.8, 1.25, 0.9, 1.1)
    want = []
    for f in factors:
        pm, sweep, root = multipartition._stages(
            c.mp, c.models, c.tipchars, c.pw, c.inv, choices, cuda_device)
        pmats = pm(multipartition._packed(c.mp, c.bl * f, c.scalers))
        want.append(root(sweep(pmats), pmats).sum())
    before = counts()
    launches = partials_tree.sweep.launches
    got = [multipartition.loglikelihood(*c.args(c.bl * f)) for f in factors]
    after = counts()
    assert partials_tree.sweep.launches - launches == len(factors)
    assert {k: after[k] - before[k] for k in COUNTERS[3:]} == {
        forward_graph.EAGER: 1, forward_graph.CAPTURE: 1,
        forward_graph.REPLAY: len(factors) - 2}
    for g_, w in zip(got, want):
        assert bool(torch.isfinite(g_)) and torch.equal(g_, w), (g_, w)
    np.testing.assert_allclose(got[0].item(), reference(c, c.bl).sum(),
                               rtol=1e-5)
    multipartition._graphs.clear()
