"""Codon models at 61 states (GY94 + F3x4 + Gamma4) and the tip masks and
sweep form above 32 states: models/codon.py against the benchmark's own
codon builder (pllbench/reference/codon.py), int64 tip masks,
engine.loglikelihood and branch_derivatives at 61 states against the
benchmark's float64 reference, the wide form's table (its slots run in a
plain loop against sweep_reference), the choice and the refusals above 32
states.  On the card (marked `cuda`, skipped without one) the wide kernel
against sweep_reference at 33, 61 and 64 states, the choice with no
warning, and a forward-graph replay against the eager call.

On a GPU machine:

    python -m pytest tests/test_torch_codon.py -m cuda
"""
import dataclasses
import json
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from libpll2_tpu_torch import _build, engine, forward_graph, legacy_search
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import (gap_state, gap_state_int32,
                                         gap_state_mask)
from libpll2_tpu_torch.models import codon
from libpll2_tpu_torch.models.gamma import compute_gamma_cats
from libpll2_tpu_torch.ops import (edge_score, message_sweep, newton_edges,
                                   partials_tree)
from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick
from pllbench.reference import codon as ref_codon
from pllbench.reference import likelihood as ref_likelihood
from pllbench.reference import newick as ref_newick

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "pllbench" / "configs" /
                     "gy94_f3x4_g4_codon_128x16384.json").read_text())
KAPPA, OMEGA = 2.5, 0.2
TABLE = [[0.26, 0.22, 0.33, 0.19], [0.31, 0.23, 0.17, 0.29],
         [0.18, 0.32, 0.30, 0.20]]
CPU = torch.device("cpu")


def caterpillar(n):
    s = "(t0:0.1,t1:0.2)"
    for i in range(2, n - 2):
        s = f"({s}:0.05,t{i}:0.1)"
    return f"({s}:0.05,t{n - 2}:0.1,t{n - 1}:0.1);"


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _q(subst, freqs):
    pi = np.asarray(freqs)
    n = len(pi)
    s = np.zeros((n, n))
    s[np.triu_indices(n, 1)] = subst
    q = (s + s.T) * pi[None, :]
    q[np.diag_indices(n)] = -q.sum(axis=1)
    return q / -(pi * np.diag(q)).sum(), pi


MODEL_CASES = ["states", "exchangeabilities", "f3x4", "q_matrix",
               "torch_forms", "config"]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_codon_model(case):
    """The program's GY94 + F3x4 against the benchmark's own builder and
    the definitions.  Exchangeabilities are exact (products of the same
    three numbers); frequencies within 1e-15 (sums in another order)."""
    subst = codon.gy94_exchangeabilities(KAPPA, OMEGA)
    freqs = codon.f3x4_frequencies(TABLE)
    if case == "states":
        assert codon.CODON_STATES == 61
        assert list(codon.SENSE_CODONS) == ref_codon.sense_codons()
        assert codon.SENSE_CODONS[:3] == ("AAA", "AAC", "AAG")
        assert codon.SENSE_CODONS[-1] == "TTT"
        assert {"TAA", "TAG", "TGA"}.isdisjoint(codon.SENSE_CODONS)
        assert list(codon.SENSE_CODONS) == sorted(codon.SENSE_CODONS)
    elif case == "exchangeabilities":
        assert subst.shape == (61 * 60 // 2,)
        assert set(np.unique(subst)) <= {0.0, 1.0, KAPPA, OMEGA,
                                         KAPPA * OMEGA}
        assert np.array_equal(subst, ref_codon.gy94(KAPPA, OMEGA))
        # 263 single-nucleotide pairs among the standard code's sense codons
        assert int((subst > 0).sum()) == 263
        # AAA-AAG: a synonymous transition (Lys); AAA-AAC: Lys-Asn, a
        # nonsynonymous transversion
        index = {c: i for i, c in enumerate(codon.SENSE_CODONS)}
        full = np.zeros((61, 61))
        full[np.triu_indices(61, 1)] = subst
        assert full[index["AAA"], index["AAG"]] == KAPPA
        assert full[index["AAA"], index["AAC"]] == OMEGA
        assert full[index["AAA"], index["CCC"]] == 0.0
    elif case == "f3x4":
        assert freqs.shape == (61,)
        assert abs(freqs.sum() - 1.0) < 1e-15
        np.testing.assert_allclose(freqs, ref_codon.f3x4(TABLE), rtol=1e-15,
                                   atol=0)
        aaa = TABLE[0][0] * TABLE[1][0] * TABLE[2][0]
        stops = sum(TABLE[0][3] * TABLE[1][a] * TABLE[2][b]
                    for a, b in ((0, 0), (0, 2), (2, 0)))
        np.testing.assert_allclose(freqs[0], aaa / (1 - stops), rtol=1e-14)
    elif case == "q_matrix":
        q, pi = _q(subst, freqs)
        np.testing.assert_allclose(q.sum(axis=1), 0.0, atol=1e-13)
        np.testing.assert_allclose(pi[:, None] * q, (pi[:, None] * q).T,
                                   atol=1e-15)
        assert abs(-(pi * np.diag(q)).sum() - 1.0) < 1e-13
        # the engine's eigensystem gives the same Q
        model = engine.make_model([subst], [freqs], compute_gamma_cats(
            0.5, 4), device="cpu")
        v = model.inv_eigenvecs[0].numpy()
        u = model.eigenvecs[0].numpy()
        lam = model.eigenvals[0].numpy()
        np.testing.assert_allclose(v @ np.diag(lam) @ u, q, atol=1e-12)
    elif case == "torch_forms":
        kappa = torch.tensor(KAPPA, dtype=torch.float64, requires_grad=True)
        s = codon.gy94_exchangeabilities_torch(kappa, OMEGA)
        assert np.array_equal(s.detach().numpy(), subst)
        s.sum().backward()
        single, ts, nonsyn = codon._pair_classes()
        assert kappa.grad.item() == pytest.approx(
            float((ts & ~nonsyn).sum() + OMEGA * (ts & nonsyn).sum()))
        f = codon.f3x4_frequencies_torch(torch.tensor(TABLE,
                                                      dtype=torch.float64))
        np.testing.assert_allclose(f.numpy(), freqs, rtol=1e-15, atol=0)
    elif case == "config":
        model = CONFIG["model"]
        spec = model["codon"]
        assert model["states"] == 61 and model["rate_cats"] == 4
        assert (spec["kappa"], spec["omega"], spec["f3x4"]) == (
            KAPPA, OMEGA, TABLE)
        for builder in (codon.gy94_exchangeabilities, ref_codon.gy94):
            assert np.array_equal(model["subst"],
                                  builder(spec["kappa"], spec["omega"]))
        for builder in (codon.f3x4_frequencies, ref_codon.f3x4):
            np.testing.assert_allclose(model["freqs"], builder(spec["f3x4"]),
                                       rtol=1e-15, atol=0)


# --------------------------------------------------------------------------
# tip masks
# --------------------------------------------------------------------------

def _cfg(states, tips=5, sites=40, **kw):
    return PartitionConfig(tips=tips, clv_buffers=tips - 2, states=states,
                           sites=sites, rate_matrices=1,
                           prob_matrices=2 * tips - 3, rate_cats=4,
                           scale_buffers=tips - 2, **kw)


@pytest.mark.parametrize("states", [33, 61, 64])
def test_wide_tip_masks_round_trip(states):
    """Above 32 states the masks are int64: every state, ambiguities and
    the gap (all ones, -1 at 64 states) decode to their bits and back."""
    cfg = _cfg(states)
    rng = np.random.default_rng(states)
    one = np.uint64(1) << rng.integers(0, states, (cfg.tips, cfg.sites),
                                       dtype=np.uint64)
    two = one | (np.uint64(1) << np.uint64(states - 1))
    codes = np.where(rng.random((cfg.tips, cfg.sites)) < 0.3, two, one)
    codes[0, :3] = gap_state(states)
    pad = engine.pad_tipchars(codes, cfg)
    assert pad.dtype == np.int64 and pad.shape == (cfg.tips,
                                                   cfg.sites_padded)
    assert (pad[:, cfg.sites:] == gap_state_mask(states)).all()
    assert gap_state_mask(states) == (-1 if states == 64 else
                                      (1 << states) - 1)
    clv = engine.expand_tipchars(torch.as_tensor(pad), states, torch.float64)
    assert clv.shape == (cfg.tips, states, cfg.sites_padded)
    bits = (codes[:, None, :] >> np.arange(states, dtype=np.uint64)[
        None, :, None]) & np.uint64(1)
    assert np.array_equal(clv[:, :, :cfg.sites].numpy(), bits)
    assert (clv[0, :, :3] == 1).all() and (clv[:, :, cfg.sites:] == 1).all()
    back = (clv.numpy().astype(np.uint64)
            << np.arange(states, dtype=np.uint64)[None, :, None]).sum(
                axis=1, dtype=np.uint64)
    assert np.array_equal(back[:, :cfg.sites], codes)
    blocked = engine.block_tips(torch.as_tensor(pad), cfg, 8)
    assert blocked.dtype == torch.int64


@pytest.mark.parametrize("states", [4, 20, 32])
def test_narrow_tip_masks_unchanged(states):
    """Up to 32 states pad_tipchars and block_tips give int32, the values
    the int32-only code gave (np.full of gap_state_int32, codes cast to
    int32)."""
    cfg = _cfg(states)
    rng = np.random.default_rng(states)
    codes = np.uint64(1) << rng.integers(0, states, (cfg.tips, cfg.sites),
                                         dtype=np.uint64)
    pad = engine.pad_tipchars(codes, cfg)
    want = np.full((cfg.tips, cfg.sites_padded), gap_state_int32(states),
                   dtype=np.int32)
    want[:, :cfg.sites] = codes.astype(np.int32)
    assert pad.dtype == np.int32 and np.array_equal(pad, want)
    assert engine.block_tips(torch.as_tensor(pad), cfg, 8).dtype == \
        torch.int32


# --------------------------------------------------------------------------
# the likelihood at 61 states against the benchmark's reference
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    newick: str
    ref_tree: object
    chars: dict
    program: object
    cfg: PartitionConfig
    model: object
    bl: torch.Tensor
    tipchars: torch.Tensor
    pw: torch.Tensor
    inv: torch.Tensor
    perm: np.ndarray

    def args(self, bl=None):
        return (self.program, self.cfg, self.model,
                self.bl if bl is None else bl, self.tipchars, self.pw,
                self.inv)

    def reference(self, bl) -> float:
        """The reference's f64 logL at the program's lengths `bl`."""
        lengths = np.empty(len(self.perm))
        lengths[self.perm] = np.asarray(bl, dtype=np.float64)
        m = CONFIG["model"]
        return float(ref_likelihood.loglikelihood(
            self.ref_tree, [lengths], self.chars, m["subst"], m["freqs"],
            m["alpha"], m["rate_cats"])[0])


def make_case(seed, dtype=torch.float64, tips=12, sites=64, device=CPU,
              use_kernel=None, per_rate=False, rates=4, states=61,
              newick=None, bl_scale=1.0, ambiguous=False) -> Case:
    """A seeded random tree and alignment at 61 states (GY94 + F3x4 of the
    configuration) or, at another state count, a random GTR model."""
    from pllbench import inputs
    rng = np.random.default_rng(seed)
    text = newick or random_newick(tips, rng, min_bl=0.02, max_bl=0.35)
    ref_tree = ref_newick.parse(text)
    if states == 61:
        m = CONFIG["model"]
        subst, freqs = m["subst"], m["freqs"]
    else:
        subst = rng.uniform(0.2, 3.0, states * (states - 1) // 2)
        freqs = rng.dirichlet(np.full(states, 5.0))
    rates_v = compute_gamma_cats(0.5, rates)
    chars = inputs.simulate_alignment(ref_tree, sites, rng, subst, freqs,
                                      rates_v)
    if ambiguous:
        for label, c in chars.items():
            extra = np.uint64(1) << rng.integers(0, states, sites,
                                                 dtype=np.uint64)
            chars[label] = np.where(rng.random(sites) < 0.2, c | extra, c)
            chars[label][rng.random(sites) < 0.05] = gap_state(states)
    tree = T.parse_newick_string(text)
    n = tree.tip_count
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=rates,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        dtype=dtype, use_kernel=use_kernel)
    program = engine.compile_tree(tree, cfg)
    probe = engine.compile_tree(T.parse_newick_string(ref_newick.write(
        ref_tree, [float(k + 1) for k in range(len(ref_tree.lengths))])),
        cfg)
    perm = np.rint(probe.default_branch_lengths).astype(np.int64) - 1
    model = engine.make_model([subst], [freqs], rates_v, dtype=dtype,
                              device=device)
    codes = np.zeros((n, sites), dtype=np.uint64)
    for node in tree.nodes[:n]:
        codes[node.clv_index] = chars[node.label]
    tipchars = torch.as_tensor(engine.pad_tipchars(codes, cfg),
                               device=device)
    pw = torch.zeros(cfg.sites_padded, dtype=dtype, device=device)
    pw[:sites] = 1.0
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=device)
    bl = torch.as_tensor(program.default_branch_lengths * bl_scale,
                         dtype=dtype, device=device)
    return Case(text, ref_tree, chars, program, cfg, model, bl, tipchars,
                pw, inv, perm)


# f64: the same pruning in another order, 1e-11.  f32: the port's f32 P
# and CLVs over 12 taxa x 64 codons: a relative gap of a few 1e-8 (the
# benchmark's own f32 cells read 2e-8 to 2e-7); 1e-6 leaves room and is
# below what TF32 products give (the configuration's control).
TOLERANCE = {torch.float64: 1e-11, torch.float32: 1e-6}


@pytest.mark.parametrize("path", ["dense", "wide_plain"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [3, 17])
def test_loglikelihood_61_states(seed, dtype, path):
    """engine.loglikelihood at 61 states, on the dense path and (f32) on
    the wide form's plain version (use_kernel=True on CPU tensors: the
    schedule, int64 blocked tips and sweep_reference), against the
    reference in float64."""
    if path == "wide_plain" and dtype == torch.float64:
        cfg = make_case(seed, dtype).cfg
        reason = partials_tree.unsupported(
            engine.compile_tree(T.parse_newick_string(random_newick(
                12, np.random.default_rng(seed))), cfg)
            .vmem_prog, cfg, mode=partials_tree.WIDE)
        assert "f32" in reason
        return
    c = make_case(seed, dtype, use_kernel=path == "wide_plain")
    choice = engine.kernel_choice(c.program, c.cfg, CPU)
    assert (choice is None) == (path == "dense")
    if choice is not None:
        assert choice[1] == partials_tree.WIDE
    got = float(engine.loglikelihood(*c.args()))
    want = c.reference(c.bl.double().numpy())
    assert abs(got - want) / abs(want) < TOLERANCE[dtype], (got, want)


@pytest.mark.parametrize("seed", [5, 11])
def test_branch_derivatives_61_states(seed):
    """(d1, d2) of -lnL at 61 states, f64, from the message sweep (dense
    plain path), against central differences of the reference's logL:
    h = 1e-6 for d1 (rounding ~1e-7 absolute on logL ~ 1e3), h = 1e-4 for
    d2."""
    c = make_case(seed, torch.float64)
    full = engine.compile_tree_full(T.parse_newick_string(c.newick), c.cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d1, d2 = engine.branch_derivatives(full, *c.args()[1:])
    bl = c.bl.numpy()
    for e in (0, 5, len(bl) - 1):
        def f(dt):
            b = bl.copy()
            b[e] += dt
            return c.reference(b)
        h = 1e-6
        fd1 = (f(h) - f(-h)) / (2 * h)
        np.testing.assert_allclose(d1[e].item(), -fd1, rtol=1e-5, atol=1e-6)
        h = 1e-4
        fd2 = (f(h) - 2 * f(0.0) + f(-h)) / h ** 2
        np.testing.assert_allclose(d2[e].item(), -fd2, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the wide form's table and host side
# --------------------------------------------------------------------------

def run_wide_table(prog, cfg, tip_blocked, pmatrix):
    """The wide kernel's data flow in a plain loop: the ops of
    wide_device_table in order, each inner child's P-matrix of each rate
    the next of wide_items, parents into its n_slots pool slots or
    straight to their export rows, every site's rescue decided on the
    whole parent.  Returns (rows [E, NT, R, S, TB], scalers [E, NT, SR,
    TB]) as sweep() does."""
    table, n_slots = partials_tree.wide_device_table(prog)
    nt, _, tb = tip_blocked.shape
    R, S = cfg.rate_cats, cfg.states
    sr = R if cfg.per_rate_scalers else 1
    pool = torch.full((n_slots, nt, R, S, tb), float("nan"),
                      dtype=pmatrix.dtype)
    spool = torch.full((n_slots, nt, sr, tb), -99, dtype=torch.int32)
    n_exp = len(prog.exports)
    out = torch.full((n_exp, nt, R, S, tb), float("nan"),
                     dtype=pmatrix.dtype)
    sout = torch.full((n_exp, nt, sr, tb), -99, dtype=torch.int32)
    shifts = torch.arange(S, dtype=torch.int64)[:, None]
    # the staged P-matrices, in the order the kernel takes them
    items = iter(partials_tree.wide_items(prog, R, CPU).tolist())
    for tip1, tip2, pm1, pm2, parent, c1, c2, _ in table.tolist():
        for r in range(R):
            for tip, pm in ((tip1, pm1), (tip2, pm2)):
                if tip < 0:
                    assert next(items) == pm * R + r
        msgs, scal = [], 0
        for tip, pm, slot in ((tip1, pm1, c1), (tip2, pm2, c2)):
            if tip >= 0:
                bits = ((tip_blocked[:, tip, None, :] >> shifts) & 1).to(
                    pmatrix.dtype)
                child = bits[:, None].expand(nt, R, S, tb)
            else:
                assert 0 <= slot < n_slots
                child, scal = pool[slot], scal + spool[slot]
            msgs.append(torch.einsum("rij,nrjt->nrit", pmatrix[pm], child))
        value = msgs[0] * msgs[1]
        below = value < cfg.scale_threshold
        mask = below.all(dim=2) if cfg.per_rate_scalers else \
            below.all(dim=2).all(dim=1, keepdim=True)
        value = torch.where(mask[:, :, None], value * cfg.scale_factor,
                            value)
        scal = mask.to(torch.int32) + scal
        if parent >= 0:
            assert parent not in (c1 if tip1 < 0 else -1,
                                  c2 if tip2 < 0 else -1)
            pool[parent], spool[parent] = value, scal
        else:
            out[-1 - parent], sout[-1 - parent] = value, scal
    assert next(items, None) is None
    return out, sout


WIDE_TREES = {
    "random24": lambda: random_newick(24, np.random.default_rng(1)),
    "random128": lambda: random_newick(128, np.random.default_rng(2),
                                       min_bl=0.02, max_bl=0.35),
    "balanced32": lambda: balanced_newick(32, 0.1),
    "caterpillar20": lambda: caterpillar(20),
    "three": lambda: "(t0:0.1,t1:0.2,t2:0.3);",
}


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("tree", list(WIDE_TREES))
def test_wide_table_runs_like_the_schedule(tree, per_rate):
    """The wide table's slots and export rows, run in a plain loop, give
    sweep_reference's rows bit for bit (f64, 33 states, ambiguous codes
    and gaps, scaled lengths: sites rescue at 128 taxa), with no more
    slots than the schedule's pool."""
    newick = WIDE_TREES[tree]()
    c = make_case(1, torch.float64, states=33, sites=24, newick=newick,
                  per_rate=per_rate, bl_scale=8.0, ambiguous=True)
    prog = c.program.vmem_prog
    table, n_slots = partials_tree.wide_device_table(prog)
    assert table.dtype == np.int32 and table.shape == (prog.n_ops, 8)
    assert n_slots <= prog.pool_size
    assert sorted(-1 - table[table[:, 4] < 0, 4]) == list(range(
        len(prog.exports)))
    pmatrix = engine.pmatrix_buffer(c.program, c.cfg, c.model, c.bl)
    tb = 8
    tip_b = engine.block_tips(c.tipchars, c.cfg, tb)
    want = partials_tree.sweep_reference(tip_b, pmatrix, prog, c.cfg, tb)
    got = run_wide_table(prog, c.cfg, tip_b, pmatrix)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    if tree == "random128":
        assert int(want[1].max()) > 0


def test_wide_slots_at_the_cell():
    """The cell's random 128-taxon trees need 5 or 6 slots of the wide
    pool (4 to 7 of the schedule's pool), so a 32-site block of 61 states
    and 4 rates fits an H100's shared memory."""
    from pllbench import inputs
    counts = set()
    for seed in range(12):
        text = inputs.random_newick(128, inputs.rng(2 ** 31 + seed, 0),
                                    0.02, 0.35)
        tree = T.parse_newick_string(text)
        cfg = _cfg(61, tips=128, sites=16384, dtype=torch.float32)
        cfg = dataclasses.replace(cfg, clv_buffers=tree.inner_count,
                                  scale_buffers=tree.inner_count)
        prog = engine.compile_tree(tree, cfg).vmem_prog
        n_slots = partials_tree.wide_device_table(prog)[1]
        counts.add(n_slots)
        assert partials_tree.wide_smem_bytes(n_slots, cfg, 32) <= \
            partials_tree.SMEM_LIMIT
        assert partials_tree.choose(prog, cfg, sm_count=132) == (
            32, partials_tree.WIDE)
    assert counts <= {4, 5, 6}


def test_wide_constants_match_the_source():
    """The host's copies of the .cu's constants, and its shared-memory
    formula's terms, read from csrc/tree_sweep_wide.cu."""
    src = (_build.SOURCE_DIR / "tree_sweep_wide.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);",
                             src).group(1))
    assert const("WIDE_SMAX") == partials_tree.WIDE_P_ROWS
    assert const("THREADS_A_SITE") == partials_tree.WIDE_THREADS_A_SITE
    assert "tree_sweep_wide.cu" in _build.SOURCE_NAMES
    assert "tree_sweep" in "tree_sweep_wide_kernel"
    cfg = _cfg(61, dtype=torch.float32)
    R, S, tb = 4, 61, 32
    assert partials_tree.wide_smem_bytes(6, cfg, tb) == 4 * (
        6 * (R * S + 1) * tb + 2 * S * 64 + S * tb + 2 * tb)


CHOICE_CASES = {
    "codon_f32": (dict(states=61), (32, "wide")),
    "per_rate": (dict(states=61, per_rate_scalers=True), (32, "wide")),
    "s33_r1": (dict(states=33), (32, "wide")),
    "s64": (dict(states=64), (32, "wide")),
    "bf16": (dict(states=61, dtype=torch.bfloat16), None),
    "f64": (dict(states=61, dtype=torch.float64), None),
}


@pytest.mark.parametrize("case", list(CHOICE_CASES))
def test_wide_choice(case):
    """choose takes the wide form at f32 for 33-64 states, at the cell's
    site count in its 32-site block; f64 and bf16 have no form above 32
    states, and under use_kernel=None the engine warns and takes the dense
    path; under use_kernel=True it raises."""
    kw, want = CHOICE_CASES[case]
    kw = dict(kw)
    states = kw.pop("states")
    tree = T.parse_newick_string(random_newick(40, np.random.default_rng(0)))
    cfg = PartitionConfig(
        tips=40, clv_buffers=tree.inner_count, states=states, sites=16384,
        rate_matrices=1, prob_matrices=77,
        rate_cats=1 if case == "s33_r1" else 4,
        scale_buffers=tree.inner_count, dtype=kw.pop("dtype", torch.float32),
        **kw)
    program = engine.compile_tree(tree, cfg)
    assert partials_tree.choose(program.vmem_prog, cfg, sm_count=132) == want
    assert "32" in partials_tree.unsupported(program.vmem_prog, cfg,
                                             mode="fma")
    cuda = torch.device("cuda")
    limit = partials_tree.SMEM_LIMIT
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = engine.kernel_choice_for(program, cfg, cuda, limit, 132)
    assert got == want
    assert bool(seen) == (want is None)
    if want is None:
        assert "'wide'" in str(seen[0].message)
        with pytest.raises(ValueError, match="'wide'"):
            engine.kernel_choice_for(program, dataclasses.replace(
                cfg, use_kernel=True), cuda, limit, 132)


def test_wide_counters_in_graph_replays():
    """A graph replay adds the wide launches its capture made (the sweep
    counters forward_graph keeps); the dense path counts its sweeps above
    32 states."""
    by_mode = partials_tree.sweep.launches_by_mode
    before = forward_graph._sweep_counts()
    wide = by_mode[partials_tree.WIDE]
    by_mode[partials_tree.WIDE] += 2
    partials_tree.sweep.launches += 2
    delta = forward_graph._sweep_delta(forward_graph._sweep_counts(), before)
    forward_graph._set_sweep_counts(before)
    assert by_mode[partials_tree.WIDE] == wide
    assert delta[1][partials_tree.WIDE] == 2 and delta[0] == 2
    forward_graph._add_sweep_counts(delta)
    assert by_mode[partials_tree.WIDE] == wide + 2
    forward_graph._set_sweep_counts(before)
    assert by_mode[partials_tree.WIDE] == wide
    dense = partials_tree.sweep.wide_dense_calls
    c = make_case(2, torch.float64, tips=6, sites=16)
    engine.loglikelihood(*c.args())
    assert partials_tree.sweep.wide_dense_calls == dense + 1


# --------------------------------------------------------------------------
# refusals above 32 states
# --------------------------------------------------------------------------

REFUSALS = ["message_sweep", "newton_edges", "edge_scores", "legacy_search",
            "fma_sweep"]


@pytest.mark.parametrize("entry", REFUSALS)
def test_entries_refuse_more_than_32_states(entry):
    """Every entry that reads int32 tip masks or is built for at most 32
    states raises a ValueError naming the limit at 61 states, rather than
    truncating the masks."""
    c = make_case(4, torch.float32, tips=6, sites=16)
    cfg = c.cfg
    R, S, T_ = cfg.rate_cats, cfg.states, cfg.sites_padded
    with pytest.raises(ValueError, match="32") as err:
        if entry == "message_sweep":
            full = engine.compile_tree_full(T.parse_newick_string(c.newick),
                                            cfg)
            message_sweep.sweep_messages(
                torch.as_tensor(full.level_ops, dtype=torch.int64),
                torch.zeros((4, R, S, S)), c.tipchars, full.cfg_ext)
        elif entry == "newton_edges":
            newton_edges.newton_edges(
                torch.zeros((4, R, S, T_)), torch.zeros((3, 4),
                                                        dtype=torch.int64),
                torch.zeros(1, dtype=torch.int64), torch.zeros(3),
                torch.zeros((R * S, R * S)), torch.zeros((R * S, R * S)),
                torch.zeros((R * S, 2)), torch.zeros(T_), newton_iters=3,
                min_branch=1e-8, max_branch=100.0)
        elif entry == "edge_scores":
            z = torch.zeros
            edge_score.edge_scores(
                z((1, 2, R, S, T_)), z((1, 2, T_), dtype=torch.int32),
                z((2, R, S, T_)), z((2, T_), dtype=torch.int32),
                z((3, R, S, S)), z((1, 1, 12), dtype=torch.int32),
                z((1, 2), dtype=torch.int32), z(1), z((R * S, R * S)),
                z((R * S, R * S)), z((R * S, 2)), z(T_), newton_iters=3,
                log_thresh=-177.0)
        elif entry == "legacy_search":
            legacy_search.ml_spr_round(T.parse_newick_string(c.newick), cfg,
                                       c.model, c.chars)
        else:
            engine.kernel_choice_for(
                c.program, dataclasses.replace(cfg, use_kernel=True,
                                               sweep_mode="fma"),
                torch.device("cuda"), partials_tree.SMEM_LIMIT, 132)
    assert "61" in str(err.value)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


KERNEL_CASES = {
    "s61_r4": dict(states=61),
    "s61_r4_per_rate": dict(states=61, per_rate=True),
    "s61_r1": dict(states=61, rates=1),
    "s33_r4": dict(states=33),
    "s33_r1_per_rate": dict(states=33, rates=1, per_rate=True),
    "s64_r4": dict(states=64),
    "s64_r1": dict(states=64, rates=1),
    "s61_odd_sites": dict(states=61, sites=1000),
    "s61_scaled": dict(states=61, bl_scale=6.0, per_rate=True),
}


def wide_launches():
    """The wide form's launches so far (its per-mode count)."""
    return partials_tree.sweep.launches_by_mode[partials_tree.WIDE]


def card_rows(c, tb, mode):
    pmatrix = engine.pmatrix_buffer(c.program, c.cfg, c.model, c.bl)
    tip_b = engine.block_tips(c.tipchars, c.cfg, tb)
    return partials_tree.sweep(tip_b, pmatrix, c.program.vmem_prog, c.cfg,
                               tb, mode=mode), (tip_b, pmatrix)


@pytest.mark.cuda
@pytest.mark.parametrize("tb", [32, 16, 8])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_wide_kernel_matches_plain(cuda_device, case, tb):
    """The wide kernel against sweep_reference (the same inputs on the
    card, f32): scalers exact where no site's rescue flips, CLV rows
    within 1e-5 of each site's largest entry, a flipped rescue
    compensated (chip_smoke.compare_rows_site: sums of 61 products in
    another order, and f32 P-matrices whose smallest entries, three
    substitutions apart, carry rounding far above their own size);
    ambiguous codes and gaps in the tips; site counts that are and are
    not a multiple of the block (1,000 codons pad to 1,024)."""
    import chip_smoke
    spec = dict(KERNEL_CASES[case])
    c = make_case(7, torch.float32, tips=40, sites=spec.pop("sites", 2048),
                  device=cuda_device, use_kernel=True, ambiguous=True,
                  **spec)
    before = wide_launches()
    (clv, scal), (tip_b, pmatrix) = card_rows(c, tb, partials_tree.WIDE)
    torch.cuda.synchronize()
    assert wide_launches() == before + 1
    want_clv, want_scal = partials_tree.sweep_reference(
        tip_b, pmatrix, c.program.vmem_prog, c.cfg, tb)
    site, flips, comp, err = chip_smoke.compare_rows_site(
        clv, want_clv, scal, want_scal)
    assert flips <= 2 and site < 1e-5 and comp < 1e-5, (site, flips, comp,
                                                         err)
    assert bool(torch.isfinite(clv).all())
    if case == "s61_scaled":
        assert int(want_scal.max()) > 0
    lib = _build.library()
    n_slots = partials_tree.wide_device_table(c.program.vmem_prog)[1]
    assert lib.tree_sweep_wide_smem(n_slots, c.cfg.rate_cats, c.cfg.states,
                                    int(c.cfg.per_rate_scalers), tb) == \
        partials_tree.wide_smem_bytes(n_slots, c.cfg, tb)


@pytest.mark.cuda
def test_wide_choice_on_the_card(cuda_device):
    """kernel_choice takes the wide form at 61 states, f32, with no
    warning, and loglikelihood runs it: within 1e-6 of the reference."""
    c = make_case(9, torch.float32, tips=64, sites=4096,
                  device=cuda_device)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        choice = engine.kernel_choice(c.program, c.cfg, cuda_device)
        before = wide_launches()
        got = float(engine.loglikelihood(*c.args()))
    assert choice[1] == partials_tree.WIDE
    assert wide_launches() == before + 1
    want = c.reference(c.bl.double().cpu().numpy())
    assert abs(got - want) / abs(want) < 1e-6, (got, want)


@pytest.mark.cuda
def test_wide_graph_replay_equals_eager(cuda_device):
    """At 61 states the forward's CUDA graphs replay the eager call's
    logL bit for bit, and each replay counts its wide launch."""
    c = make_case(12, torch.float32, tips=48, sites=2048,
                  device=cuda_device)
    factors = (1.0, 0.8, 1.25, 0.9, 1.1)
    want = []
    for f in factors:     # the eager path's logL, outside the cache
        view, pmatrix = engine._sweep(c.program, c.cfg, c.model, c.bl * f,
                                      c.tipchars, c.pw)
        want.append(engine._root_logl(c.program, c.cfg, c.model, view,
                                      pmatrix, c.pw, c.inv))
    before = wide_launches()
    replays = engine.loglikelihood.graph_replays
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [engine.loglikelihood(*c.args(c.bl * f)) for f in factors]
    torch.cuda.synchronize()
    assert engine.loglikelihood.graph_replays == replays + len(factors) - 2
    assert wide_launches() == before + len(factors)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g)) and torch.equal(g, w), (g, w)

