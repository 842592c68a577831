"""The port's mutable Partition against libpll2_tpu's, on the CPU in f64:
the same calls with the same inputs (made from a seed with numpy) through
both packages, case by case — DNA, 20-state LG, LG4X (four rate matrices
with per-category params_indices), set_tip_clv, +I, per-rate scalers,
each ascertainment-bias mode, pattern weights, a 60-taxon caterpillar that
rescues, site repeats.  Also the bf16 storage of the dense CLV update, the
memory accounting, the printers and FastParsimony(partition=...)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jpll
import libpll2_tpu_torch as ppll
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as JT
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.models.aa import aa_model
from libpll2_tpu.utils import memory as jmemory
from libpll2_tpu.utils import output as joutput
from libpll2_tpu_torch import engine as pengine
from libpll2_tpu_torch import tree as PT
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.utils import memory as pmemory
from libpll2_tpu_torch.utils import output as poutput

from .test_parity_tree import random_newick, random_seqs

AA = "ARNDCQEGHILKMFPSTWYV"
DNA_SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
DNA_FREQS = [0.3, 0.25, 0.2, 0.25]

# name -> (tips, sites, states, options); options: caterpillar, matrices
# (1 or 4 = LG4X), per_rate, asc_bias, pinv, weights, tip_clv (tips set
# through set_tip_clv), tiny_tips (every tip through set_tip_clv at 2^-5,
# so that the f64 rescue fires), repeats
CASES = {
    "dna": (16, 96, 4, {}),
    "lg": (10, 40, 20, {}),
    "lg4x": (8, 40, 20, {"matrices": 4}),
    "tip_clv": (12, 64, 4, {"tip_clv": (0, 5)}),
    "pinv": (12, 64, 4, {"pinv": 0.25}),
    "per_rate": (60, 32, 4, {"caterpillar": True, "per_rate": True,
                             "tiny_tips": True}),
    "asc_lewis": (10, 48, 4, {"asc_bias": jpll.AB_LEWIS}),
    "asc_felsenstein": (10, 48, 4, {"asc_bias": jpll.AB_FELSENSTEIN}),
    "asc_stamatakis": (10, 48, 4, {"asc_bias": jpll.AB_STAMATAKIS}),
    "weights": (12, 64, 4, {"weights": True}),
    "caterpillar60": (60, 32, 4, {"caterpillar": True, "tiny_tips": True}),
    "repeats": (16, 96, 4, {"repeats": True}),
}


def case_inputs(name):
    """Newick, sequences and the extra numpy inputs of a case (the same
    for both packages)."""
    tips, sites, states, opt = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    newick = random_newick(tips, rng, caterpillar=opt.get("caterpillar",
                                                          False))
    if opt.get("caterpillar"):
        newick = newick.replace(":0.05", ":0.9")
    alphabet = AA if states == 20 else "ACGT"
    if opt.get("repeats"):
        cols = rng.integers(0, states, size=(7, tips))
        mat = cols[rng.integers(0, 7, size=sites)]
        seqs = ["".join(alphabet[b] for b in mat[:, i]) for i in range(tips)]
    else:
        seqs = ["".join(alphabet[b] for b in rng.integers(0, states, sites))
                for _ in range(tips)]
    if opt.get("pinv"):
        seqs = ["A" * 16 + s[16:] for s in seqs]
    extra = {"weights": rng.integers(1, 6, sites).astype(float),
             "tip_clv": rng.uniform(0.05, 1.0, (tips, sites, 4, states)),
             "asc_weights": [2.0, 1.0, 3.0, 1.0]}
    return newick, seqs, extra


def make(pkg, T, name):
    """Build and update a Partition of `pkg` for case `name`; returns
    (partition, tree, params indices)."""
    tips, sites, states, opt = CASES[name]
    newick, seqs, extra = case_inputs(name)
    tree = T.parse_newick_string(newick)
    M = opt.get("matrices", 1)
    kw = {"per_rate_scalers": opt.get("per_rate", False),
          "asc_bias": opt.get("asc_bias", jpll.AB_NONE),
          "site_repeats": opt.get("repeats", False)}
    if pkg is ppll:
        kw["device"] = "cpu"
    p = pkg.Partition(tips, tree.inner_count, states, sites, M,
                      2 * tips - 3, 4, tree.inner_count, **kw)
    if states == 4:
        p.set_frequencies(0, DNA_FREQS)
        p.set_subst_params(0, DNA_SUBST)
    else:
        rates, freqs = aa_model("lg4x" if M == 4 else "lg")
        for m in range(M):
            p.set_frequencies(m, np.atleast_2d(freqs)[m])
            p.set_subst_params(m, np.atleast_2d(rates)[m])
    p.set_gamma_rates(0.8)
    if M == 4:
        p.set_category_weights([0.1, 0.2, 0.3, 0.4])
    charmap = pkg.MAP_AA if states == 20 else pkg.MAP_NT
    for i, s in enumerate(seqs):
        p.set_tip_states(i, charmap, s)
    if opt.get("tiny_tips"):
        alphabet = AA if states == 20 else "ACGT"
        codes = [[alphabet.index(c) for c in s] for s in seqs]
        onehot = np.eye(states)[codes]                    # [tips, sites, S]
        for i in range(tips):
            p.set_tip_clv(i, np.repeat(onehot[i][:, None, :] * 2.0 ** -5, 4,
                                       axis=1))
    for i in opt.get("tip_clv", ()):
        p.set_tip_clv(i, extra["tip_clv"][i])
    if opt.get("pinv"):
        p.update_invariant_sites_proportion(0, opt["pinv"])
    if opt.get("weights"):
        p.set_pattern_weights(extra["weights"])
    if opt.get("asc_bias") == jpll.AB_STAMATAKIS:
        p.set_asc_state_weights(extra["asc_weights"])
    ops, branches, pmat_idx = T.create_operations(T.traverse(tree.vroot))
    pi = list(range(4)) if M == 4 else [0] * 4
    p.update_prob_matrices(pi, pmat_idx, branches)
    p.update_partials(ops)
    return p, tree, pi


def ancestral_pairs(tree, T):
    """(node, scaler, other, scaler, pmatrix) of the root edge and of one
    tip edge."""
    root = tree.vroot
    pairs = [(root.clv_index, root.scaler_index, root.back.clv_index,
              root.back.scaler_index, root.pmatrix_index)]
    tip = tree.nodes[0]
    pairs.append((tip.back.clv_index, tip.back.scaler_index, tip.clv_index,
                  jpll.SCALE_BUFFER_NONE, tip.pmatrix_index))
    return pairs


@functools.cache
def results(name, port: bool):
    pkg, T = (ppll, PT) if port else (jpll, JT)
    p, tree, pi = make(pkg, T, name)
    root = tree.vroot
    edge = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index)
    out = {
        "root": p.compute_root_loglikelihood(root.clv_index,
                                             root.scaler_index, pi,
                                             return_persite=True),
        "edge": p.compute_edge_loglikelihood(*edge, root.pmatrix_index, pi,
                                             return_persite=True),
    }
    sumtable = p.update_sumtable(edge[0], edge[2], edge[1], edge[3], pi)
    out["derivatives"] = p.compute_likelihood_derivatives(
        sumtable, float(root.length) * 1.3, pi)
    out["ancestral"] = [p.compute_node_ancestral(*pair, pi)
                        for pair in ancestral_pairs(tree, T)]
    n_scalers = p.cfg.scale_buffers
    out["scalers"] = [p.get_scaler(i) for i in range(n_scalers)]
    out["clv"] = [p.get_clv(i) for i in range(p.cfg.num_clvs)]
    out["pmatrix"] = [p.get_pmatrix(i) for i in range(p.cfg.prob_matrices)]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_loglikelihoods(name):
    want, got = results(name, False), results(name, True)
    for key in ("root", "edge"):
        assert np.isfinite(got[key][0])
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-10)
        np.testing.assert_allclose(got[key][1], want[key][1], rtol=1e-10,
                                   atol=1e-300)


@pytest.mark.parametrize("name", sorted(CASES))
def test_derivatives(name):
    np.testing.assert_allclose(results(name, True)["derivatives"],
                               results(name, False)["derivatives"],
                               rtol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ancestral_states(name):
    for got, want in zip(results(name, True)["ancestral"],
                         results(name, False)["ancestral"]):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scalers_clvs_and_pmatrices(name):
    got, want = results(name, True), results(name, False)
    for a, b in zip(got["scalers"], want["scalers"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["clv"], want["clv"]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-300)
    for a, b in zip(got["pmatrix"], want["pmatrix"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    if CASES[name][3].get("tiny_tips"):
        assert max(int(np.max(s)) for s in got["scalers"]) > 0, \
            "the case was meant to rescue"


def test_invariant_site_counts():
    pj, _, _ = make(jpll, JT, "pinv")
    pp, _, _ = make(ppll, PT, "pinv")
    assert pp.count_invariant_sites() == pj.count_invariant_sites() >= 16
    np.testing.assert_array_equal(pp.invariant, pj.invariant)


# --------------------------------------------------------------------------
# bf16 CLV storage in the dense update
# --------------------------------------------------------------------------

def bf16_case(tips):
    rng = np.random.default_rng(tips)
    sites = 256
    newick = random_newick(tips, rng)
    seqs = random_seqs(tips, sites, rng)
    raw = np.zeros((tips, sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = jpll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    return newick, raw, sites


def jax_dense_logl(tips, dt):
    newick, raw, sites = bf16_case(tips)
    tree = JT.parse_newick_string(newick)
    cfg = JConfig(tips=tips, clv_buffers=tree.inner_count, states=4,
                  sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3,
                  rate_cats=4, scale_buffers=tree.inner_count, dtype=dt,
                  use_pallas=False)
    program = jengine.compile_tree(tree, cfg)
    model = jengine.make_model([DNA_SUBST], [DNA_FREQS],
                               jpll.compute_gamma_cats(0.8, 4), dtype=dt)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    return float(jengine.loglikelihood(
        program, cfg, model,
        jnp.asarray(program.default_branch_lengths, dt),
        jnp.asarray(jengine.pad_tipchars(raw, cfg)), jnp.asarray(pw, dt),
        jnp.asarray(np.full(cfg.sites_padded, -1, np.int32))))


def port_dense_logl(tips, dt):
    newick, raw, sites = bf16_case(tips)
    tree = PT.parse_newick_string(newick)
    cfg = PartitionConfig(
        tips=tips, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=dt, use_kernel=False)
    program = pengine.compile_tree(tree, cfg)
    model = pengine.make_model([DNA_SUBST], [DNA_FREQS],
                               ppll.compute_gamma_cats(0.8, 4), dtype=dt,
                               device="cpu")
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    return pengine.loglikelihood(
        program, cfg, model,
        torch.as_tensor(program.default_branch_lengths, dtype=dt),
        torch.as_tensor(pengine.pad_tipchars(raw, cfg)),
        torch.as_tensor(pw, dtype=dt),
        torch.full((cfg.sites_padded,), -1, dtype=torch.int32)).item()


@pytest.mark.parametrize("tips", [24, 120])
def test_bf16_dense_update_matches_the_jax_package(tips):
    """bf16 is a storage format in both packages: each level accumulates
    in f32 and rounds the stored parent once (tests/test_memory.py's
    budget of 3e-4 against f64 holds for each)."""
    f64 = jax_dense_logl(tips, jnp.float64)
    jax_bf16 = jax_dense_logl(tips, jnp.bfloat16)
    port_bf16 = port_dense_logl(tips, torch.bfloat16)
    assert abs(port_dense_logl(tips, torch.float64) - f64) / abs(f64) < 1e-10
    assert abs(jax_bf16 - f64) / abs(f64) < 3e-4
    assert abs(port_bf16 - f64) / abs(f64) < 3e-4
    assert abs(port_bf16 - jax_bf16) / abs(jax_bf16) < 1e-3


# --------------------------------------------------------------------------
# memory accounting
# --------------------------------------------------------------------------

DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_memory_formulas_match_the_jax_package(dt):
    """The dense residency and max-sites formulas equal the JAX package's
    at the same card memory; dense_clv_bytes is what a Partition
    allocates for its CLVs and scalers."""
    tdt, jdt = DTYPES[dt]
    hbm = 80 * 10 ** 9
    for per_rate in (False, True):
        kw = dict(tips=24, clv_buffers=22, states=4, sites=500,
                  rate_matrices=1, prob_matrices=45, rate_cats=4,
                  scale_buffers=22, per_rate_scalers=per_rate)
        assert pmemory.dense_clv_bytes(PartitionConfig(dtype=tdt, **kw)) \
            == jmemory.dense_clv_bytes(JConfig(dtype=jdt, **kw))
        p = ppll.Partition(24, 22, 4, 500, 1, 45, 4, 22, dtype=tdt,
                           per_rate_scalers=per_rate, device="cpu")
        assert pmemory.dense_clv_bytes(p.cfg) == \
            p.clv.nbytes + p.scalers.nbytes
    for tips in (64, 256, 4096):
        for states in (4, 20):
            assert pmemory.max_sites(tips, states, 4, tdt, False,
                                     hbm_bytes=hbm) == \
                jmemory.max_sites(tips, states, 4, jdt, False,
                                  hbm_bytes=hbm)


def test_fast_path_bytes_counts_the_kernel_paths_tensors():
    """fast_path_bytes: the tensors engine.loglikelihood keeps through the
    tree sweep (its plain version on the CPU returns the same shapes)."""
    newick = random_newick(20, np.random.default_rng(3))
    tree = PT.parse_newick_string(newick)
    cfg = PartitionConfig(tips=20, clv_buffers=18, states=4, sites=1000,
                          rate_matrices=1, prob_matrices=37, rate_cats=4,
                          scale_buffers=18, dtype=torch.float32,
                          use_kernel=True)
    program = pengine.compile_tree(tree, cfg)
    model = pengine.make_model([DNA_SUBST], [DNA_FREQS],
                               ppll.compute_gamma_cats(0.8, 4),
                               dtype=torch.float32, device="cpu")
    tipchars = torch.ones((20, cfg.sites_padded), dtype=torch.int32)
    bl = torch.as_tensor(program.default_branch_lengths,
                         dtype=torch.float32)
    view, _ = pengine._sweep(program, cfg, model, bl, tipchars, None)
    tb = pengine.kernel_choice(program, cfg, tipchars.device)[0]
    blocked = pengine.block_tips(tipchars, cfg, tb)
    n_exp = view._clv_rows.shape[0]
    site_major = 2 * cfg.rate_cats * cfg.states * cfg.sites_padded * 4
    pmat = cfg.prob_matrices * cfg.rate_cats * cfg.states ** 2 * 4
    held = (tipchars.nbytes + blocked.nbytes + view._clv_rows.nbytes
            + view._scal_rows.nbytes + site_major + pmat
            + 4 * cfg.sites_padded * 4)
    assert n_exp == 2
    assert pmemory.fast_path_bytes(cfg) == held
    table = pmemory.max_sites_table(80 * 10 ** 9)
    assert table.count("|") > 40 and "4096" in table
    assert pmemory.max_sites(256, hbm_bytes=80 * 10 ** 9) > \
        pmemory.max_sites(256, fast_path=False, hbm_bytes=80 * 10 ** 9)


# --------------------------------------------------------------------------
# printers and parsimony from a partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dna", "repeats", "caterpillar60"])
def test_printers_byte_equal(name, capsys):
    """show_clv (through site_id on a class-indexed row) and show_pmatrix
    print what the JAX package prints."""
    printed = {}
    for pkg, T, out in ((jpll, JT, joutput), (ppll, PT, poutput)):
        p, tree, _ = make(pkg, T, name)
        node = tree.vroot
        out.show_clv(p, node.clv_index, node.scaler_index, 6)
        out.show_clv(p, tree.nodes[0].clv_index, jpll.SCALE_BUFFER_NONE)
        out.show_pmatrix(p, node.pmatrix_index, 5)
        printed[pkg] = capsys.readouterr().out
        if name == "repeats":
            assert p.get_site_id(node.clv_index) is not None
    assert printed[ppll] == printed[jpll]
    clv = results(name, True)["clv"][0].transpose(1, 2, 0)
    assert poutput.format_clv(clv, None, 5) == joutput.format_clv(clv, None,
                                                                  5)


@pytest.mark.parametrize("name", ["dna", "weights"])
def test_fast_parsimony_from_a_partition(name):
    """FastParsimony(partition=p) reads tipchars and pattern weights from
    the partition, as the JAX constructor does."""
    pj, tree_j, _ = make(jpll, JT, name)
    pp, tree_p, _ = make(ppll, PT, name)
    fj = jpll.FastParsimony(partition=pj)
    fp = ppll.FastParsimony(partition=pp)
    assert fp.packed.device.type == "cpu"
    ops_j = JT.create_pars_buildops(JT.traverse(tree_j.vroot))
    ops_p = PT.create_pars_buildops(PT.traverse(tree_p.vroot))
    fj.update_vectors(ops_j)
    fp.update_vectors(ops_p)
    r = tree_j.vroot
    assert fp.edge_score(r.clv_index, r.back.clv_index) == \
        fj.edge_score(r.clv_index, r.back.clv_index)
    assert fp.informative_count == fj.informative_count


@pytest.mark.parametrize("per_rate", [False, True])
def test_unrolled_update_equals_the_padded_program(per_rate):
    """update_partials_unrolled over levels without padding rows gives the
    rows update_partials gives over the padded [L, W, 8] program."""
    from libpll2_tpu_torch.ops import partials
    name = "per_rate" if per_rate else "dna"
    p, tree, _ = make(ppll, PT, name)
    ops, _, _ = PT.create_operations(PT.traverse(tree.vroot))
    padded = ppll.levelize_operations(ops, p.cfg)
    levels = [lv[lv[:, 0] != p.cfg.clv_scratch] for lv in padded]
    assert sum(len(lv) for lv in levels) == len(ops)
    clv, scalers = p.clv.clone(), p.scalers.clone()
    partials.update_partials_unrolled(clv, scalers, p.pmatrix, levels, p.cfg)
    n = p.cfg.num_clvs
    assert torch.equal(clv[:n], p.clv[:n])
    assert torch.equal(scalers[:p.cfg.scale_buffers],
                       p.scalers[:p.cfg.scale_buffers])
