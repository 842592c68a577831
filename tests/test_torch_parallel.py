"""The port's multi-process layer (parallel/) against libpll2_tpu on the
CPU: worlds of 2 and 4 gloo ranks, one process a rank, started by
parallel.launcher.launch with a FileStore under the test's tmp_path.  Each
rank runs the port on its slice of the sites; the JAX package prices the
same inputs (made from a seed with numpy) unsharded, in f64 on its XLA
path, as tests/test_distributed.py does.

Tolerances: logL rtol 1e-12, all-branch (d1, d2) 1e-9 (the JAX test's);
optimize_root_branch 1e-10; the SPR round's logL 1e-12 and scores 1e-10
with the same finite mask (the JAX sharded-round test's); asc bias with
its phantom columns across the rank boundary 1e-10.  Every result must be
bit-identical across the ranks.

The rank functions (`_rank_*`) live here and import no JAX, so that a
rank starts quickly: the JAX package is imported inside the tests."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import search_fast as sf
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import (AB_FELSENSTEIN, AB_LEWIS,
                                         AB_STAMATAKIS)
from libpll2_tpu_torch.parallel import (distributed, launcher,
                                        pad_sites_to_mesh, replicated,
                                        shard_site_arrays, site_sharding)
from libpll2_tpu_torch.utils import output

SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
FREQS = [0.3, 0.25, 0.2, 0.25]
ASC = {"lewis": (AB_LEWIS, [1, 1, 1, 1]),
       "felsenstein": (AB_FELSENSTEIN, [2, 1, 1, 3]),
       "stamatakis": (AB_STAMATAKIS, [2, 1, 1, 3])}
# 126 sites + 4 phantom columns, padded to 256 over 2 ranks of 128: the
# phantoms 126-129 straddle the boundary
ASC_SITES = 126
ME = __name__


# ----------------------------------------------------------------------
# rank side (runs in the launched processes; no JAX)
# ----------------------------------------------------------------------

def _engine_inputs(mesh, case):
    cfg = PartitionConfig(**case["cfg"], dtype=torch.float64)
    tree = T.parse_newick_string(case["newick"])
    model = convert.model_from_jax(case["model"], device=mesh.device)
    site = distributed.shard_engine_inputs(mesh, case["tipchars"],
                                           case["pw"], case["inv"])
    return cfg, tree, model, site


def _rank_engine(mesh, case, spr=None, asc=None):
    """logL, all-branch (d1, d2) and the training step on this rank's
    slice; the SPR round and the asc-bias cases where given."""
    g = mesh.group
    cfg, tree, model, site = _engine_inputs(mesh, case)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    bl = torch.as_tensor(program.default_branch_lengths)
    sl = distributed.process_site_slice(cfg.sites_padded, mesh)
    probe = output.hardware_probe()
    out = {"slice": (sl.start, sl.stop), "width": site[0].shape[-1],
           "probe": (probe["process_count"], probe["rank"]),
           "logl": engine.loglikelihood(program, cfg, model, bl, *site,
                                        group=g)}
    if spr is None:
        return out
    out["d1"], out["d2"] = engine.branch_derivatives(
        full, cfg, model, torch.as_tensor(full.default_branch_lengths),
        *site, group=g)
    out["root_bl"], out["root_logl"] = engine.optimize_root_branch(
        program, cfg, model, bl, *site, group=g)
    out["spr"] = _spr_round(mesh, spr, use_kernel=False)
    try:
        _spr_round(mesh, spr, use_kernel=True)
        out["kernel_refused"] = False
    except ValueError:
        out["kernel_refused"] = True
    for mode, c in asc.items():
        cfg, tree, model, site = _engine_inputs(mesh, c)
        full = engine.compile_tree_full(tree, cfg)
        bl = torch.as_tensor(full.default_branch_lengths)
        out[f"asc_{mode}"] = (
            engine.loglikelihood(engine.compile_tree(tree, cfg), cfg, model,
                                 bl, *site, group=g),
            *engine.branch_derivatives(full, cfg, model, bl, *site, group=g))
    return out


def _spr_round(mesh, spr, use_kernel):
    cfg = PartitionConfig(**spr["cfg"], dtype=torch.float64)
    start = T.parse_newick_string(spr["newick"])
    for n in start.nodes[:cfg.tips]:
        n.label = spr["rename"][n.label]
    model = convert.model_from_jax(spr["model"], device=mesh.device)
    prog = sf.compile_spr(start, cfg, radius=3)
    site = shard_site_arrays(mesh, sf._tipchars_for(prog, spr["chars"],
                                                    "cpu"),
                             *sf._aux_arrays(prog, "cpu"))
    lops, pslots, bl, rows, slot, gdev = sf._round_args(prog, mesh.device)
    logl, outs = sf._spr_round_device(
        prog.cfg_ext, model, lops, pslots, bl, *site, rows, slot, gdev,
        ball_slots=prog.ball_slots, newton_iters=2, use_kernel=use_kernel,
        group=mesh.group)
    return logl, [s for s, _ in outs]


def _rank_fails(mesh):
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


# ----------------------------------------------------------------------
# inputs and JAX references (pytest process)
# ----------------------------------------------------------------------

def _engine_case(n_tips, sites, seed, asc=None):
    """tests/test_distributed.py's problem (or tests/test_asc_engine.py's
    asc form), its numpy inputs and its JAX values, unsharded, f64."""
    import jax.numpy as jnp

    import libpll2_tpu as pll
    from libpll2_tpu import engine as jengine
    from libpll2_tpu import tree as jtree
    from libpll2_tpu.config import PartitionConfig as JConfig

    from .test_parity_tree import random_newick, random_seqs

    rng = np.random.default_rng(seed)
    newick = random_newick(n_tips, rng)
    seqs = random_seqs(n_tips, sites, rng)
    tree = jtree.parse_newick_string(newick)
    common = dict(tips=n_tips, clv_buffers=tree.inner_count, states=4,
                  sites=sites, rate_matrices=1, prob_matrices=2 * n_tips - 3,
                  rate_cats=4, scale_buffers=tree.inner_count)
    if asc is not None:
        common.update(asc_bias=ASC[asc][0], asc_bias_flag=True)
    jcfg = JConfig(**common, dtype=jnp.float64)
    model = jengine.make_model([SUBST], [FREQS],
                               pll.compute_gamma_cats(0.8, 4),
                               dtype=jnp.float64)
    raw = np.zeros((n_tips, sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    tipchars = jengine.pad_tipchars(raw, jcfg)
    pw = np.zeros(jcfg.sites_padded)
    pw[:sites] = 1.0
    if asc is not None:
        pw[sites:sites + 4] = ASC[asc][1]
    inv = np.full(jcfg.sites_padded, -1, np.int32)
    program = jengine.compile_tree(tree, jcfg)
    full = jengine.compile_tree_full(tree, jcfg)
    j = (jnp.asarray(tipchars), jnp.asarray(pw), jnp.asarray(inv))
    bl = jnp.asarray(program.default_branch_lengths, jnp.float64)
    want = {"logl": float(jengine.loglikelihood(program, jcfg, model, bl,
                                                *j))}
    d1, d2 = jengine.branch_derivatives(
        full, jcfg, model,
        jnp.asarray(full.default_branch_lengths, jnp.float64), *j)
    want["d1"], want["d2"] = np.asarray(d1), np.asarray(d2)
    root_bl, root_logl = jengine.optimize_root_branch(program, jcfg, model,
                                                      bl, *j)
    want["root_bl"], want["root_logl"] = (np.asarray(root_bl),
                                          float(root_logl))
    case = {"cfg": common, "newick": newick, "tipchars": tipchars,
            "pw": pw, "inv": inv,
            "model": convert.model_arrays(model)}
    return case, want


def _spr_case():
    """tests/test_distributed.py::test_spr_round_site_sharded_matches_
    single_device's inputs (seed 5, 10 tips, 128 sites, radius 3) and the
    JAX round's values, unsharded."""
    import jax.numpy as jnp

    import libpll2_tpu as pll
    from libpll2_tpu import engine as jengine
    from libpll2_tpu import search_fast as jsf
    from libpll2_tpu import tree as jtree
    from libpll2_tpu.config import PartitionConfig as JConfig

    from .test_parity_tree import random_newick
    from .test_search import FREQS as SFREQS
    from .test_search import SUBST as SSUBST
    from .test_search import simulate

    rng = np.random.default_rng(5)
    rates = pll.compute_gamma_cats(0.8, 4)
    tips, sites = 10, 128
    truth = jtree.parse_newick_string(random_newick(tips, rng))
    seqs = simulate(truth, sites, rng, rates)
    chars = {lab: (1 << s.astype(np.uint64)) for lab, s in seqs.items()}
    newick = random_newick(tips, np.random.default_rng(9))
    start = jtree.parse_newick_string(newick)
    rename = dict(zip(sorted(n.label for n in start.nodes[:tips]),
                      sorted(chars)))
    for n in start.nodes[:tips]:
        n.label = rename[n.label]
    common = dict(tips=tips, clv_buffers=start.inner_count, states=4,
                  sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3,
                  rate_cats=4, scale_buffers=start.inner_count)
    cfg = JConfig(**common, dtype=jnp.float64)
    model = jengine.make_model([SSUBST], [SFREQS], rates, dtype=jnp.float64)
    prog = jsf.compile_spr(start, cfg, radius=3)
    pw, inv = jsf._aux_arrays(prog)
    pslots = jnp.asarray(prog.pmatrix_slots)
    gdev = tuple((tuple(jnp.asarray(a) for a in g.ball_levels),
                  jnp.asarray(g.score_ops), jnp.asarray(g.sub_rows),
                  jnp.asarray(g.edge_pos), jnp.asarray(g.merge_edges))
                 for g in prog.ball_groups)
    logl, outs = jsf._spr_round_device(
        prog.cfg_ext, model, jnp.asarray(prog.level_ops), pslots,
        jnp.asarray(prog.branch_lengths, jnp.float64),
        jsf._tipchars_for(prog, chars), pw, inv,
        jnp.asarray(prog.edge_rows)[prog.root_edge],
        pslots[prog.root_edge], gdev, ball_slots=prog.ball_slots,
        newton_iters=2, use_kernel=False)
    case = {"cfg": common, "newick": newick, "rename": rename,
            "chars": chars, "model": convert.model_arrays(model)}
    return case, (float(logl), [np.asarray(s) for s, _ in outs])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank world computes every 2-rank result; returns (ranks'
    results, JAX values)."""
    case, want = _engine_case(12, 2 * 2 * 128, seed=31)
    spr, want["spr"] = _spr_case()
    asc = {}
    for mode in ASC:
        asc[mode], w = _engine_case(12, ASC_SITES, seed=7, asc=mode)
        want[f"asc_{mode}"] = (w["logl"], w["d1"], w["d2"])
    got = launcher.launch(f"{ME}:_rank_engine", 2,
                          {"case": case, "spr": spr, "asc": asc},
                          device="cpu",
                          workdir=tmp_path_factory.mktemp("two_ranks"))
    return got, want


def _same_on_every_rank(results):
    def walk(a, b, path):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"{path} differs across ranks"
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
    for key, value in results[0].items():
        if key not in ("slice", "probe"):
            for other in results[1:]:
                walk(value, other[key], key)


# ----------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------

def test_initialize_alone_and_the_one_rank_mesh():
    """initialize() without a coordinator or a launcher's environment is
    a no-op returning 1; the mesh of one process shards nothing
    (tests/test_distributed.py::test_global_mesh_and_placement)."""
    assert distributed.initialize() == 1
    assert not dist.is_initialized()
    mesh = distributed.global_site_mesh(["cpu"])
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert site_sharding(mesh, 2).spec == (None, "sites")
    assert replicated(mesh).spec == ()
    arr = np.arange(8 * 128 * 2, dtype=np.float32).reshape(2, 8 * 128)
    g = distributed.make_global_site_array(mesh, arr)
    np.testing.assert_array_equal(g.numpy(), arr)
    sl = distributed.process_site_slice(8 * 128, mesh)
    assert (sl.start, sl.stop) == (0, 8 * 128)
    assert pad_sites_to_mesh(128, 4) == 512
    probe = output.hardware_probe()
    assert (probe["process_count"], probe["rank"]) == (1, 0)
    with pytest.raises(ValueError):
        distributed.initialize(coordinator_address="localhost:1")


def test_two_ranks_bit_equal_and_match_jax(two_ranks):
    """tests/test_distributed.py::test_real_multiprocess_bit_equality:
    logL and all-branch (d1, d2) bit-identical across the ranks, the
    slices tile the sites, the values those of the unsharded JAX path."""
    got, want = two_ranks
    _same_on_every_rank(got)
    assert [r["slice"] for r in got] == [(0, 256), (256, 512)]
    assert [r["width"] for r in got] == [256, 256]
    assert [r["probe"] for r in got] == [(2, 0), (2, 1)]
    np.testing.assert_allclose(float(got[0]["logl"]), want["logl"],
                               rtol=1e-12)
    np.testing.assert_allclose(got[0]["d1"].numpy(), want["d1"], rtol=1e-9)
    np.testing.assert_allclose(got[0]["d2"].numpy(), want["d2"], rtol=1e-9)


def test_two_ranks_training_step(two_ranks):
    """optimize_root_branch sharded over 2 ranks: the JAX unsharded
    lengths and logL."""
    got, want = two_ranks
    np.testing.assert_allclose(got[0]["root_bl"].numpy(), want["root_bl"],
                               rtol=1e-10)
    np.testing.assert_allclose(float(got[0]["root_logl"]),
                               want["root_logl"], rtol=1e-12)


def test_two_ranks_spr_round(two_ranks):
    """_spr_round_device on 2 site slices against the JAX round:
    logL 1e-12, scores 1e-10 where finite, the same finite mask."""
    got, want = two_ranks
    logl, scores = got[0]["spr"]
    want_logl, want_scores = want["spr"]
    np.testing.assert_allclose(float(logl), want_logl, rtol=1e-12)
    assert len(scores) == len(want_scores)
    for a, b in zip(scores, want_scores):
        a = a.numpy()
        m = np.isfinite(b)
        assert (np.isfinite(a) == m).all()
        np.testing.assert_allclose(a[m], b[m], rtol=1e-10)


def test_two_ranks_refuse_the_edge_kernel(two_ranks):
    """use_kernel=True under a process group raises on every rank."""
    got, _ = two_ranks
    assert all(r["kernel_refused"] for r in got)


@pytest.mark.parametrize("mode", sorted(ASC))
def test_two_ranks_asc_bias_across_the_boundary(two_ranks, mode):
    """Asc bias with its phantom columns split 2 + 2 between the ranks:
    logL and all-branch (d1, d2) of the unsharded JAX path."""
    got, want = two_ranks
    logl, d1, d2 = got[0][f"asc_{mode}"]
    want_logl, want_d1, want_d2 = want[f"asc_{mode}"]
    np.testing.assert_allclose(float(logl), want_logl, rtol=1e-10)
    np.testing.assert_allclose(d1.numpy(), want_d1, rtol=1e-10)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-10)
    assert [r["width"] for r in got] == [256, 256]


def test_four_ranks_logl(tmp_path):
    """tests/test_distributed.py::test_sharded_engine_logl_identical on 4
    gloo ranks: seed 31, 12 tips, 4 x 128 sites, one block a rank."""
    case, want = _engine_case(12, 4 * 128, seed=31)
    got = launcher.launch(f"{ME}:_rank_engine", 4, {"case": case},
                          device="cpu", workdir=tmp_path)
    _same_on_every_rank(got)
    assert [r["slice"] for r in got] == [(0, 128), (128, 256), (256, 384),
                                         (384, 512)]
    np.testing.assert_allclose(float(got[0]["logl"]), want["logl"],
                               rtol=1e-12)


def test_launch_kills_the_others_when_a_rank_fails(tmp_path):
    """A failing rank ends the launch at once: the rank waiting for it is
    killed, and the error holds the failing rank's traceback."""
    import time
    t0 = time.monotonic()
    with pytest.raises(launcher.RankError, match="fails on purpose"):
        launcher.launch(f"{ME}:_rank_fails", 2, device="cpu",
                        workdir=tmp_path)
    assert time.monotonic() - t0 < distributed.GROUP_TIMEOUT_S


def test_dryrun_multichip_on_cpu_ranks():
    """engine.dryrun_multichip(2, device="cpu"): finite and equal on both
    ranks."""
    results = engine.dryrun_multichip(2, device="cpu")
    assert len(results) == 2
    assert results[0]["spr_scores"].numel() > 0
