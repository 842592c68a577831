"""The all-edge Newton smoothing's kernel path (ops/newton_edges.py,
csrc/newton_edges.cu, engine.newton_choice).

On the CPU: the kernel's plain version against the all-edge body's plain
path (engine._newton_plain) class by class and through a whole smoothing
call, at f32 on the random24 and five-colour cases, and through a whole
smoothing call against the JAX package's at f64 and f32; its NaN
semantics on a planted sumtable; its striped sums; the choice between
kernel and plain path (`engine.newton_choice`), its counters and span; the
host side of a launch (plan, shared-memory bytes, input checks).  The JAX
package runs only on the CPU, so the kernel meets it through the plain
version: kernel against plain on the card, plain against JAX here.

On the card (marked `cuda`, skipped without one): the kernel against the
plain version at 4, 5 and 20 states, at site counts at which `plan` picks
each cluster size, the
smoothing on the kernel against the plain path, a far start, the planted
NaN case and the launches it refuses.  On a GPU machine:

    python -m pytest tests/test_torch_newton_edges.py -m cuda
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from libpll2_tpu_torch import engine, spans
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.constants import AB_LEWIS
from libpll2_tpu_torch.ops import edge_score
from libpll2_tpu_torch.ops import message_sweep as ms
from libpll2_tpu_torch.ops import newton_edges as ne
from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
KW = dict(newton_iters=10, min_branch=1e-8, max_branch=100.0)


def f32_case(newick, sites=200, seed=4, bl_scale=1.0, **kw):
    """(full program, cfg, model, bl, tipchars, weights, invariant) of the
    port at f32 on the CPU (test_torch_engine's inputs, which it makes
    beside the JAX package's: imported here, so that the card's tests
    collect without it)."""
    from .test_torch_engine import both
    _, (_, cfg, model, bl, tipchars, pw, inv) = both(
        newick, sites, seed, "f32", bl_scale=bl_scale, **kw)
    full = engine.compile_tree_full(T.parse_newick_string(newick), cfg)
    return full, cfg, model, bl, tipchars, pw, inv


NEWICKS = {"random24": lambda: random_newick(24, np.random.default_rng(1)),
           "balanced24": lambda: balanced_newick(24)}


def class_inputs(case, bl_scale=1.0):
    """(parts, sweeps, edge rows, the colour classes, bl, model constants,
    weights) of one f32 case, the sweeps at bl."""
    full, cfg, model, bl, tipchars, pw, inv = f32_case(NEWICKS[case](),
                                                       bl_scale=bl_scale)
    parts = engine._parts((full,), (cfg,), (model,), (tipchars,), (pw,),
                          (inv,), None)
    sweeps = engine._sweeps(parts, bl)
    return (parts, sweeps, full.edge_rows_tensor(CPU),
            full.color_members(CPU), bl,
            edge_score.model_constants(model, cfg), pw.float())


@pytest.mark.parametrize("bl_scale", [1.0, 30.0])
@pytest.mark.parametrize("case", list(NEWICKS))
def test_reference_matches_the_plain_path_class_by_class(case, bl_scale):
    """Each colour class from the same sweep, from the case's lengths and
    from 30 times them: the lengths to f32 rounding and the same keep
    decisions (an edge given back its start) on both.  (Neither start
    makes an end's logL non-finite at this size: the planted case below
    exercises the keep.)"""
    parts, sweeps, rows, classes, bl, consts, pw = class_inputs(case,
                                                                bl_scale)
    if case == "balanced24":
        assert len(classes) == 5
    for members in classes:
        want = engine._newton_plain(parts, sweeps, rows, members, bl,
                                    KW["newton_iters"], KW["min_branch"],
                                    KW["max_branch"])[members]
        got = ne.newton_edges_reference(sweeps[0][0], rows, members,
                                        bl.clone(), *consts, pw,
                                        **KW)[members]
        start = bl[members]
        assert torch.equal(got == start, want == start)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)


def take_the_kernel_branch(monkeypatch):
    """Make the all-edge body take its kernel branch on the CPU, with the
    plain version in the kernel's place; returns the stand-in choice,
    which carries the counters."""
    def take_it(parts, device):
        return True
    take_it.kernel_classes = take_it.plain_classes = 0
    monkeypatch.setattr(engine, "newton_choice", take_it)
    monkeypatch.setattr(ne, "newton_edges", ne.newton_edges_reference)
    return take_it


@pytest.mark.parametrize("case", list(NEWICKS))
def test_smoothing_through_the_reference_matches_the_plain_path(
        monkeypatch, case):
    """A whole smoothing call with the body's kernel branch taken on the
    CPU, the plain version in the kernel's place, against the plain path:
    lengths to f32 rounding, logL to 1e-6."""
    full, cfg, model, bl, tipchars, pw, inv = f32_case(NEWICKS[case]())
    args = (full, cfg, model, bl, tipchars, pw, inv)
    want_bl, want = engine.optimize_branch_lengths(*args, rounds=2)

    take_it = take_the_kernel_branch(monkeypatch)
    got_bl, got = engine.optimize_branch_lengths(*args, rounds=2)
    assert take_it.kernel_classes == 2 * full.n_colors
    assert take_it.plain_classes == 0
    assert got_bl.dtype == bl.dtype and not torch.equal(got_bl, bl)
    torch.testing.assert_close(got_bl, want_bl, rtol=1e-3, atol=1e-6)
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(NEWICKS))
def test_smoothing_through_the_reference_matches_the_jax_package(
        monkeypatch, case, dt):
    """A whole smoothing call through the body's kernel branch, the plain
    version in the kernel's place, against
    libpll2_tpu.engine.optimize_branch_lengths on the same inputs: at f64
    to rtol 1e-9 (test_torch_full's budget); at f32, from the case's own
    lengths, where the keep does not fire, lengths and logL to f32
    rounding."""
    from libpll2_tpu import engine as jengine
    from libpll2_tpu import tree as jtree

    from .test_torch_engine import both
    newick = NEWICKS[case]()
    jargs, pargs = both(newick, 200, 4, dt)
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jargs[1])
    pfull = engine.compile_tree_full(T.parse_newick_string(newick), pargs[1])
    kw = dict(rounds=2, **KW)
    take_it = take_the_kernel_branch(monkeypatch)
    bl, logl = engine.optimize_branch_lengths(pfull, *pargs[1:], **kw)
    jbl, jlogl = jengine.optimize_branch_lengths(jfull, *jargs[1:], **kw)
    assert take_it.kernel_classes == 2 * pfull.n_colors
    assert bl.dtype == pargs[3].dtype and (bl != pargs[3]).all()
    jbl = np.asarray(jbl)
    assert np.isfinite(jbl).all()
    if dt == "f64":
        np.testing.assert_allclose(bl.numpy(), jbl, rtol=1e-9)
        np.testing.assert_allclose(logl.item(), float(jlogl), rtol=1e-9)
    else:
        # (gaps here: lengths 3.6e-6 relative, logL 1.5e-7)
        np.testing.assert_allclose(bl.numpy(), jbl, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(logl.item(), float(jlogl), rtol=1e-6)


def planted(R=4, S=4, T=64, device=CPU):
    """Inputs whose sumtable is planted: ML = EV = I, row 0 the sumtable,
    row 1 ones; per rate, L(t) = 1 - exp(-1e6 t), so that at t = 0 the
    sites' L is exactly 0 with L' > 0 and L'' < 0: d1 = -inf, d2 = +inf and
    the first step t - d1/d2 is NaN."""
    clv = torch.zeros((2, R, S, T), device=device)
    clv[0, :, 0], clv[0, :, 1] = 1.0, -1.0
    clv[1] = 1.0
    eye = torch.eye(R * S, device=device)
    x = torch.zeros((R, S), device=device)
    x[:, 1] = -1e6
    xw = torch.stack([x.reshape(-1), torch.ones(R * S, device=device)], 1)
    rows = torch.tensor([[0, 0, 1, 0], [0, 0, 1, 0]], device=device)
    return clv, rows, eye, eye.clone(), xw.contiguous(), \
        torch.ones(T, device=device)


def test_a_nan_step_stays_nan_and_the_keep_restores_the_start():
    """The planted edge's first step is NaN: through torch.clamp it stays
    NaN (fminf/fmaxf would clip it to min_branch, whence the steps go on to
    a finite logL), and the keep gives the edge its start back; the other
    edge, from 0.5, smooths to the clip above."""
    clv, rows, lbd, rbd, xw, pw = planted()
    bl = torch.tensor([0.0, 0.5])
    members = torch.tensor([0, 1])
    got = ne.newton_edges_reference(clv, rows, members, bl.clone(), lbd,
                                    rbd, xw, pw, **KW)
    assert got.tolist() == [0.0, 100.0]
    # a clamp that drops the NaN ends at a finite length instead
    one = ne.newton_edges_reference(clv, rows, members[:1],
                                    torch.tensor([1e-8, 0.5]), lbd, rbd, xw,
                                    pw, **KW)
    assert 0.0 < one[0].item() <= 100.0


@pytest.mark.parametrize("stripes", [1, 2, 4, 8])
def test_reference_striped(stripes):
    """Summing per stripe of ceil(T / k) sites and adding the stripes in
    order, as the kernel's cluster does, moves a length by f32 rounding
    only; stripes=1 is the default's order."""
    _, sweeps, rows, classes, bl, consts, pw = class_inputs("random24")
    members = classes[0]
    base = ne.newton_edges_reference(sweeps[0][0], rows, members, bl.clone(),
                                     *consts, pw, **KW)
    got = ne.newton_edges_reference(sweeps[0][0], rows, members, bl.clone(),
                                    *consts, pw, stripes=stripes, **KW)
    torch.testing.assert_close(got, base, rtol=1e-4, atol=1e-7)
    if stripes == 1:
        assert torch.equal(got, base)
    with pytest.raises(ValueError, match="stripes"):
        ne.newton_edges_reference(sweeps[0][0], rows, members, bl.clone(),
                                  *consts, pw, stripes=0, **KW)


def test_wrapper_refuses_cpu_tensors_and_the_reference_checks_inputs():
    """newton_edges launches only on CUDA tensors and raises on CPU ones;
    the plain version updates bl in place at the members only, takes f32
    and f64 alike, and refuses bad indices, mixed dtypes and shapes."""
    _, sweeps, rows, classes, bl, consts, pw = class_inputs("random24")
    clv, members = sweeps[0][0], classes[1]
    with pytest.raises(ValueError, match="one CUDA device"):
        ne.newton_edges(clv, rows, members, bl.clone(), *consts, pw, **KW)
    work = bl.clone()
    got = ne.newton_edges_reference(clv, rows, members, work, *consts, pw,
                                    **KW)
    assert got is work and not torch.equal(got[members], bl[members])
    others = torch.ones(len(bl), dtype=torch.bool)
    others[members] = False
    assert torch.equal(got[others], bl[others])
    wide = ne.newton_edges_reference(
        clv.double(), rows, members, bl.double(),
        *(c.double() for c in consts), pw.double(), **KW)
    assert wide.dtype == torch.float64
    torch.testing.assert_close(wide.float(), got, rtol=1e-4, atol=1e-7)
    with pytest.raises(TypeError, match="int64"):
        ne.newton_edges_reference(clv, rows.int(), members, bl.clone(),
                                  *consts, pw, **KW)
    with pytest.raises(TypeError, match="bl must be torch.float32"):
        ne.newton_edges_reference(clv, rows, members, bl.double(), *consts,
                                  pw, **KW)
    with pytest.raises(TypeError, match="f32 or f64"):
        ne.newton_edges_reference(clv.half(), rows, members, bl.clone(),
                                  *consts, pw, **KW)
    with pytest.raises(ValueError, match="pw"):
        ne.newton_edges_reference(clv, rows, members, bl.clone(), *consts,
                                  pw[:-1], **KW)


def test_plan_and_shared_memory():
    """The cluster plan follows edge_score.resident_cluster: dna_smooth's
    256 x 4,096 DNA takes clusters of 4 (68 KB a CTA, three an SM); LG at
    16,384 sites fits no cluster of 8, and unsupported says so."""
    assert ne.plan(4, 4, 4096) == 4
    assert ne.smem_bytes(4, 4, 4096, 4) == 4 * (928 + 16 * 1024)
    assert ne.smem_bytes(4, 4, 4096, 4) <= ne.SMEM_LIMIT // 3
    assert ne.plan(4, 4, 512) == 1
    assert ne.plan(4, 20, 16384) is None
    assert "16384 sites" in ne.unsupported(4, 20, 16384)
    assert ne.unsupported(4, 20, 4096) is None
    assert "states" in ne.unsupported(4, 33, 64)
    for k in edge_score.CLUSTER_SIZES:
        assert ne.smem_bytes(4, 20, 2048, k) % 16 == 0
    # the scorer's plan is resident_cluster's over its own CTA bytes
    assert edge_score.plan(4, 4, 4096) == ("resident", 4)
    assert edge_score.plan(4, 20, 1 << 16) == ("reread", 0)


def choice_parts(kind):
    """One-partition parts (or two) of a small f32 case, changed by kind."""
    full, cfg, model, bl, tipchars, pw, inv = f32_case(NEWICKS["random24"]())
    part = engine._Part(full, cfg, model, None, tipchars, pw, inv, None)
    if kind == "two_partitions":
        return [part, part]
    if kind == "multiplier":
        return [part._replace(scale=torch.tensor(1.5))]
    if kind == "f64":
        return [part._replace(cfg=dataclasses.replace(
            cfg, dtype=torch.float64))]
    if kind == "asc_bias":
        return [part._replace(cfg=dataclasses.replace(cfg,
                                                      asc_bias=AB_LEWIS))]
    if kind == "per_rate":
        return [part._replace(cfg=dataclasses.replace(
            cfg, per_rate_scalers=True))]
    if kind == "invariant_site":
        inv = inv.clone()
        inv[3] = 2
        return [part._replace(invariant=inv)]
    if kind == "lg_16384":
        return [part._replace(cfg=dataclasses.replace(cfg, states=20,
                                                      sites=16384))]
    return [part]


REFUSED = {"two_partitions": "2 partitions", "multiplier": "multiplier",
           "f64": "float64", "asc_bias": "ascertainment",
           "per_rate": "per-rate", "invariant_site": "invariant-marked",
           "lg_16384": "16384 sites"}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_newton_choice_refuses_outside_the_contract(kind):
    """Outside the kernel's contract the plain path: with a UserWarning
    naming the reason under use_kernel=None, a ValueError naming it under
    True; a CPU device or use_kernel=False takes the plain path before any
    check, silently."""
    parts = choice_parts(kind)
    assert engine.newton_refusal(parts, CUDA) is not None
    assert REFUSED[kind] in engine.newton_refusal(parts, CUDA)
    with pytest.warns(UserWarning, match=REFUSED[kind]):
        assert engine.newton_choice(parts, CUDA) is False
    forced = [p._replace(cfg=dataclasses.replace(p.cfg, use_kernel=True))
              for p in parts]
    with pytest.raises(ValueError, match=REFUSED[kind]):
        engine.newton_choice(forced, CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert engine.newton_choice(forced, CPU) is False
        assert engine.newton_choice(parts, CPU) is False


def test_invariant_marks_are_read_once_a_tensor(monkeypatch):
    """newton_refusal reads whether the invariant tensor marks a site from
    the device once per tensor and in-place version, not once a call."""
    (part,) = choice_parts("accepted")
    inv = part.invariant.clone()
    reads = []
    real_any = torch.Tensor.any

    def counted_any(self, *a, **k):
        reads.append(1)
        return real_any(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "any", counted_any)
    for _ in range(3):
        assert engine.newton_refusal([part._replace(invariant=inv)],
                                     CUDA) is None
    assert len(reads) == 1
    inv[3] = 2                                  # in place: read again
    assert "invariant-marked" in engine.newton_refusal(
        [part._replace(invariant=inv)], CUDA)
    assert len(reads) == 2
    other = inv.clone()
    other[3] = -1                               # another tensor: read it
    assert engine.newton_refusal([part._replace(invariant=other)],
                                 CUDA) is None
    assert len(reads) == 3


def test_newton_choice_takes_the_contract():
    """f32, one partition, per-site scalers, no asc bias and no invariant
    site on a CUDA device: the kernel, under None and True; False, or a
    CPU device, the plain path."""
    (part,) = choice_parts("accepted")
    assert engine.newton_refusal([part], CUDA) is None
    assert engine.newton_choice([part], CUDA) is True
    on = part._replace(cfg=dataclasses.replace(part.cfg, use_kernel=True))
    off = part._replace(cfg=dataclasses.replace(part.cfg, use_kernel=False))
    assert engine.newton_choice([on], CUDA) is True
    assert engine.newton_choice([off], CUDA) is False
    assert engine.newton_choice([part], CPU) is False


def test_colour_classes_cached_on_the_host():
    """Each class's members, read from edge_colors on the host in the
    order torch.nonzero gives, cached per device with the edge rows
    (FullTreeProgram.color_members, .edge_rows_tensor)."""
    full, *_ = f32_case(NEWICKS["balanced24"]())
    classes = full.color_members(CPU)
    assert len(classes) == full.n_colors == 5
    colors = torch.as_tensor(full.edge_colors)
    for c, members in enumerate(classes):
        assert members.dtype == torch.int64
        assert torch.equal(members, torch.nonzero(colors == c).flatten())
    assert full.color_members(CPU) is classes
    assert full.edge_rows_tensor(CPU) is full.edge_rows_tensor(CPU)
    assert sorted(torch.cat(classes).tolist()) == list(range(len(colors)))


def test_counters_and_span_on_the_plain_path():
    """On CPU tensors each class is a plain class, one `libpll2.newton`
    span a class and round."""
    full, cfg, model, bl, tipchars, pw, inv = f32_case(
        random_newick(12, np.random.default_rng(5)), sites=64)
    k0 = engine.newton_choice.kernel_classes
    p0 = engine.newton_choice.plain_classes
    with spans.recording():
        n0 = sum(r.name == "libpll2.newton" for r in spans.records())
        engine.optimize_branch_lengths(full, cfg, model, bl, tipchars, pw,
                                       inv, rounds=2, newton_iters=2)
        n = sum(r.name == "libpll2.newton" for r in spans.records()) - n0
    assert engine.newton_choice.kernel_classes == k0
    assert engine.newton_choice.plain_classes == p0 + 2 * full.n_colors
    assert n == 2 * full.n_colors


# ---------------------------------------------------------------- card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CUDA


def card_inputs(device, states, sites, seed=5, bl_scale=1.0):
    """(program, rows, classes, clv, bl, constants, weights) of a 60-taxon
    message sweep at `states` on the card."""
    cfg, full, model, bl, tipchars, pmatrix = chip_smoke.message_inputs(
        random_newick(60, np.random.default_rng(1)), sites, seed, device,
        states=states, bl_scale=bl_scale)
    clv, _ = ms.sweep_messages_reference(full.level_ops_tensor(device),
                                         pmatrix, tipchars, full.cfg_ext)
    pw = torch.zeros(cfg.sites_padded, device=device)
    pw[:cfg.sites] = 1.0
    return (full, full.edge_rows_tensor(device),
            full.color_members(device), clv, bl,
            edge_score.model_constants(model, cfg), pw)


# (states, sites, the cluster plan picks there); 510 sites run the
# one-site-a-thread form
PLANS = [(4, 512, 1), (4, 2048, 2), (4, 4096, 4), (4, 8192, 8),
         (5, 512, 1), (5, 1024, 2), (5, 2048, 4), (5, 4096, 8),
         (20, 128, 1), (20, 256, 2), (20, 512, 4), (20, 1024, 8),
         (4, 510, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("states,sites,cluster", PLANS)
def test_kernel_matches_plain(cuda_device, states, sites, cluster):
    """Every class of a 60-taxon tree on the kernel, at a site count at
    which plan picks `cluster` CTAs an edge, against the plain version
    summing in the same stripes: lengths to f32 rounding, the same keep
    decisions, one launch a class."""
    limit = edge_score.smem_limit_of(cuda_device)
    assert ne.plan(4, states, sites, limit) == cluster
    full, rows, classes, clv, bl, consts, pw = card_inputs(
        cuda_device, states, sites)
    for members in classes:
        n0 = ne.newton_edges.launches
        got = ne.newton_edges(clv, rows, members, bl.clone(), *consts, pw,
                              **KW)
        assert ne.newton_edges.launches == n0 + 1
        want = ne.newton_edges_reference(clv, rows, members, bl.clone(),
                                         *consts, pw, stripes=cluster, **KW)
        start = bl[members]
        assert torch.equal(got[members] == start, want[members] == start)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_shared_memory_bytes_match_the_library(cuda_device):
    """The host's smem_bytes is the .cu's newton_edges_smem."""
    from libpll2_tpu_torch import _build
    lib = _build.library()
    for R, S, T in ((4, 4, 4096), (4, 20, 512), (1, 5, 333), (8, 32, 64)):
        for k in edge_score.CLUSTER_SIZES:
            assert lib.newton_edges_smem(R, S, T, k) == \
                ne.smem_bytes(R, S, T, k)


@pytest.mark.cuda
def test_planted_nan_on_the_kernel(cuda_device):
    """The planted NaN step stays NaN on the kernel too, and the keep
    gives the start back (fminf and fmaxf would have dropped it)."""
    limit = edge_score.smem_limit_of(cuda_device)
    bl = torch.tensor([0.0, 0.5], device=cuda_device)
    members = torch.tensor([0, 1], device=cuda_device)
    clusters = []
    for sites in (64, 2048, 4096, 8192):         # plan: 1, 2, 4, 8 CTAs
        clusters.append(ne.plan(4, 4, sites, limit))
        clv, rows, lbd, rbd, xw, pw = planted(T=sites, device=cuda_device)
        got = ne.newton_edges(clv, rows, members, bl.clone(), lbd, rbd, xw,
                              pw, **KW)
        assert got.tolist() == [0.0, 100.0]
    assert clusters == list(edge_score.CLUSTER_SIZES)


@pytest.mark.cuda
def test_smoothing_on_the_newton_kernel_matches_plain(cuda_device):
    """optimize_branch_lengths with use_kernel=None (a Newton launch a
    class, the counters advancing by 3 x n_colors kernel classes) against
    use_kernel=False (plain classes only): lengths and logL to f32
    rounding."""
    cfg, full, model, bl, tipchars, _ = chip_smoke.message_inputs(
        random_newick(90, np.random.default_rng(1)), 2048, 5, cuda_device)
    pw = torch.ones(cfg.sites_padded, device=cuda_device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=cuda_device)
    out = {}
    for use_kernel in (None, False):
        c = dataclasses.replace(cfg, use_kernel=use_kernel)
        k0 = engine.newton_choice.kernel_classes
        p0 = engine.newton_choice.plain_classes
        n0 = ne.newton_edges.launches
        new_bl, logl = engine.optimize_branch_lengths(full, c, model, bl,
                                                      tipchars, pw, inv)
        out[use_kernel] = (new_bl, logl.item(),
                           engine.newton_choice.kernel_classes - k0,
                           engine.newton_choice.plain_classes - p0,
                           ne.newton_edges.launches - n0)
    classes = 3 * full.n_colors
    assert out[None][2:] == (classes, 0, classes)
    assert out[False][2:] == (0, classes, 0)
    gap = abs(out[None][1] - out[False][1]) / abs(out[False][1])
    assert gap < chip_smoke.LOGL_RTOL
    torch.testing.assert_close(out[None][0], out[False][0], rtol=1e-3,
                               atol=1e-6)


@pytest.mark.cuda
def test_far_start_ends_finite_on_the_kernel(cuda_device):
    """From every length x 30 at f32 the kernel's smoothing ends with
    finite lengths and a finite logL (the keep at work)."""
    cfg, full, model, bl, tipchars, _ = chip_smoke.message_inputs(
        random_newick(90, np.random.default_rng(1)), 2048, 5, cuda_device,
        bl_scale=30.0)
    pw = torch.ones(cfg.sites_padded, device=cuda_device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=cuda_device)
    k0 = engine.newton_choice.kernel_classes
    new_bl, logl = engine.optimize_branch_lengths(full, cfg, model, bl,
                                                  tipchars, pw, inv)
    assert engine.newton_choice.kernel_classes == k0 + 3 * full.n_colors
    assert bool(torch.isfinite(new_bl).all())
    assert np.isfinite(logl.item())


@pytest.mark.cuda
def test_refused_cases_raise_on_the_card(cuda_device):
    """Outside the contract use_kernel=True raises and use_kernel=None
    warns and takes the plain path; the wrapper refuses f64, a shape
    whose stripe fits no cluster and inputs on two devices."""
    cfg, full, model, bl, tipchars, _ = chip_smoke.message_inputs(
        random_newick(20, np.random.default_rng(1)), 256, 5, cuda_device)
    pw = torch.ones(cfg.sites_padded, device=cuda_device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=cuda_device)
    inv[0] = 1
    forced = dataclasses.replace(cfg, use_kernel=True)
    with pytest.raises(ValueError, match="invariant-marked"):
        engine.optimize_branch_lengths(full, forced, model, bl, tipchars,
                                       pw, inv, rounds=1)
    p0 = engine.newton_choice.plain_classes
    with pytest.warns(UserWarning, match="invariant-marked"):
        engine.optimize_branch_lengths(full, cfg, model, bl, tipchars, pw,
                                       inv, rounds=1)
    assert engine.newton_choice.plain_classes == p0 + full.n_colors
    _, rows, classes, clv, bl, consts, pw = card_inputs(cuda_device, 20, 512)
    with pytest.raises(TypeError, match="computes f32"):
        ne.newton_edges(clv.double(), rows, classes[0], bl.double(),
                        *(c.double() for c in consts), pw.double(), **KW)
    wide = torch.zeros(clv.shape[:-1] + (16384,), device=cuda_device)
    with pytest.raises(ValueError, match="16384 sites"):
        ne.newton_edges(wide, rows, classes[0], bl.clone(), *consts,
                        torch.ones(16384, device=cuda_device), **KW)
    with pytest.raises(ValueError, match="one CUDA device"):
        ne.newton_edges(clv, rows, classes[0], bl.cpu(), *consts, pw, **KW)
