"""Branch-length derivatives and the training step of the port against
libpll2_tpu on the CPU, with the same numpy inputs.

Tolerances: the ops at f64 rtol 1e-10 (the same formulas in f64, summed in
another order; per-rate factors thresh^4 = 2^-1024 are subnormal, which
XLA's CPU flushes to zero and torch keeps, hence an absolute floor of
1e-300 on sumtables); optimize_root_branch at f64 rtol 1e-9 (the engine
budget of test_torch_engine) and at f32 rtol 5e-6 (bench.py's f32
budget)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import engine as jengine
from libpll2_tpu.ops import derivatives as jder
from libpll2_tpu_torch import engine
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import AB_LEWIS
from libpll2_tpu_torch.ops import derivatives, partials_tree

from .test_torch_engine import CASES as ENGINE_CASES
from .test_torch_engine import both
from .test_torch_ops import CASES, eigen_stack, j, reduction_inputs, t

RTOL = 1e-10


def model_inputs(seed, R=4, S=4):
    rng = np.random.default_rng(seed)
    evals, evecs, ivecs = eigen_stack(S, 1, rng)
    return dict(ev=np.repeat(evecs, R, 0), iv=np.repeat(ivecs, R, 0),
                el=np.repeat(evals, R, 0),
                rates=np.array([0.1, 0.5, 1.2, 2.2])[:R])


def sumtables(case):
    jcfg, pcfg, x = reduction_inputs(4, **CASES[case])
    m = model_inputs(5)
    per_rate = pcfg.per_rate_scalers
    sp, sc = (x["sp"], x["sc"]) if per_rate else (None, None)
    # the asc fold multiplies phantom columns by thresh^scalers; at 2^-256
    # per count, products of counts above 1 reach the subnormal range,
    # where XLA's CPU flushes to zero and torch does not
    asc = None if per_rate else np.minimum(x["sp"] + x["sc"], 1)

    def opt(f, v):
        return None if v is None else f(v)
    want = jder.update_sumtable(
        j(x["clvp"]), j(x["clvc"]), opt(j, sp), opt(j, sc), j(m["ev"]),
        j(m["iv"]), j(x["freqs"]), jcfg, asc_scalers=opt(j, asc))
    got = derivatives.update_sumtable(
        t(x["clvp"]), t(x["clvc"]), opt(t, sp), opt(t, sc), t(m["ev"]),
        t(m["iv"]), t(x["freqs"]), pcfg, asc_scalers=opt(t, asc))
    scal = x["sp"] + x["sc"]
    if per_rate:
        scal = scal.min(axis=0)
    return jcfg, pcfg, x, m, want, got, scal


@pytest.mark.parametrize("case", list(CASES))
def test_update_sumtable(case):
    *_, want, got, _ = sumtables(case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("bl", [0.05, 0.7])
def test_derivatives_and_sumtable_logl(case, bl):
    jcfg, pcfg, x, m, jst, pst, scal = sumtables(case)
    args = ("rates", "el")
    d_want = jder.likelihood_derivatives(
        jst, bl, *(j(m[k]) for k in args), j(x["pinv"]), j(x["rw"]),
        j(x["freqs"]), j(x["inv"]), j(x["pw"]), jcfg)
    d_got = derivatives.likelihood_derivatives(
        pst, torch.tensor(bl, dtype=torch.float64),
        *(t(m[k]) for k in args), t(x["pinv"]), t(x["rw"]), t(x["freqs"]),
        t(x["inv"]), t(x["pw"]), pcfg)
    for g, w in zip(d_got, d_want):
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)
    l_want = jder.sumtable_loglikelihood(
        jst, bl, *(j(m[k]) for k in args), j(x["pinv"]), j(x["rw"]),
        j(x["freqs"]), j(x["inv"]), j(x["pw"]), j(scal), jcfg)
    l_got = derivatives.sumtable_loglikelihood(
        pst, torch.tensor(bl, dtype=torch.float64),
        *(t(m[k]) for k in args), t(x["pinv"]), t(x["rw"]), t(x["freqs"]),
        t(x["inv"]), t(x["pw"]), t(scal), pcfg)
    np.testing.assert_allclose(l_got.item(), float(l_want), rtol=RTOL)


def test_batched_equals_single():
    """Leading batch axes (edges, slots) give the single-edge values."""
    _, pcfg, x, m, _, _, scal = sumtables("asc_lewis")
    rng = np.random.default_rng(9)
    clvp = t(x["clvp"] * rng.uniform(0.5, 2.0, (3, 1, 1, 1)))
    st = derivatives.update_sumtable(
        clvp, t(x["clvc"]), None, None, t(m["ev"]), t(m["iv"]),
        t(x["freqs"]), pcfg, asc_scalers=t(np.minimum(x["sp"] + x["sc"], 1)))
    bls = torch.tensor([0.05, 0.3, 1.1], dtype=torch.float64)
    rest = (t(m["rates"]), t(m["el"]), t(x["pinv"]), t(x["rw"]),
            t(x["freqs"]), t(x["inv"]), t(x["pw"]))
    d1, d2 = derivatives.likelihood_derivatives(st, bls, *rest, pcfg)
    logl = derivatives.sumtable_loglikelihood(st, bls, *rest[:-1],
                                              t(x["pw"]), t(scal), pcfg)
    for b in range(3):
        one = derivatives.likelihood_derivatives(st[b], bls[b], *rest, pcfg)
        np.testing.assert_allclose([d1[b].item(), d2[b].item()],
                                   [one[0].item(), one[1].item()],
                                   rtol=1e-12)
        np.testing.assert_allclose(
            logl[b].item(), derivatives.sumtable_loglikelihood(
                st[b], bls[b], *rest[:-1], t(x["pw"]), t(scal),
                pcfg).item(), rtol=1e-12)


@pytest.mark.parametrize("case", ["random24", "caterpillar30_scaled", "pinv",
                                  "per_rate_scaled", "asc_lewis"])
def test_optimize_root_branch_f64(case):
    spec = dict(ENGINE_CASES[case])
    jargs, pargs = both(spec.pop("newick")(), 384, 3, "f64", **spec)
    want_bl, want_logl = jengine.optimize_root_branch(*jargs)
    got_bl, got_logl = engine.optimize_root_branch(*pargs)
    np.testing.assert_allclose(got_logl.item(), float(want_logl), rtol=1e-9)
    np.testing.assert_allclose(got_bl.numpy(), np.asarray(want_bl),
                               rtol=1e-9)
    root = int(np.nonzero(pargs[0].pmatrix_indices
                          == pargs[0].root_pmatrix)[0][0])
    assert got_bl[root] != pargs[3][root]          # the root branch moved
    assert torch.equal(torch.cat([got_bl[:root], got_bl[root + 1:]]),
                       torch.cat([pargs[3][:root], pargs[3][root + 1:]]))


@pytest.mark.parametrize("case", ["random24", "per_rate_scaled"])
def test_optimize_root_branch_f32_tree_path(case):
    """use_kernel=True on CPU tensors: the tree-sweep path (its plain
    version), whose rows come back through the tree view."""
    spec = dict(ENGINE_CASES[case])
    jargs, pargs = both(spec.pop("newick")(), 256, 4, "f32", use_kernel=True,
                        **spec)
    before = partials_tree.sweep.launches
    got_bl, got_logl = engine.optimize_root_branch(*pargs)
    assert partials_tree.sweep.launches == before
    want_bl, want_logl = jengine.optimize_root_branch(*jargs)
    np.testing.assert_allclose(got_logl.item(), float(want_logl), rtol=5e-6)
    np.testing.assert_allclose(got_bl.numpy(), np.asarray(want_bl),
                               rtol=5e-6)


def test_config_refuses_asc_bias_with_per_rate_scalers():
    common = dict(tips=4, clv_buffers=2, states=4, sites=10, rate_matrices=1,
                  prob_matrices=5, rate_cats=4, scale_buffers=2)
    PartitionConfig(**common, per_rate_scalers=True)
    PartitionConfig(**common, asc_bias=AB_LEWIS)
    with pytest.raises(ValueError, match="per-rate"):
        PartitionConfig(**common, per_rate_scalers=True, asc_bias=AB_LEWIS)


def test_newton_update_safeguards():
    t = torch.tensor([0.1, 0.1, 0.1, 0.1, 80.0, 1e-8])
    d1 = torch.tensor([1.0, 1.0, -1.0, float("nan"), -1.0, 1.0])
    d2 = torch.tensor([10.0, -1.0, -1.0, float("nan"), -1.0, -1.0])
    got = derivatives.newton_update(t, d1, d2)
    want = [0.1 - 0.1, 0.05, 0.2, 0.2, 100.0, 1e-8]
    np.testing.assert_allclose(got.numpy(), np.clip(want, 1e-8, 100.0),
                               rtol=1e-6)
    held = derivatives.newton_update(t[:1], torch.tensor([1.0]),
                                     torch.tensor([0.0]))
    assert held.item() == pytest.approx(0.05)
    inf = derivatives.newton_update(t[:1], torch.tensor([float("inf")]),
                                    torch.tensor([1.0]))
    assert inf.item() == pytest.approx(0.1)        # non-finite step held
