"""Plain-torch ops of the port against libpll2_tpu's XLA versions, both at
f64 on the CPU with the same numpy inputs.  Both sides run the same
formulas in f64, so they agree to rounding: rtol 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE,
                                   AB_STAMATAKIS)
from libpll2_tpu.ops import likelihood as jlik
from libpll2_tpu.ops import pmatrix as jpmatrix
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.models import ratematrix
from libpll2_tpu_torch.ops import likelihood, pmatrix

RTOL = 1e-10


def t(x):
    return torch.as_tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def eigen_stack(states, m, rng):
    out = [ratematrix.update_eigen(
        rng.uniform(0.2, 3.0, states * (states - 1) // 2),
        rng.dirichlet(np.full(states, 4.0))) for _ in range(m)]
    return [np.stack([o[k] for o in out]) for k in range(3)]


@pytest.mark.parametrize("states", [4, 20])
def test_compute_pmatrices(states):
    rng = np.random.default_rng(states)
    evals, evecs, ivecs = eigen_stack(states, 2, rng)
    rates = np.array([0.1, 0.5, 1.2, 2.2])
    pinv = np.array([0.1, 0.3])
    pidx = np.array([0, 1, 0, 1], np.int32)
    bl = np.concatenate([rng.uniform(1e-6, 2.0, 9), [0.0, -1.0]])
    want = jpmatrix.compute_pmatrices(j(bl), j(evals), j(evecs), j(ivecs),
                                      j(rates), j(pinv), j(pidx),
                                      dtype=jnp.float64)
    got = pmatrix.compute_pmatrices(t(bl), t(evals), t(evecs), t(ivecs),
                                    t(rates), t(pinv), t(pidx),
                                    dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)
    np.testing.assert_array_equal(got[-2:].numpy(),
                                  np.broadcast_to(np.eye(states),
                                                  (2, 4, states, states)))


CASES = {
    "plain": dict(),
    "pinv": dict(pinv=True),
    "per_rate": dict(per_rate=True),
    "per_rate_pinv": dict(per_rate=True, pinv=True),
    "asc_lewis": dict(asc=AB_LEWIS),
    "asc_felsenstein": dict(asc=AB_FELSENSTEIN),
    "asc_stamatakis": dict(asc=AB_STAMATAKIS),
}


def reduction_inputs(seed, pinv=False, per_rate=False, asc=AB_NONE):
    """Random CLVs, scalers, sites and weights shared by both packages."""
    R, S, sites = 4, 4, 200
    common = dict(tips=4, clv_buffers=2, states=S, sites=sites,
                  rate_matrices=1, prob_matrices=5, rate_cats=R,
                  scale_buffers=2, per_rate_scalers=per_rate, asc_bias=asc,
                  site_block=64)
    jcfg = JConfig(**common, dtype=jnp.float64)
    pcfg = PartitionConfig(**common, dtype=torch.float64)
    T = pcfg.sites_padded
    rng = np.random.default_rng(seed)
    sshape = (R, T) if per_rate else (T,)
    x = dict(
        clvp=rng.uniform(0.0, 1.0, (R, S, T)) * 1e-3,
        clvc=rng.uniform(0.0, 1.0, (R, S, T)),
        sp=rng.integers(0, 3, sshape).astype(np.int32),
        sc=rng.integers(0, 7, sshape).astype(np.int32),
        pmat=rng.dirichlet(np.ones(S), (R, S)),
        freqs=np.broadcast_to(rng.dirichlet(np.ones(S) * 3), (R, S)).copy(),
        rw=np.full(R, 0.25),
        pinv=np.full(R, 0.2 if pinv else 0.0),
        inv=np.where(rng.random(T) < 0.3, rng.integers(0, S, T),
                     -1).astype(np.int32),
        pw=np.where(np.arange(T) < pcfg.sites_alloc,
                    rng.integers(1, 4, T), 0).astype(np.float64),
    )
    return jcfg, pcfg, x


@pytest.mark.parametrize("case", list(CASES))
def test_root_loglikelihood(case):
    jcfg, pcfg, x = reduction_inputs(1, **CASES[case])
    args = ("clvp", "sp", "freqs", "rw", "pinv", "inv", "pw")
    want, want_site = jlik.root_loglikelihood(
        *(j(x[k]) for k in args), jcfg, with_persite=True)
    got, got_site = likelihood.root_loglikelihood(
        *(t(x[k]) for k in args), pcfg, with_persite=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_site.numpy(), np.asarray(want_site),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_edge_loglikelihood(case):
    jcfg, pcfg, x = reduction_inputs(2, **CASES[case])
    args = ("clvp", "sp", "clvc", "sc", "pmat", "freqs", "rw", "pinv",
            "inv", "pw")
    want, want_site = jlik.edge_loglikelihood(
        *(j(x[k]) for k in args), jcfg, with_persite=True)
    got, got_site = likelihood.edge_loglikelihood(
        *(t(x[k]) for k in args), pcfg, with_persite=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_site.numpy(), np.asarray(want_site),
                               rtol=RTOL, atol=1e-12)


def test_per_rate_undo_and_invariant():
    jcfg, pcfg, x = reduction_inputs(3, per_rate=True)
    sp, sc = x["sp"], x["sc"]
    want = jlik._per_rate_undo(j(sp), j(sc), jcfg, jnp.float64)
    got = likelihood._per_rate_undo(t(sp), t(sc), pcfg, torch.float64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # thresh^4 = 2^-1024 is subnormal: XLA's CPU flushes it to zero,
    # torch keeps it, hence the atol just above the subnormal range
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=1e-300)
    np.testing.assert_array_equal(
        likelihood._invariant_site_lk(t(x["freqs"]), t(x["inv"])).numpy(),
        np.asarray(jlik._invariant_site_lk(j(x["freqs"]), j(x["inv"]))))
    np.testing.assert_array_equal(likelihood._real_site_mask(pcfg),
                                  jlik._real_site_mask(jcfg))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scatter_pmatrices(dtype):
    """The buffer write of libpll2_tpu.ops.pmatrix.scatter_pmatrices: the
    same buffer out, the input buffer unchanged."""
    rng = np.random.default_rng(11)
    buf = rng.uniform(size=(9, 4, 4, 4)).astype(dtype)
    idx = np.array([7, 0, 3], np.int32)
    new = rng.uniform(size=(3, 4, 4, 4)).astype(dtype)
    want = np.asarray(jpmatrix.scatter_pmatrices(j(buf), j(idx), j(new)))
    before = t(buf).clone()
    got = pmatrix.scatter_pmatrices(t(buf), idx, t(new))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == before.dtype
    assert torch.equal(t(buf), before)
