"""Gradient model fitting of the port against libpll2_tpu on the CPU: the
differentiable model halves, the incomplete gamma's derivative in its
shape, engine.loglikelihood_analytic and fit.fit_model.

Tolerances (f64 throughout unless stated):
  * update_eigen_torch / compute_gamma_cats_torch against the JAX
    functions and the numpy halves: 1e-10 (eigenvectors up to the solver's
    sign; the AS-recipe numpy discretization itself stops at 1e-8);
  * d gammainc / d a against central differences of scipy's gammainc:
    1e-6 (the differences' own truncation), against jax.grad: 1e-6 (XLA's
    IgammaGradA series stops earlier than the port's);
  * gradients of loglikelihood_analytic on every leaf against autograd of
    the dense plain path and against jax.grad: rtol 1e-7, atol 1e-8 of the
    largest gradient entry (tests/test_analytic_vjp.py's bounds);
  * fit_model: logL within 1e-6 relative of the JAX trajectory per step,
    on both gradient routes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import fit as jfit
from libpll2_tpu import tree as jtree
from libpll2_tpu.constants import AB_FELSENSTEIN, AB_LEWIS, AB_STAMATAKIS
from libpll2_tpu.models import gamma as jgamma
from libpll2_tpu.models import ratematrix as jratematrix
from libpll2_tpu_torch import convert, engine, fit
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.models import gamma, ratematrix
from libpll2_tpu_torch.tree.generate import random_newick

from .test_torch_engine import both

SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
FREQS = [0.3, 0.25, 0.2, 0.25]


# ---- the differentiable model halves -------------------------------------


def _fix_signs(vecs_rows, ref_rows):
    """Flip each eigenvector (a row) to the reference's sign."""
    sign = np.sign(np.sum(vecs_rows * ref_rows, axis=1, keepdims=True))
    return vecs_rows * sign


@pytest.mark.parametrize("states", [4, 20])
def test_update_eigen_torch(states):
    rng = np.random.default_rng(states)
    subst = rng.uniform(0.1, 4.0, states * (states - 1) // 2)
    freqs = rng.dirichlet(np.full(states, 4.0))
    b = ratematrix.build_rate_matrix_torch(torch.as_tensor(subst),
                                           torch.as_tensor(freqs))
    np.testing.assert_allclose(
        b.numpy(), np.asarray(jratematrix.build_rate_matrix_jax(
            jnp.asarray(subst), jnp.asarray(freqs))), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(b.numpy(),
                               ratematrix.build_rate_matrix(subst, freqs),
                               rtol=1e-12, atol=1e-14)
    d, v, iv = (x.numpy() for x in ratematrix.update_eigen_torch(
        torch.as_tensor(subst), torch.as_tensor(freqs)))
    for ref in (jratematrix.update_eigen_jax(jnp.asarray(subst),
                                             jnp.asarray(freqs)),
                ratematrix.update_eigen(subst, freqs)):
        jd, jv, jiv = (np.asarray(x) for x in ref)
        np.testing.assert_allclose(d, jd, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(_fix_signs(v, jv), jv, rtol=0, atol=1e-10)
        np.testing.assert_allclose(_fix_signs(iv.T, jiv.T).T, jiv, rtol=0,
                                   atol=1e-10)


def test_update_eigen_torch_gradient_matches_jax():
    """d sum(P(0.3)) weights / d (subst, freqs): sign-free, so comparable."""
    rng = np.random.default_rng(1)
    subst, freqs = rng.uniform(0.5, 3.0, 6), rng.dirichlet(np.full(4, 5.0))
    w = rng.standard_normal((4, 4))

    def jloss(s, f):
        d, v, iv = jratematrix.update_eigen_jax(s, f)
        return jnp.sum((iv * jnp.exp(0.3 * d)[None, :]) @ v * w)

    js, jf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(subst),
                                             jnp.asarray(freqs))
    s = torch.tensor(subst, requires_grad=True)
    f = torch.tensor(freqs, requires_grad=True)
    d, v, iv = ratematrix.update_eigen_torch(s, f)
    torch.sum((iv * torch.exp(0.3 * d)[None, :]) @ v
              * torch.as_tensor(w)).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(js), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jf), rtol=1e-9,
                               atol=1e-12)


ALPHAS = [0.05, 0.3, 1.0, 4.0, 50.0]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_compute_gamma_cats_torch(alpha, mode):
    got = gamma.compute_gamma_cats_torch(alpha, 4, mode)
    want = np.asarray(jgamma.compute_gamma_cats_jax(jnp.asarray(alpha), 4,
                                                    mode))
    assert got.dtype == torch.float64 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.numpy(),
                               gamma.compute_gamma_cats(alpha, 4, mode),
                               rtol=2e-6, atol=1e-8)
    assert gamma.compute_gamma_cats_torch(alpha, 1).tolist() == [1.0]


def test_compute_gamma_cats_torch_rejects_unknown_mode():
    with pytest.raises(ValueError, match="discretization mode"):
        gamma.compute_gamma_cats_torch(1.0, 4, mode=7)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gammainc_derivative_in_a(alpha):
    """At the points the discretization evaluates it: the quartiles."""
    x = gamma.gamma_quantile_torch(alpha, torch.tensor([0.25, 0.5, 0.75]))
    xs = x.numpy()
    # torch.special.gammainc, which the Newton iteration inverts, is
    # within 1e-9 of scipy's at alpha = 50
    np.testing.assert_allclose(scipy.special.gammainc(alpha, xs),
                               [0.25, 0.5, 0.75], rtol=1e-8)
    got = gamma.gammainc_grad_a(
        torch.tensor(alpha, dtype=torch.float64), x).numpy()
    h = 1e-4 * alpha
    fd = (scipy.special.gammainc(alpha + h, xs)
          - scipy.special.gammainc(alpha - h, xs)) / (2 * h)
    np.testing.assert_allclose(got, fd, rtol=1e-6)
    want = np.array([jax.grad(jax.scipy.special.gammainc)(
        jnp.asarray(alpha), jnp.asarray(v)) for v in xs])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # through the Function, both arguments
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    xt = x.clone().requires_grad_()
    gamma.gammainc(a, xt).sum().backward()
    np.testing.assert_allclose(a.grad.item(), got.sum(), rtol=1e-12)
    pdf = np.exp((alpha - 1) * np.log(xs) - xs
                 - scipy.special.gammaln(alpha))
    np.testing.assert_allclose(xt.grad.numpy(), pdf, rtol=1e-10)
    assert float(gamma.gammainc_grad_a(
        torch.tensor(alpha, dtype=torch.float64), torch.tensor(0.0))) == 0.0


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_gamma_cats_gradient_matches_jax(alpha, mode):
    w = np.array([1.0, -2.0, 0.5, 3.0])
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    (gamma.compute_gamma_cats_torch(a, 4, mode)
     * torch.as_tensor(w)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(
        jgamma.compute_gamma_cats_jax(v, 4, mode) * w))(jnp.asarray(alpha))
    np.testing.assert_allclose(a.grad.item(), float(want), rtol=1e-7)
    h = 1e-5 * alpha
    fd = ((gamma.compute_gamma_cats_torch(alpha + h, 4, mode)
           - gamma.compute_gamma_cats_torch(alpha - h, 4, mode)).numpy()
          * w).sum() / (2 * h)
    np.testing.assert_allclose(a.grad.item(), fd, rtol=1e-5)


# ---- loglikelihood_analytic ----------------------------------------------


FLOATS = engine._LoglikelihoodAnalytic.MODEL_FLOATS


def port_grads(pargs, full, analytic):
    """(logL, {leaf: gradient}) of the port at leaves (the model's seven
    floating tensors, branch lengths, pattern weights)."""
    prog, cfg, model, bl, tipchars, pw, inv = pargs
    leaves = {f: getattr(model, f).detach().clone().requires_grad_()
              for f in FLOATS}
    leaves["bl"] = bl.detach().clone().requires_grad_()
    leaves["pw"] = pw.detach().clone().requires_grad_()
    m = engine.Model(params_indices=model.params_indices,
                     **{f: leaves[f] for f in FLOATS})
    if analytic:
        logl = engine.loglikelihood_analytic(prog, full, cfg, m,
                                             leaves["bl"], tipchars,
                                             leaves["pw"], inv)
    else:
        logl = engine.loglikelihood(prog, dataclasses.replace(
            cfg, use_kernel=False), m, leaves["bl"], tipchars, leaves["pw"],
            inv)
    logl.backward()
    return logl.item(), {k: v.grad.numpy() for k, v in leaves.items()}


def jax_grads(jargs):
    jprog, jcfg, jmodel, bl, tipchars, pw, inv = jargs
    g_model, g_bl, g_pw = jax.grad(
        lambda m, b, w: jengine.loglikelihood(jprog, jcfg, m, b, tipchars, w,
                                              inv),
        argnums=(0, 1, 2), allow_int=True)(jmodel, bl, pw)
    out = {f: np.asarray(getattr(g_model, f)) for f in FLOATS}
    out["bl"], out["pw"] = np.asarray(g_bl), np.asarray(g_pw)
    return out


def assert_grads_close(got, want, rtol=1e-7, atol_scale=1e-8):
    scale = max(float(np.abs(v).max()) for v in want.values()) + 1.0
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol_scale * scale, err_msg=name)


VJP_CASES = {
    "plain": dict(n=10, seed=3),
    "scaled": dict(n=32, seed=5, bl_scale=25.0),       # scalers fire
    "pinv": dict(n=12, seed=7, pinv=0.25),             # +I mixing
    "lewis": dict(n=20, seed=13, asc=AB_LEWIS),
    "lewis_scaled": dict(n=20, seed=13, asc=AB_LEWIS, bl_scale=25.0),
    "felsenstein_scaled": dict(n=20, seed=13, asc=AB_FELSENSTEIN,
                               bl_scale=25.0),
    "stamatakis_scaled": dict(n=20, seed=13, asc=AB_STAMATAKIS,
                              bl_scale=25.0),
    "per_rate_scaled": dict(n=20, seed=13, per_rate=True, bl_scale=25.0),
}


def vjp_case(name, dt="f64", sites=160, **kw):
    spec = dict(VJP_CASES[name])
    n, seed = spec.pop("n"), spec.pop("seed")
    newick = random_newick(n, np.random.default_rng(seed))
    jargs, pargs = both(newick, sites, seed, dt, **spec, **kw)
    full = engine.compile_tree_full(T.parse_newick_string(newick), pargs[1])
    return jargs, pargs, full, newick


@pytest.mark.parametrize("case", list(VJP_CASES))
def test_analytic_gradient_f64(case):
    jargs, pargs, full, _ = vjp_case(case)
    l_ana, g_ana = port_grads(pargs, full, analytic=True)
    l_ref, g_ref = port_grads(pargs, full, analytic=False)
    assert abs(l_ana - l_ref) <= 1e-9 * abs(l_ref)
    assert_grads_close(g_ana, g_ref)
    assert_grads_close(g_ana, jax_grads(jargs))
    if VJP_CASES[case].get("bl_scale"):
        assert float(np.abs(g_ana["bl"]).max()) > 0


def test_analytic_gradient_equals_jax_analytic():
    """The JAX package's own custom VJP gives the same numbers."""
    jargs, pargs, full, newick = vjp_case("pinv")
    jprog, jcfg, jmodel, bl, tipchars, pw, inv = jargs
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jcfg)
    g_model, g_bl, g_pw = jax.grad(
        lambda m, b, w: jengine.loglikelihood_analytic(
            jprog, jfull, jcfg, m, b, tipchars, w, inv),
        argnums=(0, 1, 2), allow_int=True)(jmodel, bl, pw)
    want = {f: np.asarray(getattr(g_model, f)) for f in FLOATS}
    want["bl"], want["pw"] = np.asarray(g_bl), np.asarray(g_pw)
    assert_grads_close(port_grads(pargs, full, analytic=True)[1], want)


def test_analytic_gradient_chunked_equals_whole(monkeypatch):
    _, pargs, full, _ = vjp_case("scaled")
    _, whole = port_grads(pargs, full, analytic=True)
    monkeypatch.setattr(engine, "EDGE_CHUNK_BYTES", 1 << 17)
    assert len(engine._edge_chunks((pargs[1],), torch.arange(61))) > 3
    _, parts = port_grads(pargs, full, analytic=True)
    assert_grads_close(parts, whole, rtol=1e-12, atol_scale=1e-14)


def test_analytic_gradient_f32_through_the_tree_sweep():
    """f32 with use_kernel=True: the forward pass takes the tree-sweep path
    (its plain version on CPU tensors); the gradient stays within f32
    rounding (2e-3 of the largest entry per leaf) of the f64 gradient."""
    _, p64, full64, _ = vjp_case("plain")
    _, p32, _, newick = vjp_case("plain", dt="f32", use_kernel=True)
    full32 = engine.compile_tree_full(T.parse_newick_string(newick), p32[1])
    l32, g32 = port_grads(p32, full32, analytic=True)
    l64, g64 = port_grads(p64, full64, analytic=True)
    assert abs(l32 - l64) <= 5e-6 * abs(l64)
    for name in g64:
        assert g32[name].dtype == np.float32
        np.testing.assert_allclose(
            g32[name], g64[name], rtol=0,
            atol=2e-3 * float(np.abs(g64[name]).max()), err_msg=name)


def test_analytic_gradient_f32_under_deep_scaling():
    """A 96-taxon tree at 40 x its lengths rescues sites six times; at f32
    the reduction's case for invariant-mixed sites then underflows where
    it is not taken, and must not leak 0 * inf into the gradient.  Within
    2e-3 of each leaf's largest f64 entry."""
    newick = random_newick(96, np.random.default_rng(5))
    grads = {}
    for dt in ("f32", "f64"):
        _, pargs = both(newick, 256, 5, dt, bl_scale=40.0)
        full = engine.compile_tree_full(T.parse_newick_string(newick),
                                        pargs[1])
        if dt == "f32":
            _, scal, _ = engine._sweep_all(full, *pargs[1:5])
            assert int(scal.max()) >= 5
        grads[dt] = port_grads(pargs, full, analytic=dt == "f32")[1]
    for name, want in grads["f64"].items():
        assert np.isfinite(grads["f32"][name]).all(), name
        np.testing.assert_allclose(
            grads["f32"][name], want, rtol=0,
            atol=2e-3 * float(np.abs(want).max()), err_msg=name)


def test_analytic_takes_no_gradient_for_integer_inputs():
    _, pargs, full, _ = vjp_case("plain")
    prog, cfg, model, bl, tipchars, pw, inv = pargs
    bl = bl.clone().requires_grad_()
    engine.loglikelihood_analytic(prog, full, cfg, model, bl, tipchars, pw,
                                  inv).backward()
    assert bl.grad is not None and model.rates.grad is None
    assert tipchars.grad is None and inv.grad is None


# ---- fit.py ---------------------------------------------------------------


def fit_case(alpha=0.8, n=8, sites=128, seed=11):
    newick = random_newick(n, np.random.default_rng(seed))
    jargs, pargs = both(newick, sites, seed, "f64")
    jprog, jcfg, _, jbl, jtip, jpw, jinv = jargs
    prog, cfg, _, bl, tip, pw, inv = pargs
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jcfg)
    full = engine.compile_tree_full(T.parse_newick_string(newick), cfg)
    jparams = jfit.pack([SUBST], [FREQS], np.asarray(jbl), alpha=alpha,
                        dtype=jnp.float64)
    params = convert.fit_params_from_jax(convert.fit_params_arrays(jparams),
                                         device="cpu")
    rates = pll.compute_gamma_cats(alpha, 4)
    return ((jprog, jcfg, jparams, jnp.asarray(rates), jtip, jpw, jinv),
            (prog, cfg, params, rates, tip, pw, inv), jfull, full)


def test_pack_and_unpack_match_jax():
    jp = jfit.pack([[1.0] * 6], [[0.25] * 4], [0.1, 0.2, 0.3], alpha=0.7,
                   dtype=jnp.float64)
    pp = fit.pack([[1.0] * 6], [[0.25] * 4], [0.1, 0.2, 0.3], alpha=0.7,
                  dtype=torch.float64, device="cpu")
    got, want = convert.fit_params_arrays(pp), convert.fit_params_arrays(jp)
    for name in convert.FIT_FIELDS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-15,
                                   err_msg=name)
    # tied rates were staggered apart
    assert len(np.unique(got["log_subst"])) == 5
    carried = convert.fit_params_from_jax(want, device="cpu")
    for a, b in zip(fit.unpack(carried), jfit.unpack(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
    with pytest.raises((AssertionError, RuntimeError)):
        fit.pack([[1.0] * 6], [[0.25] * 4], [0.1])      # default: the card


@pytest.mark.parametrize("route", ["dense", "analytic"])
def test_loglikelihood_fn_gradient_matches_jax(route):
    (jprog, jcfg, jparams, jrates, *jsite), (prog, cfg, params, rates,
                                             *site), jfull, full = fit_case()
    want_l, want_g = jax.value_and_grad(
        lambda p: jfit.loglikelihood_fn(jprog, jcfg, p, jrates, *jsite,
                                        fit_alpha=True))(jparams)
    leaves = fit.FitParams(*(x.clone().requires_grad_() for x in params))
    logl = fit.loglikelihood_fn(
        prog, cfg, leaves, rates, *site, fit_alpha=True,
        full_program=full if route == "analytic" else None)
    logl.backward()
    np.testing.assert_allclose(logl.item(), float(want_l), rtol=1e-9)
    want = convert.fit_params_arrays(want_g)
    scale = max(float(np.abs(v).max()) for v in want.values()) + 1.0
    for name, leaf in zip(convert.FIT_FIELDS, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), want[name], rtol=1e-7,
                                   atol=1e-8 * scale, err_msg=name)


@pytest.mark.parametrize("route", ["dense", "analytic"])
def test_fit_model_follows_jax(route):
    (jprog, jcfg, jparams, jrates, *jsite), (prog, cfg, params, rates,
                                             *site), jfull, full = fit_case()
    steps = 20
    want = jfit.fit_model(jprog, jcfg, jparams, jrates, *jsite, steps=steps,
                          lr=0.05, fit_alpha=True)
    got = fit.fit_model(prog, cfg, params, rates, *site, steps=steps,
                        lr=0.05, fit_alpha=True,
                        full_program=full if route == "analytic" else None)
    assert got.logl.shape == (steps,) and got.logl.dtype == torch.float64
    np.testing.assert_allclose(got.logl.numpy(), np.asarray(want.logl),
                               rtol=1e-6)
    assert got.logl[-1] > got.logl[0]
    np.testing.assert_allclose(got.grad_norm.item(), float(want.grad_norm),
                               rtol=1e-4)
    for name, a, b in zip(convert.FIT_FIELDS, got.params, want.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    # the start is left as it was
    assert all(not x.requires_grad for x in params)


def test_fit_model_without_alpha_leaves_it():
    _, (prog, cfg, params, rates, *site), _, full = fit_case()
    out = fit.fit_model(prog, cfg, params, rates, *site, steps=3, lr=0.05,
                        full_program=full)
    assert out.params.log_alpha.item() == params.log_alpha.item()
    assert out.logl[-1] > out.logl[0]
    assert fit.fit_model(prog, cfg, params, rates, *site,
                         steps=0).logl.shape == (0,)


def test_fit_without_a_full_program_never_reaches_the_kernel_quietly():
    """Without a FullTreeProgram only a dense-path call is taken: a config
    that asks for the kernel raises, use_kernel=False gives the value of
    the default on CPU tensors."""
    _, (prog, cfg, params, rates, *site), _, _ = fit_case()
    with pytest.raises(ValueError, match="full_program"):
        fit.loglikelihood_fn(prog, dataclasses.replace(cfg, use_kernel=True),
                             params, rates, *site)
    with pytest.raises(ValueError, match="full_program"):
        fit.fit_model(prog, dataclasses.replace(cfg, use_kernel=True),
                      params, rates, *site, steps=1)
    dense = fit.loglikelihood_fn(
        prog, dataclasses.replace(cfg, use_kernel=False), params, rates,
        *site)
    assert dense.item() == fit.loglikelihood_fn(prog, cfg, params, rates,
                                                *site).item()
