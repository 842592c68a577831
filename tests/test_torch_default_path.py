"""The default config on a CUDA device (repair R13): where no tree-sweep
form takes a case (f64, more than 32 rates, a pool above the card's
shared memory), use_kernel=None runs the dense path on the device with one
UserWarning naming the reason, as the JAX package leaves such a case to
XLA; use_kernel=True still raises.  No card is needed: the decision is
made on the host (engine.kernel_choice_for, fit.dense_config) from an
H100's shared-memory limit and SM count, and the dense values are held to
the JAX package's on the CPU (f64 rtol 1e-9: the same formulas, another
summation order)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import engine as jengine
from libpll2_tpu import fit as jfit
from libpll2_tpu_torch import engine, fit
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.tree.generate import random_newick

from .test_torch_engine import both
from .test_torch_fit import fit_case

CUDA = torch.device("cuda")
H100 = dict(limit=partials_tree.SMEM_LIMIT, sm_count=132)


def decide(program, cfg):
    """(kernel_choice_for's answer on a CUDA device, its UserWarnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        choice = engine.kernel_choice_for(program, cfg, CUDA, **H100)
    return choice, [str(w.message) for w in caught
                    if issubclass(w.category, UserWarning)]


def f32_case(rates=4, n=10, sites=256):
    _, (prog, cfg, *_rest) = both(
        random_newick(n, np.random.default_rng(rates)), sites, 3, "f32")
    return prog, dataclasses.replace(cfg, rate_cats=rates)


@pytest.mark.parametrize("case", ["f64", "33 rates", "oversized pool",
                                  "forced mma"])
def test_no_form_runs_dense_under_none_and_raises_under_true(case):
    """f64, 33 rates, a pool above the limit and a forced form that cannot
    take the case: None on a CUDA device with one warning naming the
    reason; use_kernel=True raises with the same reason."""
    prog, cfg = f32_case()
    limit = H100["limit"]
    want = "f32 or bf16"
    if case == "f64":
        cfg = dataclasses.replace(cfg, dtype=torch.float64)
    elif case == "33 rates":
        prog, cfg = f32_case(rates=33)
        want = "at most 32 rates"
    elif case == "oversized pool":
        H100["limit"] = 1024
        want = "bytes of shared memory"
    else:
        cfg = dataclasses.replace(cfg, sweep_mode="mma", per_rate_scalers=True)
        want = "per-site scalers only"
    try:
        assert cfg.use_kernel is None
        choice, msgs = decide(prog, cfg)
        assert choice is None
        assert len(msgs) == 1 and want in msgs[0] and "dense path" in msgs[0]
        with pytest.raises(ValueError, match=want):
            engine.kernel_choice_for(
                prog, dataclasses.replace(cfg, use_kernel=True), CUDA,
                **H100)
        # the dense path asked for: no decision to warn about
        off, msgs = decide(prog, dataclasses.replace(cfg, use_kernel=False))
        assert off is None and msgs == []
    finally:
        H100["limit"] = limit


def test_a_case_the_kernel_takes_gets_its_form_without_a_warning():
    prog, cfg = f32_case()
    choice, msgs = decide(prog, cfg)
    assert choice == partials_tree.choose(prog.vmem_prog, cfg, **{
        "smem_limit": H100["limit"], "sm_count": H100["sm_count"]})
    assert choice[1] == "fma" and msgs == []
    # on the CPU the default is the dense path, with no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert engine.kernel_choice(prog, cfg, torch.device("cpu")) is None


def test_default_f64_loglikelihood_as_the_card_decides(monkeypatch):
    """engine.loglikelihood and optimize_root_branch under the default f64
    config, with the gate deciding as on a card: the dense path, one
    warning each, and the JAX package's values."""
    jargs, pargs = both(random_newick(12, np.random.default_rng(5)), 300, 5,
                        "f64")
    prog, cfg = pargs[:2]
    monkeypatch.setattr(engine, "kernel_choice", lambda p, c, d: engine.
                        kernel_choice_for(p, c, CUDA, **H100))
    with pytest.warns(UserWarning, match="f32 or bf16") as caught:
        got = engine.loglikelihood(*pargs)
    assert len(caught) == 1
    want = float(jengine.loglikelihood(*jargs))
    np.testing.assert_allclose(got.item(), want, rtol=1e-9)
    with pytest.warns(UserWarning, match="dense path") as caught:
        bl, logl = engine.optimize_root_branch(*pargs)
    assert len(caught) == 1
    jbl, jlogl = jengine.optimize_root_branch(*jargs)
    np.testing.assert_allclose(logl.item(), float(jlogl), rtol=1e-9)
    np.testing.assert_allclose(bl.numpy(), np.asarray(jbl), rtol=1e-9)
    monkeypatch.undo()
    assert engine.loglikelihood(*pargs).item() == got.item()


def test_fit_without_a_full_program_on_a_card_takes_the_dense_path():
    """fit.dense_config: None on a CUDA device becomes use_kernel=False
    with one warning (the JAX package's _xla_cfg); False stays; None on
    the CPU stays without one; True raises."""
    _, (prog, cfg, params, rates, *site), _, _ = fit_case()
    with pytest.warns(UserWarning, match="autograd") as caught:
        dense = fit.dense_config(cfg, CUDA)
    assert len(caught) == 1 and dense.use_kernel is False
    assert dense == dataclasses.replace(cfg, use_kernel=False)
    off = dataclasses.replace(cfg, use_kernel=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fit.dense_config(off, CUDA) is off
        assert fit.dense_config(cfg, torch.device("cpu")) is cfg
    with pytest.raises(ValueError, match="full_program"):
        fit.dense_config(dataclasses.replace(cfg, use_kernel=True), CUDA)


def test_fit_value_and_gradient_on_the_dense_path_match_jax(monkeypatch):
    """fit.loglikelihood_fn under the default f64 config with the decision
    of a card: the dense value and its autograd gradient (substitution
    rates, frequencies, branches), against the JAX package's
    loglikelihood_fn (which forces XLA there), rtol 1e-9 and 1e-7."""
    (jprog, jcfg, jparams, jrates, *jsite), \
        (prog, cfg, params, rates, *site), _, _ = fit_case()
    real = fit.dense_config
    monkeypatch.setattr(fit, "dense_config", lambda c, d: real(c, CUDA))
    leaves = [x.detach().clone().requires_grad_() for x in params]
    with pytest.warns(UserWarning, match="autograd"):
        got = fit.loglikelihood_fn(prog, cfg, fit.FitParams(*leaves), rates,
                                   *site)
    got.backward()
    want, jgrad = jax.value_and_grad(
        lambda p: jfit.loglikelihood_fn(jprog, jcfg, p, jnp.asarray(jrates),
                                        *jsite))(jparams)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-9)
    for name, leaf in zip(fit.FitParams._fields[:3], leaves):
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   np.asarray(getattr(jgrad, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
