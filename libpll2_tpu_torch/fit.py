"""Gradient-based model fitting — autograd through the whole likelihood.

Counterpart of libpll2_tpu/fit.py.  The reference library exposes only
likelihood values and analytic branch-length derivatives; model-parameter
optimization (GTR rates, base frequencies, alpha) is left to clients,
which wrap it in derivative-free optimizers.  Here the entire pipeline —
eigendecomposition (ratematrix.update_eigen_torch), P-matrices, CLV sweep,
logL reduction — is differentiable, so d logL / d(anything) comes from one
backward pass and fitting is a standard first-order optimization.

Parametrization (all unconstrained):
  * subst params:  exp(x) for the first K-1, last pinned to 1
    (models.c:198-202 normalization makes the last rate the unit)
  * frequencies:   softmax(logits) — strictly positive, sums to 1
  * branch lengths: exp(x) — strictly positive

With a FullTreeProgram (engine.compile_tree_full) gradients come from the
analytic message-based reverse pass (engine.loglikelihood_analytic), which
lets the FORWARD pass run the CUDA tree sweep — fitting on the fast path.
Without one the fit runs on the dense plain path, which autograd
differentiates as it stands, as the JAX package forces XLA there
(`_xla_cfg`): under cfg.use_kernel None on CUDA tensors with one warning
(`dense_config`), on CPU tensors and under use_kernel=False without one.  A
config that insists on the kernel (use_kernel=True) and no FullTreeProgram
raises: the kernel has no graph for autograd.

The eigendecomposition and the gamma discretization are tiny scalar
computations: they run in f64 on the parameters' device whatever cfg.dtype
is, and their results are cast to cfg.dtype.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from . import engine
from .config import PartitionConfig
from .models import ratematrix
from .models.gamma import compute_gamma_cats_torch


class FitParams(NamedTuple):
    """Unconstrained optimization variables."""
    log_subst: torch.Tensor     # [M, K-1]
    freq_logits: torch.Tensor   # [M, S]
    log_branch: torch.Tensor    # [E]
    log_alpha: torch.Tensor     # [] gamma shape (ignored unless fit_alpha)


def pack(subst_params, frequencies, branch_lengths, alpha: float = 1.0,
         dtype=torch.float32, break_ties: float = 1e-3,
         device="cuda") -> FitParams:
    """Pack starting values into unconstrained variables on `device`.

    break_ties: symmetric starts (e.g. Jukes–Cantor: all rates equal,
    uniform frequencies) have exactly degenerate Q eigenvalues, where the
    eigh backward is singular (it divides by eigenvalue gaps) and the
    first gradient is NaN.  Tied substitution rates are therefore nudged
    apart by a deterministic relative stagger of this size (0 disables)."""
    subst = np.atleast_2d(np.array(subst_params, np.float64))
    freqs = np.atleast_2d(np.asarray(frequencies, np.float64))
    if break_ties:
        for m in range(subst.shape[0]):
            if np.unique(subst[m]).size < subst.shape[1]:
                k = subst.shape[1]
                subst[m] = subst[m] * (1.0 + break_ties
                                       * np.arange(k) / k)
    subst = subst / subst[:, -1:]

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    if isinstance(branch_lengths, torch.Tensor):
        branch_lengths = branch_lengths.detach().cpu().numpy()
    return FitParams(
        log_subst=t(np.log(subst[:, :-1])),
        freq_logits=t(np.log(freqs)),
        log_branch=t(np.log(np.asarray(branch_lengths, np.float64))),
        log_alpha=t(np.log(alpha)),
    )


def unpack(p: FitParams):
    """-> (subst_params [M,K], frequencies [M,S], branch_lengths [E])."""
    ones = torch.ones((p.log_subst.shape[0], 1), dtype=p.log_subst.dtype,
                      device=p.log_subst.device)
    subst = torch.cat([torch.exp(p.log_subst), ones], dim=1)
    freqs = torch.softmax(p.freq_logits, dim=-1)
    return subst, freqs, torch.exp(p.log_branch)


def make_model_traced(subst_params, frequencies, rates, rate_weights=None,
                      prop_invar=None, params_indices=None,
                      dtype=torch.float32) -> engine.Model:
    """Differentiable counterpart of engine.make_model: the
    eigendecomposition stays inside the graph (gradients flow to
    subst_params / frequencies), on the tensors' device."""
    device = frequencies.device
    M = frequencies.shape[0]
    R = len(rates)
    factors = [ratematrix.update_eigen_torch(subst_params[m].double(),
                                             frequencies[m].double())
               for m in range(M)]
    d, v, iv = (torch.stack(x) for x in zip(*factors))

    def t(x, dt=dtype):
        return torch.as_tensor(x, device=device).to(dt)

    if rate_weights is None:
        rate_weights = torch.full((R,), 1.0 / R)
    if prop_invar is None:
        prop_invar = torch.zeros((M,))
    if params_indices is None:
        params_indices = torch.zeros((R,), dtype=torch.int32)
    return engine.Model(
        eigenvals=d.to(dtype), eigenvecs=v.to(dtype),
        inv_eigenvecs=iv.to(dtype), frequencies=frequencies.to(dtype),
        rates=t(rates), rate_weights=t(rate_weights),
        prop_invar=t(prop_invar),
        params_indices=t(params_indices, torch.int32))


def _rates(params: FitParams, rates, cfg: PartitionConfig, fit_alpha: bool):
    if not fit_alpha:
        return torch.as_tensor(
            rates, device=params.log_alpha.device).to(cfg.dtype)
    # alpha stays on its device.  On an H100 (700 W limit) the
    # discretization with its backward pass takes 9.6 ms there against
    # 3.2 ms with alpha copied to the host (chip_smoke.py, phase_fit: a
    # few thousand tiny launches and the series' convergence syncs), of a
    # 446 ms step; the copy would stall the host on the step before it.
    alpha = torch.exp(params.log_alpha).double()
    return compute_gamma_cats_torch(alpha, len(rates)).to(cfg.dtype)


def dense_config(cfg: PartitionConfig, device: torch.device
                 ) -> PartitionConfig:
    """The config a fit without a FullTreeProgram runs at on `device`: the
    dense plain path, which autograd differentiates.  use_kernel=False
    stays; None on a CUDA device becomes False with one UserWarning (the
    JAX package's `_xla_cfg`), on the CPU stays (the dense path already);
    True raises."""
    if cfg.use_kernel is False:
        return cfg
    if cfg.use_kernel:
        raise ValueError(
            "this config takes the tree-sweep kernel, which autograd cannot "
            "differentiate: pass full_program=engine.compile_tree_full(tree, "
            "cfg) to fit on the kernel path, or a config with "
            "use_kernel=False for the dense plain path")
    if device.type == "cpu":
        return cfg
    warnings.warn(f"the dense path computes this fit's likelihood on "
                  f"{device}: without a FullTreeProgram autograd cannot "
                  f"differentiate the tree-sweep kernel (pass full_program="
                  f"engine.compile_tree_full(tree, cfg) for the kernel path)",
                  UserWarning, stacklevel=3)
    return dataclasses.replace(cfg, use_kernel=False)


def loglikelihood_fn(program, cfg: PartitionConfig, params: FitParams,
                     rates, tipchars, pattern_weights, invariant,
                     fit_alpha: bool = False, full_program=None):
    """logL as a differentiable function of FitParams.

    With a FullTreeProgram (engine.compile_tree_full), the gradient uses
    the analytic message-based reverse pass
    (engine.loglikelihood_analytic), so the forward pass may run the CUDA
    tree sweep.  Without one the likelihood runs on the dense plain path,
    which autograd walks (`dense_config`: on CUDA tensors under
    use_kernel=None with a warning; use_kernel=True raises, since the
    kernel has no graph for autograd)."""
    subst, freqs, bl = unpack(params)
    if full_program is None:
        cfg = dense_config(cfg, tipchars.device)
    model = make_model_traced(subst, freqs,
                              _rates(params, rates, cfg, fit_alpha),
                              dtype=cfg.dtype)
    bl = bl.to(cfg.dtype)
    if full_program is not None:
        return engine.loglikelihood_analytic(
            program, full_program, cfg, model, bl, tipchars,
            pattern_weights, invariant)
    return engine.loglikelihood(program, cfg, model, bl, tipchars,
                                pattern_weights, invariant)


class FitResult(NamedTuple):
    params: FitParams
    logl: torch.Tensor          # [steps] trajectory
    grad_norm: torch.Tensor     # final gradient norm


def fit_model(program, cfg: PartitionConfig, params0: FitParams, rates,
              tipchars, pattern_weights, invariant,
              steps: int = 200, lr: float = 0.05,
              fit_alpha: bool = False, full_program=None) -> FitResult:
    """Maximize logL over (GTR rates, frequencies, branch lengths, and —
    with fit_alpha — the gamma shape via the differentiable
    discretization) with Adam (torch.optim.Adam: the update of the JAX
    package's optax.adam at its defaults).

    full_program (engine.compile_tree_full): use the analytic reverse pass
    so the forward pass rides the CUDA tree sweep.  Without one the dense
    path computes every step (see loglikelihood_fn and dense_config;
    use_kernel=True raises).
    logl[i] is the logL at the parameters before step i."""
    leaves = [x.detach().clone().requires_grad_() for x in params0]
    params = FitParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=lr)

    def loss():
        return -loglikelihood_fn(program, cfg, params, rates, tipchars,
                                 pattern_weights, invariant,
                                 fit_alpha=fit_alpha,
                                 full_program=full_program)

    logls = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        value = loss()
        value.backward()
        opt.step()          # a leaf the loss does not reach stays as it is
        logls.append(-value.detach())
    grads = torch.autograd.grad(loss(), leaves, allow_unused=True)
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads if g is not None))
    device = leaves[0].device
    return FitResult(
        params=FitParams(*(x.detach() for x in leaves)),
        logl=(torch.stack(logls) if logls
              else torch.zeros(0, dtype=cfg.dtype, device=device)),
        grad_norm=gn)
