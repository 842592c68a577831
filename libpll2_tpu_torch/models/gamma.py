"""Discretized Gamma rate-heterogeneity categories.

Host-side (numpy/f64) implementation of the classic AS-family numerical
recipes used by the reference (libpll-2 src/gamma.c:27-292): LnGamma (AS 291),
PointNormal (AS 70), PointChi2 (AS 91), IncompleteGamma (AS 32).  The category
rates feed the on-device P-matrix kernels; the discretization itself is a tiny
scalar computation that belongs on the host.

Two modes (pll.h:203-204):
  * mean:   category rate = mean of the Gamma density over the category's
            probability quantile interval (via incomplete-gamma masses).
  * median: category rate = quantile midpoint, renormalized to mean 1.

The torch half (`gammainc`, `gamma_quantile_torch`,
`compute_gamma_cats_torch`) is the differentiable counterpart that lets the
gamma shape join gradient-based model fitting (fit.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN

ALPHA_MIN = 0.02


def _ln_gamma(alpha: float) -> float:
    """ln Γ(alpha) for alpha > 0 (Pike & Hill, AS 291)."""
    x = alpha
    f = 0.0
    if x < 7.0:
        f = 1.0
        z = alpha - 1.0
        while True:
            z += 1.0
            if z >= 7.0:
                break
            f *= z
        x = z
        f = -math.log(f)
    z = 1.0 / (x * x)
    return (f + (x - 0.5) * math.log(x) - x + 0.918938533204673
            + (((-0.000595238095238 * z + 0.000793650793651) * z
                - 0.002777777777778) * z + 0.083333333333333) / x)


def _incomplete_gamma(x: float, alpha: float, ln_gamma_alpha: float) -> float:
    """Regularized lower incomplete gamma ratio I(x, alpha) (AS 32)."""
    accurate = 1e-8
    overflow = 1e30
    if x == 0.0:
        return 0.0
    if x < 0.0 or alpha <= 0.0:
        return -1.0

    factor = math.exp(alpha * math.log(x) - x - ln_gamma_alpha)
    if not (x > 1.0 and x >= alpha):
        # series expansion
        gin = 1.0
        term = 1.0
        rn = alpha
        while True:
            rn += 1.0
            term *= x / rn
            gin += term
            if term <= accurate:
                break
        return gin * factor / alpha

    # continued fraction
    a = 1.0 - alpha
    b = a + x + 1.0
    term = 0.0
    pn = [1.0, x, x + 1.0, x * b, 0.0, 0.0]
    gin = pn[2] / pn[3]
    while True:
        a += 1.0
        b += 2.0
        term += 1.0
        an = a * term
        for i in range(2):
            pn[i + 4] = b * pn[i + 2] - an * pn[i]
        if pn[5] != 0.0:
            rn = pn[4] / pn[5]
            dif = abs(gin - rn)
            if dif <= accurate and dif <= accurate * rn:
                return 1.0 - factor * rn
            gin = rn
        pn[0:4] = pn[2:6]
        if abs(pn[4]) >= overflow:
            for i in range(4):
                pn[i] /= overflow


def _point_normal(prob: float) -> float:
    """Inverse standard-normal CDF (Odeh & Evans, AS 70)."""
    a0, a1, a2, a3 = -0.322232431088, -1.0, -0.342242088547, -0.0204231210245
    a4 = -0.453642210148e-4
    b0, b1, b2 = 0.0993484626060, 0.588581570495, 0.531103462366
    b3, b4 = 0.103537752850, 0.0038560700634
    p1 = prob if prob < 0.5 else 1.0 - prob
    if p1 < 1e-20:
        return -9999.0
    y = math.sqrt(math.log(1.0 / (p1 * p1)))
    z = y + ((((y * a4 + a3) * y + a2) * y + a1) * y + a0) / \
        ((((y * b4 + b3) * y + b2) * y + b1) * y + b0)
    return -z if prob < 0.5 else z


def _point_chi2(prob: float, v: float) -> float:
    """Inverse chi-square CDF (Best & Roberts, AS 91)."""
    e = 0.5e-6
    aa = 0.6931471805
    p = prob
    if p < 0.000002 or p > 0.999998 or v <= 0.0:
        return -1.0
    g = _ln_gamma(v / 2.0)
    xx = v / 2.0
    c = xx - 1.0

    a = q = p1 = p2 = t = x = b = 0.0
    if v < -1.24 * math.log(p):
        ch = math.pow(p * xx * math.exp(g + xx * aa), 1.0 / xx)
        if ch - e < 0.0:
            return ch
    elif v <= 0.32:
        ch = 0.4
        a = math.log(1.0 - p)
        while True:
            q = ch
            p1 = 1.0 + ch * (4.67 + ch)
            p2 = ch * (6.73 + ch * (6.66 + ch))
            t = -0.5 + (4.67 + 2.0 * ch) / p1 - \
                (6.73 + ch * (13.32 + 3.0 * ch)) / p2
            ch -= (1.0 - math.exp(a + g + 0.5 * ch + c * aa) * p2 / p1) / t
            if abs(q / ch - 1.0) - 0.01 <= 0.0:
                break
    else:
        x = _point_normal(p)
        p1 = 0.222222 / v
        ch = v * math.pow(x * math.sqrt(p1) + 1.0 - p1, 3.0)
        if ch > 2.2 * v + 6.0:
            ch = -2.0 * (math.log(1.0 - p) - c * math.log(0.5 * ch) + g)

    while True:
        q = ch
        p1 = 0.5 * ch
        t = _incomplete_gamma(p1, xx, g)
        if t < 0.0:
            return -1.0
        p2 = p - t
        t = p2 * math.exp(xx * aa + g + p1 - c * math.log(ch))
        b = t / ch
        a = 0.5 * t - b * c
        s1 = (210 + a * (140 + a * (105 + a * (84 + a * (70 + 60 * a))))) / 420
        s2 = (420 + a * (735 + a * (966 + a * (1141 + 1278 * a)))) / 2520
        s3 = (210 + a * (462 + a * (707 + 932 * a))) / 2520
        s4 = (252 + a * (672 + 1182 * a) + c * (294 + a * (889 + 1740 * a))) \
            / 5040
        s5 = (84 + 264 * a + c * (175 + 606 * a)) / 2520
        s6 = (120 + c * (346 + 127 * c)) / 5040
        ch += t * (1 + 0.5 * t * s1 - b * c *
                   (s1 - b * (s2 - b * (s3 - b * (s4 - b * (s5 - b * s6))))))
        if abs(q / ch - 1.0) <= e:
            return ch


def _point_gamma(prob: float, alpha: float, beta: float) -> float:
    return _point_chi2(prob, 2.0 * alpha) / (2.0 * beta)


def compute_gamma_cats(alpha: float, categories: int,
                       mode: int = GAMMA_RATES_MEAN) -> np.ndarray:
    """Discretize Gamma(alpha, alpha) into equal-probability category rates.

    Mirrors pll_compute_gamma_cats (gamma.c:220-292); rates are normalized to
    mean 1 across categories.
    """
    if alpha < ALPHA_MIN or categories < 1:
        raise ValueError(f"invalid alpha value ({alpha})")

    if categories == 1:
        return np.ones(1, dtype=np.float64)

    factor = float(categories)
    rates = np.empty(categories, dtype=np.float64)

    if mode == GAMMA_RATES_MEDIAN:
        middle = 1.0 / (2.0 * categories)
        for i in range(categories):
            rates[i] = _point_gamma((i * 2 + 1) * middle, alpha, alpha)
        rates *= factor / rates.sum()
    elif mode == GAMMA_RATES_MEAN:
        lnga1 = _ln_gamma(alpha + 1.0)
        probs = np.empty(categories - 1, dtype=np.float64)
        for i in range(categories - 1):
            probs[i] = _point_gamma((i + 1.0) / categories, alpha, alpha)
        for i in range(categories - 1):
            probs[i] = _incomplete_gamma(probs[i] * alpha, alpha + 1.0, lnga1)
        rates[0] = probs[0] * factor
        rates[categories - 1] = (1.0 - probs[categories - 2]) * factor
        for i in range(1, categories - 1):
            rates[i] = (probs[i] - probs[i - 1]) * factor
    else:
        raise ValueError(f"invalid gamma discretization mode ({mode})")

    return rates


# --------------------------------------------------------------------------
# Differentiable variants (torch, f64) — the autograd model-fitting path
# (fit.py), counterparts of the JAX package's gamma_quantile_jax and
# compute_gamma_cats_jax.  torch.special.gammainc has no derivative in its
# first argument, so the regularized incomplete gamma gets an
# autograd.Function of its own.
# --------------------------------------------------------------------------

_SERIES_MAX_TERMS = 20000


def gammainc_grad_a(a, x):
    """dP(a, x)/da of the regularized lower incomplete gamma, f64, from
    the series  P = x^a e^-x sum_n x^n / Gamma(a + n + 1)  differentiated
    term by term:

        dP/da = ln(x) P - x^a e^-x sum_n psi(a + n + 1) x^n / Gamma(a+n+1).

    Every term of both sums is positive, so nothing cancels inside them;
    the terms grow until n ~ x, which bounds x to a few hundred (the
    quantiles of a discretized Gamma stay far below)."""
    a, x = torch.broadcast_tensors(a.double(), x.double())
    positive = x > 0
    xs = torch.where(positive, x, torch.ones_like(x))
    log_pref = a * torch.log(xs) - xs - torch.lgamma(a + 1.0)
    term = torch.ones_like(xs)               # x^n Gamma(a+1) / Gamma(a+n+1)
    psi = torch.special.digamma(a + 1.0)
    total = term.clone()
    total_psi = term * psi
    for n in range(1, _SERIES_MAX_TERMS):
        term = term * xs / (a + n)
        psi = psi + 1.0 / (a + n)
        total = total + term
        total_psi = total_psi + term * psi
        if n % 16 == 0 and bool((n > xs).all()) and bool(
                (term * psi.abs() <= 1e-18 * total_psi.abs()).all()):
            break
    else:
        raise ValueError("gammainc_grad_a: the series did not converge "
                         f"(x up to {float(xs.max())})")
    pref = torch.exp(log_pref)
    grad = pref * (torch.log(xs) * total - total_psi)
    return torch.where(positive, grad, torch.zeros_like(grad))


def _gamma_pdf(a, x):
    """Density of Gamma(a, 1) at x: dP(a, x)/dx."""
    return torch.exp((a - 1.0) * torch.log(x) - x - torch.lgamma(a))


class _GammaInc(torch.autograd.Function):
    """P(a, x) with both derivatives: the density in x, the
    term-by-term differentiated series in a."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = (g * gammainc_grad_a(a, x)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gx = (g * _gamma_pdf(a, x)).sum_to_size(x.shape)
        return ga, gx


def gammainc(a, x):
    """Regularized lower incomplete gamma P(a, x), f64, differentiable in
    both arguments (torch.special.gammainc is in x only)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    x = torch.as_tensor(x, dtype=torch.float64, device=a.device)
    a, x = torch.broadcast_tensors(a, x)
    return _GammaInc.apply(a, x)


class _GammaQuantile(torch.autograd.Function):
    """The converged Newton iterate with the implicit derivative of
    P(a, x) = p:  dx/da = -(dP/da) / (dP/dx),  dx/dp = 1 / (dP/dx)."""

    @staticmethod
    def forward(ctx, a, p, newton_iters):
        z = math.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)
        p1 = 1.0 / (9.0 * a)
        x = a * (z * torch.sqrt(p1) + 1.0 - p1) ** 3
        x = torch.clamp(x, min=1e-10)
        for _ in range(newton_iters):
            f = torch.special.gammainc(a, x) - p
            step = f / torch.clamp(_gamma_pdf(a, x), min=1e-300)
            x_new = x - step
            # halve toward the current point when Newton overshoots below 0
            x = torch.where(x_new > 0, x_new, x * 0.5)
        ctx.save_for_backward(a, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        pdf = torch.clamp(_gamma_pdf(a, x), min=1e-300)
        ga = gp = None
        if ctx.needs_input_grad[0]:
            ga = (-g * gammainc_grad_a(a, x) / pdf).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gp = (g / pdf).sum_to_size(x.shape)
        return ga, gp, None


def gamma_quantile_torch(alpha, p, newton_iters: int = 25):
    """Quantile of Gamma(alpha, 1) at probability p, f64, differentiable
    in both.  Wilson–Hilferty initialization (the same normal-approx start
    AS 91 uses) + Newton on the regularized incomplete gamma, as the JAX
    package's gamma_quantile_jax; its unrolled Newton converges far past
    f64 rounding, so the implicit derivative taken here at the converged
    point equals its autodiff."""
    alpha = torch.as_tensor(alpha, dtype=torch.float64)
    p = torch.as_tensor(p, dtype=torch.float64, device=alpha.device)
    alpha, p = torch.broadcast_tensors(alpha, p)
    return _GammaQuantile.apply(alpha, p, newton_iters)


def compute_gamma_cats_torch(alpha, categories: int,
                             mode: int = GAMMA_RATES_MEAN):
    """Differentiable counterpart of compute_gamma_cats ([categories] f64
    on alpha's device): lets the gamma shape parameter join gradient-based
    model fitting (fit.py)."""
    C = categories
    alpha = torch.as_tensor(alpha, dtype=torch.float64)
    device = alpha.device
    if C == 1:
        return torch.ones(1, dtype=torch.float64, device=device)
    if mode == GAMMA_RATES_MEDIAN:
        ps = (2.0 * torch.arange(C, dtype=torch.float64, device=device)
              + 1.0) / (2.0 * C)
        rates = gamma_quantile_torch(alpha, ps) / alpha
        return rates * (C / torch.sum(rates))
    if mode != GAMMA_RATES_MEAN:
        raise ValueError(f"invalid gamma discretization mode ({mode})")
    ps = torch.arange(1, C, dtype=torch.float64, device=device) / C
    q = gamma_quantile_torch(alpha, ps)          # Gamma(alpha, 1) quantiles
    probs = gammainc(alpha + 1.0, q)             # category boundary masses
    probs = torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                       probs,
                       torch.ones(1, dtype=torch.float64, device=device)])
    return (probs[1:] - probs[:-1]) * C
