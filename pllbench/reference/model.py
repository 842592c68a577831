"""The substitution model of the reference, in float64 NumPy: the discrete
Gamma rates, the GTR eigensystem and the transition matrices.

Written from the definitions, not from the program: the category rates
are the means of K equal-probability categories of Gamma(alpha, alpha)
(Yang 1994), with the regularized incomplete gamma function evaluated by
its series and continued fraction (Numerical Recipes 6.2) and its
quantiles by bisection; P(t) = exp(Q t) through the eigensystem of the
symmetric matrix diag(pi)^1/2 Q diag(pi)^-1/2.
"""
from __future__ import annotations

import math

import numpy as np


def _gammainc(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x)."""
    if x <= 0.0:
        return 0.0
    log_front = a * math.log(x) - x - math.lgamma(a)
    if x < a + 1.0:
        term = total = 1.0 / a
        n = a
        for _ in range(10000):
            n += 1.0
            term *= x / n
            total += term
            if abs(term) < abs(total) * 1e-17:
                break
        return total * math.exp(log_front)
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 10000):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        d = tiny if abs(d) < tiny else d
        c = b + an / c
        c = tiny if abs(c) < tiny else c
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-17:
            break
    return 1.0 - math.exp(log_front) * h


def _gamma_quantile(a: float, p: float) -> float:
    """x with P(a, x) = p, by bisection to the last bit."""
    lo, hi = 0.0, max(1.0, a)
    while _gammainc(a, hi) < p:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            break
        if _gammainc(a, mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def gamma_rates(alpha: float, categories: int) -> np.ndarray:
    """Mean rates of `categories` equal-probability categories of
    Gamma(shape alpha, rate alpha), whose mean is 1."""
    k = categories
    # with X ~ Gamma(alpha, 1) and borders x_i at P(alpha, x_i) = i / k,
    # the mean of X / alpha over category i is k * (P(alpha + 1, x_i+1) -
    # P(alpha + 1, x_i)), since x f_alpha(x) = alpha f_alpha+1(x)
    borders = [0.0] + [_gamma_quantile(alpha, i / k) for i in range(1, k)]
    upper = [_gammainc(alpha + 1.0, x) for x in borders] + [1.0]
    return np.array([k * (upper[i + 1] - upper[i]) for i in range(k)])


def eigensystem(subst, freqs):
    """(eigenvalues, left, right) with Q = left @ diag(eigenvalues) @ right
    for the GTR matrix of exchangeabilities `subst` (the upper triangle,
    row by row: AC, AG, AT, CG, CT, GT for DNA) and frequencies `freqs`,
    scaled to one expected substitution per unit of time."""
    pi = np.asarray(freqs, dtype=np.float64)
    pi = pi / pi.sum()
    s = len(pi)
    exch = np.zeros((s, s))
    exch[np.triu_indices(s, 1)] = np.asarray(subst, dtype=np.float64)
    exch = exch + exch.T
    q = exch * pi[None, :]
    q[np.diag_indices(s)] = -q.sum(axis=1)
    q = q / -(pi * np.diag(q)).sum()
    root = np.sqrt(pi)
    sym = root[:, None] * q / root[None, :]
    values, vectors = np.linalg.eigh(0.5 * (sym + sym.T))
    return values, vectors / root[:, None], vectors.T * root[None, :]


def pmatrices(values, left, right, lengths, rates) -> np.ndarray:
    """P(t * r) for every length t [..., E] and rate r [R]:
    [..., E, R, S, S] float64."""
    t = np.asarray(lengths, dtype=np.float64)[..., None, None] \
        * np.asarray(rates)[:, None]                          # [..., E, R, 1]
    return np.einsum("ij,...j,jk->...ik", left, np.exp(t * values), right)
