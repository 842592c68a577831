"""GTR-family rate-matrix construction and eigendecomposition.

Host-side (numpy/f64) model math mirroring the reference semantics
(libpll-2 src/models.c:182-410) with the classic symmetrization trick:

  * substitution params are normalized by the last parameter;
  * exchangeabilities involving a (near-)zero-frequency state are zeroed
    (threshold EIGEN_MINFREQ = 1e-6) and those states are eliminated from the
    eigenproblem (identity rows/cols, zero eigenvalues) — the IQ-TREE trick;
  * B = sqrt(pi) * Q * sqrt(pi)^-1 is symmetric, so a symmetric eigensolver
    applies; we use numpy's LAPACK eigh instead of the reference's
    Householder+QL pair — P(t) = exp(Qt) is invariant to the choice of
    orthonormal eigenbasis, so results agree to rounding error;
  * Q is normalized so the mean substitution rate  sum_i pi_i * (-q_ii) = 1;
  * stored factors are  eigenvecs = sqrt(pi)^-1 * V  (row-scaled) and
    inv_eigenvecs = V^T * sqrt(pi)  so that  P = eigenvecs' @ diag(e^{lam t})
    @ inv_eigenvecs' in the same orientation the reference uses
    (models.c:388-398).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import EIGEN_MINFREQ


class EigenDecomp(NamedTuple):
    """Eigen factors of one rate matrix (all shape checks per states S).

    eigenvals:      [S]    eigenvalues of Q (0 for eliminated states)
    eigenvecs:      [S,S]  right factor, rows indexed by state
    inv_eigenvecs:  [S,S]  left factor
    P(t) is assembled as  I + inv_eigenvecs_row_scaled … — see ops/pmatrix.py.
    """
    eigenvals: np.ndarray
    eigenvecs: np.ndarray
    inv_eigenvecs: np.ndarray


def build_rate_matrix(subst_params: np.ndarray, freqs: np.ndarray
                      ) -> np.ndarray:
    """Build the symmetrized, normalized matrix sqrt(pi) Q sqrt(pi)^-1.

    Mirrors create_ratematrix (models.c:182-256).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    params = np.asarray(subst_params, dtype=np.float64).copy()
    states = freqs.shape[0]
    expected = states * (states - 1) // 2
    if params.shape[0] != expected:
        raise ValueError(
            f"expected {expected} subst params for {states} states, "
            f"got {params.shape[0]}")

    if params[-1] > 0.0:
        params = params / params[-1]

    q = np.zeros((states, states), dtype=np.float64)
    k = 0
    for i in range(states):
        for j in range(i + 1, states):
            factor = 0.0 if (freqs[i] <= EIGEN_MINFREQ
                             or freqs[j] <= EIGEN_MINFREQ) else params[k]
            k += 1
            q[i, j] = q[j, i] = factor * np.sqrt(freqs[i] * freqs[j])
            q[i, i] -= factor * freqs[j]
            q[j, j] -= factor * freqs[i]

    mean = np.sum(freqs * (-np.diag(q)))
    q /= mean
    return q


def update_eigen(subst_params: np.ndarray, freqs: np.ndarray) -> EigenDecomp:
    """Eigendecompose the (symmetrized) rate matrix.

    Mirrors pll_update_eigen (models.c:293-410) including zero-frequency
    state elimination.  Returns dense [S]/[S,S] factors.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    states = freqs.shape[0]
    b = build_rate_matrix(subst_params, freqs)

    keep = freqs > EIGEN_MINFREQ
    kept = np.flatnonzero(keep)
    new_states = kept.shape[0]

    sub = b[np.ix_(kept, kept)]
    # LAPACK symmetric eigensolver on the reduced matrix.
    d, v = np.linalg.eigh(sub)

    sqrt_f = np.sqrt(freqs[kept])

    eigenvals = np.zeros(states, dtype=np.float64)
    eigenvals[kept] = d

    # Orientation: LAPACK eigh returns columns v[:, m] as eigenvectors; the
    # reference stores rows a[m][:] as eigenvectors (models.c:376-396), with
    #   eigenvecs[i, j]     = a[i][j] * sqrt_f[j]  = v[j, i] * sqrt_f[j]
    #   inv_eigenvecs[i, j] = a[j][i] / sqrt_f[i]  = v[i, j] / sqrt_f[i]
    # so that P(t) = I + inv_eigenvecs @ diag(expm1(lam t)) @ eigenvecs.
    if new_states < states:
        eigenvecs = np.eye(states, dtype=np.float64)
        inv_eigenvecs = np.eye(states, dtype=np.float64)
        eigenvecs[np.ix_(kept, kept)] = v.T * sqrt_f[np.newaxis, :]
        inv_eigenvecs[np.ix_(kept, kept)] = v / sqrt_f[:, np.newaxis]
    else:
        eigenvecs = v.T * sqrt_f[np.newaxis, :]
        inv_eigenvecs = v / sqrt_f[:, np.newaxis]

    return EigenDecomp(eigenvals=eigenvals,
                       eigenvecs=eigenvecs,
                       inv_eigenvecs=inv_eigenvecs)


# --------------------------------------------------------------------------
# Differentiable variants (torch) — the autograd model-fitting path
# (fit.py), counterparts of the JAX package's build_rate_matrix_jax and
# update_eigen_jax: d logL / d (subst params, frequencies) by autograd
# through the eigendecomposition.  The zero-frequency state elimination
# (data-dependent shapes) is omitted: fitted frequencies are kept strictly
# positive by the softmax parametrization.  torch.linalg.eigh's backward
# divides by eigenvalue gaps, so exactly degenerate spectra (all rates
# equal, uniform frequencies) give a non-finite gradient: fit.pack nudges
# tied rates apart.
# --------------------------------------------------------------------------

def build_rate_matrix_torch(subst_params, freqs):
    """Symmetrized normalized sqrt(pi) Q sqrt(pi)^-1 from tensors
    subst_params [S (S - 1) / 2] and freqs [S], differentiable."""
    S = freqs.shape[0]
    iu = np.triu_indices(S, 1)                      # static index pattern
    params = subst_params / subst_params[-1]
    rates = torch.zeros((S, S), dtype=freqs.dtype, device=freqs.device)
    rates = rates.index_put(
        (torch.as_tensor(iu[0], device=freqs.device),
         torch.as_tensor(iu[1], device=freqs.device)), params.to(freqs.dtype))
    rates = rates + rates.T                         # factor_ij, zero diag
    sq = torch.sqrt(freqs)
    b = rates * sq[:, None] * sq[None, :]
    diag = -(rates * freqs[None, :]).sum(dim=1)     # q_ii
    b = b + torch.diag(diag)
    mean = torch.sum(freqs * -diag)
    return b / mean


def update_eigen_torch(subst_params, freqs):
    """Differentiable eigendecomposition; returns (eigenvals, eigenvecs,
    inv_eigenvecs) in the same orientation as update_eigen.  An
    eigenvector's sign is the solver's choice; P(t) does not depend on
    it."""
    b = build_rate_matrix_torch(subst_params, freqs)
    d, v = torch.linalg.eigh(b)
    sq = torch.sqrt(freqs)
    eigenvecs = v.T * sq[None, :]
    inv_eigenvecs = v / sq[:, None]
    return d, eigenvecs, inv_eigenvecs


def normalize_frequencies(freqs: np.ndarray) -> np.ndarray:
    """Renormalize frequencies to sum to 1 if they deviate by > 1e-8.

    Mirrors pll_set_frequencies (models.c:445-467).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    s = freqs.sum()
    if abs(s - 1.0) > 1e-8:
        freqs = freqs / s
    return freqs
