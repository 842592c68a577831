"""Batched transition-probability matrices (plain PyTorch).

Counterpart of libpll2_tpu/ops/pmatrix.py, with the reference semantics of
pll_core_update_pmatrix (libpll-2 src/core_pmatrix.c:24-258):

  * expd_j = expm1(lambda_j * rate_r * t / (1 - pinv_r)) — the expm1 + add-I
    form keeps P exact as Qt -> 0;
  * P = I + inv_eigenvecs @ diag(expd) @ eigenvecs;
  * t <= 0 -> exact identity matrix;
  * params_indices maps each rate category to its rate matrix.

Shapes: E = branches in the batch, R = rate categories, S = states,
M = rate matrices.
"""
from __future__ import annotations

import torch

from .. import spans


def compute_pmatrices(branch_lengths,      # [E]
                      eigenvals,           # [M, S]
                      eigenvecs,           # [M, S, S]
                      inv_eigenvecs,       # [M, S, S]
                      rates,               # [R]
                      prop_invar,          # [M]
                      params_indices,      # [R] int (rate cat -> rate matrix)
                      dtype=torch.float64):
    """Return P-matrices [E, R, S, S] for a batch of branch lengths."""
    with spans.span("pmatrix"):
        idx = params_indices.long()
        evals = eigenvals[idx].to(dtype)                        # [R, S]
        evecs = eigenvecs[idx].to(dtype)                        # [R, S, S]
        inv_evecs = inv_eigenvecs[idx].to(dtype)                # [R, S, S]
        pinv = prop_invar[idx].to(dtype)                        # [R]

        t = torch.as_tensor(branch_lengths, dtype=dtype,
                            device=evals.device)                # [E]
        scaled_rates = rates.to(dtype) / (1.0 - pinv)           # [R]
        exponent = (t[:, None, None] * scaled_rates[None, :, None]
                    * evals[None, :, :])                        # [E, R, S]
        expd = torch.expm1(exponent)

        # temp[e,r,j,k] = inv_evecs[r,j,k] * expd[e,r,k]; P = I + temp @ evecs
        temp = inv_evecs[None, :, :, :] * expd[:, :, None, :]
        pmat = torch.einsum("erjm,rmk->erjk", temp, evecs)
        states = evals.shape[-1]
        eye = torch.eye(states, dtype=dtype, device=evals.device)
        pmat = pmat + eye

        # zero branch length -> exact identity (core_pmatrix.c:239-245)
        zero = (t <= 0.0)[:, None, None, None]
        return torch.where(zero, eye, pmat)


def scatter_pmatrices(pmatrix,            # [P, R, S, S] full buffer
                      matrix_indices,     # [E] int
                      new_pmats):         # [E, R, S, S]
    """Write freshly computed P-matrices into the partition's buffer;
    returns a new buffer and leaves `pmatrix` as it was."""
    out = pmatrix.clone()
    out[torch.as_tensor(matrix_indices, dtype=torch.int64,
                        device=pmatrix.device)] = new_pmats.to(pmatrix.dtype)
    return out
