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
    """Return P-matrices [E, R, S, S] for a batch of branch lengths: one
    model's compute_pmatrices_batched."""
    idx = params_indices.long()
    t = torch.as_tensor(branch_lengths, dtype=dtype, device=eigenvals.device)
    return compute_pmatrices_batched(
        t[None], eigenvals[idx][None], eigenvecs[idx][None],
        inv_eigenvecs[idx][None], rates[None], prop_invar[idx][None],
        dtype=dtype)[0]


def compute_pmatrices_batched(lengths,       # [K, E]
                              eigenvals,     # [K, R, S]
                              eigenvecs,     # [K, R, S, S]
                              inv_eigenvecs,  # [K, R, S, S]
                              rates,         # [K, R]
                              prop_invar,    # [K, R]
                              dtype=torch.float64):
    """P-matrices [K, E, R, S, S] (contiguous) of K models at once: model
    k's at its own lengths lengths[k], its eigensystem given per rate
    category (the rate matrix its params_indices pick), with the
    semantics of compute_pmatrices: P = I + inv_eigenvecs @ diag(expm1(
    lambda * rate * t / (1 - pinv))) @ eigenvecs, the identity exactly at
    t <= 0 (core_pmatrix.c:239-245).  One batched product over every model
    and rate category, so that one model's call launches few kernels."""
    with spans.span("pmatrix"):
        t = lengths.to(dtype)                                   # [K, E]
        K, E = t.shape
        R, S = rates.shape[1], eigenvals.shape[-1]
        scaled_rates = rates.to(dtype) / (1.0 - prop_invar.to(dtype))
        exponent = (t[:, None, :, None] * scaled_rates[:, :, None, None]
                    * eigenvals.to(dtype)[:, :, None, :])       # [K, R, E, S]
        # expm1 is 0 at t <= 0, so P is the identity there exactly
        expd = torch.where((t > 0.0)[:, None, :, None],
                           torch.expm1(exponent),
                           torch.zeros((), dtype=dtype, device=t.device))
        # temp[k,r,e,j,m] = inv_evecs[k,r,j,m] * expd[k,r,e,m]
        temp = inv_eigenvecs.to(dtype)[:, :, None] * expd[:, :, :, None, :]
        pmat = torch.bmm(temp.view(K * R, E * S, S),
                         eigenvecs.to(dtype).reshape(K * R, S, S))
        # I added apart, so that bf16 rounds the product before the sum
        pmat = pmat.view(K, R, E, S, S) + torch.eye(S, dtype=dtype,
                                                    device=t.device)
        return pmat.transpose(1, 2).contiguous()


def scatter_pmatrices(pmatrix,            # [P, R, S, S] full buffer
                      matrix_indices,     # [E] int
                      new_pmats):         # [E, R, S, S]
    """Write freshly computed P-matrices into the partition's buffer;
    returns a new buffer and leaves `pmatrix` as it was."""
    out = pmatrix.clone()
    out[torch.as_tensor(matrix_indices, dtype=torch.int64,
                        device=pmatrix.device)] = new_pmats.to(pmatrix.dtype)
    return out
