"""The plain reference of the phylogenetic likelihood: Felsenstein's
pruning over a newick tree in PyTorch, float64, one node at a time.

    logL = sum over sites of log( sum_r w_r sum_i pi_i
                                  prod_{c child of the root} (P_c CLV_c)_i )

with w_r = 1 / R, CLV_u = prod_{c child of u} P(t_c r) CLV_c, and a tip's
CLV the 0/1 mask of the states its code allows.  Each node's CLV is
divided by its largest entry of the site and the logarithm of that factor
is carried beside it, so nothing underflows at any depth.

`precision="tf32"` is the control of the benchmark's check: the same
pruning in float32 with every product's operands rounded to TF32 (10 bits
of mantissa, to nearest even), as a tensor core takes them, and every
sum, scale and logarithm in float32; the caller compares it with the float64 result as it compares the
program.  The reference imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import model as ref_model
from .newick import Tree

PRECISIONS = ("f64", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def tip_masks(codes: np.ndarray, states: int) -> np.ndarray:
    """[sites] bitmask codes -> [S, sites] 0/1."""
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(states, dtype=np.uint64)[:, None]
    return ((codes[None, :] >> shifts) & np.uint64(1)).astype(np.float64)


def loglikelihood(tree: Tree, lengths, chars: Dict[str, np.ndarray],
                  subst: Sequence[float], freqs: Sequence[float],
                  alpha: float, rate_cats: int, device="cpu",
                  precision: str = "f64") -> np.ndarray:
    """logL of `tree` under GTR + Gamma(alpha, rate_cats), for each row of
    `lengths` [B, E] (edge order of `tree`), on the tip codes `chars`
    ({label: [sites] uint64 bitmasks}).  Returns [B] float64."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    control = precision == "tf32"
    dtype = torch.float32 if control else torch.float64
    lengths = np.atleast_2d(np.asarray(lengths, dtype=np.float64))
    values, left, right = ref_model.eigensystem(subst, freqs)
    rates = ref_model.gamma_rates(alpha, rate_cats)
    pmats = torch.as_tensor(
        ref_model.pmatrices(values, left, right, lengths, rates),
        device=device).to(dtype)                           # [B, E, R, S, S]
    pi = np.asarray(freqs, dtype=np.float64)
    pi = torch.as_tensor(pi / pi.sum(), device=device, dtype=dtype)
    states = len(pi)

    def product(p, clv):        # [B, R, S, S] x [B, R, S, T] or [S, T]
        if control:
            return torch.matmul(tf32_round(p), tf32_round(clv))
        return torch.matmul(p, clv)

    done = {}
    for node in tree.postorder:               # the root comes last
        if not node.children:
            continue
        clv = scale = None
        for child in node.children:
            p = pmats[:, child.edge]
            if child.children:
                child_clv, child_scale = done.pop(id(child))
                msg = product(p, child_clv)
                scale = child_scale if scale is None else scale + child_scale
            else:
                tip = torch.as_tensor(tip_masks(chars[child.label], states),
                                      device=device, dtype=dtype)
                msg = product(p, tip)
            clv = msg if clv is None else clv * msg
        if node is tree.root:
            break
        top = clv.amax(dim=(1, 2))                            # [B, T]
        clv = clv / top[:, None, None, :]
        log_top = torch.log(top)
        done[id(node)] = (clv, log_top if scale is None else scale + log_top)
    site = torch.einsum("brst,s->bt", clv, pi) / rate_cats
    logl = torch.log(site)
    if scale is not None:
        logl = logl + scale
    return logl.sum(dim=1).double().cpu().numpy()
