"""The plain reference of a partitioned likelihood: the sum over partitions
of reference/likelihood.py's pruning, each partition at its own model and
at its own branch lengths t * s_k (RAxML-NG's --brlen scaled), in
PyTorch float64.

    logL = sum_k sum over partition k's sites of
           log( sum_r w_r sum_i pi_k,i prod_{c child of the root}
                (P_k(s_k t_c rho_k,r) CLV_c)_i )

with P_k(t) = exp(Q_k t) from partition k's own eigensystem (its
exchangeabilities and frequencies, reference/model.py), rho_k its Gamma
rates (exact means) and w_r = 1 / R.  Each node's CLV is divided by its
largest entry of the site and the logarithm of that factor is carried
beside it, as likelihood.py does.

Partitions are computed in blocks: partitions of similar length side by
side, each padded with all-gap columns to the block's longest and the
padding left out of the sums, so that a batch of length vectors over a
thousand partitions takes a few hundred products a node and not a few
hundred thousand.  A P-matrix is made when its edge is used.

`precision="tf32"` is the control: the same pruning in float32 with every
product's operands rounded to TF32 (likelihood.tf32_round).  The
reference imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import model as ref_model
from .likelihood import PRECISIONS, tf32_round, tip_masks
from .newick import Tree

BLOCK_SITES = 1 << 15       # sites (padded) of the partitions of one block


@dataclasses.dataclass
class PartitionModel:
    """One partition's substitution model and multiplier."""
    subst: Sequence[float]
    freqs: Sequence[float]
    alpha: float
    scaler: float


def blocks(lengths: Sequence[int], states: Sequence[int],
           block_sites: int = BLOCK_SITES) -> List[np.ndarray]:
    """Partition indices in blocks of one state count: sorted by state
    count and length, each block's count times its longest length at most
    block_sites (one partition at least)."""
    order = np.lexsort((np.asarray(lengths), np.asarray(states)))
    out, cur = [], []
    for k in order:
        if cur and (states[k] != states[cur[0]]
                    or (len(cur) + 1) * lengths[k] > block_sites):
            out.append(np.asarray(cur))
            cur = []
        cur.append(int(k))
    if cur:
        out.append(np.asarray(cur))
    return out


def partition_loglikelihoods(tree: Tree, lengths,
                             chars: Dict[str, np.ndarray],
                             bounds: Sequence[int],
                             models: Sequence[PartitionModel],
                             rate_cats: int, device="cpu",
                             precision: str = "f64",
                             block_sites: int = BLOCK_SITES) -> np.ndarray:
    """logL of every partition for each row of `lengths` [B, E] (edge order
    of `tree`): [B, K] float64.  chars: {label: [N] uint64 bitmask codes},
    the partitions' sites one after another, partition k at sites
    bounds[k]:bounds[k + 1]."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    control = precision == "tf32"
    dtype = torch.float32 if control else torch.float64
    lengths = torch.as_tensor(np.atleast_2d(np.asarray(lengths, np.float64)),
                              device=device)
    bounds = np.asarray(bounds)
    sizes = np.diff(bounds)
    n_batch = lengths.shape[0]
    out = np.zeros((n_batch, len(models)))
    states = [len(m.freqs) for m in models]
    for block in blocks(sizes, states, block_sites):
        out[:, block] = _block(tree, lengths, chars, bounds, sizes, block,
                               [models[k] for k in block], rate_cats,
                               device, dtype, control)
    return out


def loglikelihood(*args, **kw) -> np.ndarray:
    """The total over partitions of partition_loglikelihoods: [B]."""
    return partition_loglikelihoods(*args, **kw).sum(axis=1)


def _block(tree, lengths, chars, bounds, sizes, block, models, rate_cats,
           device, dtype, control):
    """[B, Kb] logL of the partitions `block`, side by side."""
    f64 = torch.float64
    width = int(sizes[block].max())
    systems = [ref_model.eigensystem(m.subst, m.freqs) for m in models]
    values = torch.as_tensor(np.stack([s[0] for s in systems]), device=device)
    left = torch.as_tensor(np.stack([s[1] for s in systems]), device=device)
    right = torch.as_tensor(np.stack([s[2] for s in systems]), device=device)
    rates = torch.as_tensor(np.stack([ref_model.gamma_rates(m.alpha,
                                                            rate_cats)
                                      for m in models]), device=device)
    scale = torch.as_tensor([float(m.scaler) for m in models], device=device,
                            dtype=f64)
    pi = np.stack([np.asarray(m.freqs, np.float64) for m in models])
    pi = torch.as_tensor(pi / pi.sum(axis=1, keepdims=True), device=device,
                         dtype=dtype)                         # [Kb, S]
    states = pi.shape[1]
    # each partition's sites in a row of `width` columns, the rest gaps
    cols = np.arange(width)
    inside = cols[None, :] < sizes[block][:, None]            # [Kb, L]
    take = np.where(inside, bounds[block][:, None] + cols[None, :], -1)
    gap = np.uint64((1 << states) - 1)

    def tip(label):                                     # [Kb, S, L] 0/1
        codes = np.where(inside, chars[label][np.maximum(take, 0)], gap)
        masks = tip_masks(codes.reshape(-1), states).reshape(
            states, len(block), width).transpose(1, 0, 2)
        return torch.as_tensor(np.ascontiguousarray(masks), device=device,
                               dtype=dtype)

    def pmatrix(edge):                          # [B, Kb, R, S, S]
        t = lengths[:, edge, None] * scale[None, :]           # [B, Kb]
        decay = torch.exp(values[None, :, None, :]
                          * (t[:, :, None, None] * rates[None, :, :, None]))
        p = torch.matmul(left[None, :, None] * decay[..., None, :],
                         right[None, :, None])
        return p.to(dtype)

    def product(p, clv):        # [B, Kb, R, S, S] x [B, Kb, R, S, L]
        if control:
            return torch.matmul(tf32_round(p), tf32_round(clv))
        return torch.matmul(p, clv)

    done = {}
    for node in tree.postorder:               # the root comes last
        if not node.children:
            continue
        clv = scale_log = None
        for child in node.children:
            p = pmatrix(child.edge)
            if child.children:
                child_clv, child_scale = done.pop(id(child))
                msg = product(p, child_clv)
                scale_log = child_scale if scale_log is None \
                    else scale_log + child_scale
            else:
                msg = product(p, tip(child.label)[None, :, None])
            clv = msg if clv is None else clv * msg
        if node is tree.root:
            break
        top = clv.amax(dim=(2, 3))                            # [B, Kb, L]
        clv = clv / top[:, :, None, None, :]
        log_top = torch.log(top)
        done[id(node)] = (clv, log_top if scale_log is None
                          else scale_log + log_top)
    site = torch.einsum("bkrsl,ks->bkl", clv, pi) / rate_cats
    logl = torch.log(site)
    if scale_log is not None:
        logl = logl + scale_log
    live = torch.as_tensor(inside, device=device)
    logl = torch.where(live, logl.to(f64), torch.zeros((), dtype=f64,
                                                       device=device))
    return logl.sum(dim=2).cpu().numpy()
