"""Branch-length derivative machinery: sumtable + analytic (d1, d2).

Counterpart of libpll2_tpu/ops/derivatives.py (plain PyTorch).  Reference
semantics (libpll-2 src/core_derivatives.c):

  * The sumtable factors out everything branch-length-independent
    (pll_core_update_sumtable_ii, core_derivatives.c:321-471):
        sum[t, r, j] = (sum_k clvp[k] * freq[k] * inv_evec[k, j])
                     * (sum_k evec[j, k] * clvc[k])
  * Per (rate, state), diagp carries {e^{lam k t}, lam k e^{...},
    (lam k)^2 e^{...}} with k = rate / (1 - pinv)
    (core_derivatives.c:757-772).
  * site_lk[0..2] = sum_r rw_r * sum_j sum[r,j] * diagp[r,j,0..2] with +I
    mixing on the 0th component only (core_derivatives.c:643-694).
  * d(-lnL)/dt  = sum_t w_t * (-L'/L)
    d2(-lnL)/dt2 = sum_t w_t * ((L'/L)^2 - L''/L)   (:843-848).

Scalers: in per-site mode the common scale factor cancels in L'/L, so the
sumtable ignores scalers; in per-rate mode relative (capped) per-rate
scalers are folded into the sumtable (core_derivatives.c:418-460).

Layout: sumtable [..., R, S, T].  Unlike the JAX functions, which price
one edge, these take any leading batch axes (edges, candidates, slots) on
the CLVs, scalers and branch lengths; the model tensors are shared.

Site sharding (parallel/): with a process group, `cfg` is a rank's
SiteSlice, and the weighted site sums (logL, d1, d2 and the asc-bias
components L0, L1, L2 and weight sums) are all-reduced over the group
before the corrections combine them, so a Newton step takes the same
(d1, d2) on every rank.
"""
from __future__ import annotations

import torch

from ..config import PartitionConfig, phantom_columns, site_columns
from .likelihood import _reduce_logl, all_reduce_sites
from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                         SCALE_RATE_MAXDIFF)


def _phantom_mask(cfg: PartitionConfig, device):
    """Bool [T]: the asc-bias phantom per-state columns."""
    cols = site_columns(cfg)
    return torch.as_tensor((cols >= cfg.sites)
                           & (cols < cfg.sites + cfg.states), device=device)


def _real_mask(cfg: PartitionConfig, device):
    return torch.as_tensor(site_columns(cfg) < cfg.sites, device=device)


def update_sumtable(clvp,            # [..., R, S, T] parent CLV
                    clvc,            # [..., R, S, T] child CLV
                    scaler_p,        # [..., R, T] int32 or None (per-rate)
                    scaler_c,        # [..., R, T] int32 or None
                    eigenvecs,       # [R, S, S] (gathered per category)
                    inv_eigenvecs,   # [R, S, S]
                    freqs,           # [R, S]
                    cfg: PartitionConfig,
                    asc_scalers=None):  # [..., T] int32: per-site sp+sc
    """Branch-invariant sufficient statistics of edges: [..., R, S, T].

    Mirrors pll_core_update_sumtable_ii (core_derivatives.c:321-471).
    """
    dtype = clvp.dtype
    lefterm = torch.einsum("...rkt,rk,rkj->...rjt", clvp, freqs.to(dtype),
                           inv_eigenvecs.to(dtype))
    righterm = torch.einsum("rjk,...rkt->...rjt", eigenvecs.to(dtype), clvc)
    sum_rjt = lefterm * righterm

    if (cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN)
            and asc_scalers is not None and not cfg.per_rate_scalers):
        # fold thresh^scalers into the PHANTOM columns only: the asc
        # corrections need absolute likelihoods there (core_derivatives.c:
        # 884-892), while real-site ratios L'/L make scaling cancel.
        undo = torch.exp(asc_scalers.to(dtype) * cfg.log_scale_threshold)
        sum_rjt = torch.where(_phantom_mask(cfg, clvp.device),
                              sum_rjt * undo[..., None, None, :], sum_rjt)

    if cfg.per_rate_scalers:
        total = scaler_p + scaler_c                          # [..., R, T]
        min_scaler = torch.min(total, dim=-2, keepdim=True).values
        rel = torch.clamp(total - min_scaler, max=SCALE_RATE_MAXDIFF)
        undo = torch.pow(torch.tensor(cfg.scale_threshold, dtype=dtype,
                                      device=rel.device), rel.to(dtype))
        sum_rjt = sum_rjt * undo[..., :, None, :]

    return sum_rjt


def _exponentials(branch_length, rates, eigenvals, prop_invar, dtype):
    """(x, e0) with x [R, S] = lam * k and e0 [..., R, S] = e^{x t}."""
    pinv = prop_invar.to(dtype)
    ki = rates.to(dtype) / (1.0 - pinv)                        # [R]
    x = eigenvals.to(dtype) * ki[:, None]                      # [R, S]
    t = torch.as_tensor(branch_length, dtype=dtype, device=x.device)
    return x, torch.exp(x * t[..., None, None])


def _invariant_lk(freqs, invariant, dtype):
    """pi[inv_state] per (rate, site), 0 on variant sites: [R, T]."""
    idx = torch.clamp(invariant, min=0).long()
    vals = freqs.to(dtype)[:, idx]
    return torch.where(invariant[None, :] >= 0, vals,
                       torch.zeros((), dtype=dtype, device=vals.device))


def sumtable_loglikelihood(sumtable,         # [..., R, S, T]
                           branch_length,    # [...]
                           rates,            # [R]
                           eigenvals,        # [R, S]
                           prop_invar,       # [R]
                           rate_weights,     # [R]
                           freqs,            # [R, S]
                           invariant,        # [T] int32
                           pattern_weights,  # [T]
                           site_scalings,    # [..., T] int32 summed scalers
                           cfg: PartitionConfig,
                           group=None):
    """Log-likelihood of edges AT branch length t, from their sumtables.

    Σ_j sum[r,j,t]·e^{λ_j k t} = clvp·freq·expm(Q k t)·clvc — the per-site
    likelihood of the edge logL (cat0 of core_derivatives.c:643-694 with +I
    mixing).  Per-site scalers enter as the summed counter correction;
    per-rate relative scalers must already be folded into the sumtable.
    Lewis/Felsenstein asc bias needs the phantom columns already absolute
    (update_sumtable asc_scalers); Stamatakis uses the raw scalings.
    `group`: the process group the sites are sharded over (None: not
    sharded).
    """
    dtype = sumtable.dtype
    pinv = prop_invar.to(dtype)
    _, e0 = _exponentials(branch_length, rates, eigenvals, prop_invar, dtype)
    cat0 = torch.einsum("...rjt,...rj->...rt", sumtable, e0)
    inv_lk = _invariant_lk(freqs, invariant, dtype)
    has_pinv = (pinv > 0)[:, None]
    cat0 = torch.where(has_pinv,
                       cat0 * (1.0 - pinv)[:, None] + inv_lk * pinv[:, None],
                       cat0)
    term = torch.einsum("...rt,r->...t", cat0, rate_weights.to(dtype))
    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        live = live & _real_mask(cfg, live.device)
    one = torch.ones((), dtype=dtype, device=term.device)
    safe = torch.where(live, term, one)
    site_lk = torch.log(safe) + site_scalings.to(dtype) \
        * cfg.log_scale_threshold
    logl = torch.sum(torch.where(live, site_lk * pattern_weights.to(dtype),
                                 torch.zeros_like(site_lk)), dim=-1)
    sc = site_scalings
    if cfg.asc_bias in (AB_LEWIS, AB_FELSENSTEIN):
        # phantoms already absolute in the sumtable -> no re-undo
        sc = torch.where(_phantom_mask(cfg, sc.device),
                         torch.zeros_like(sc), sc)
    return _reduce_logl(logl, term, sc, pattern_weights, cfg, dtype, group)


def likelihood_derivatives(sumtable,         # [..., R, S, T]
                           branch_length,    # [...]
                           rates,            # [R]
                           eigenvals,        # [R, S] (gathered per category)
                           prop_invar,       # [R]
                           rate_weights,     # [R]
                           freqs,            # [R, S]
                           invariant,        # [T] int32, -1 = variant
                           pattern_weights,  # [T] (0 on padding)
                           cfg: PartitionConfig,
                           group=None):
    """(d1, d2) [...] of -lnL wrt branch length, given the sumtables.

    Mirrors pll_core_likelihood_derivatives (core_derivatives.c:696-929).
    `group`: the process group the sites are sharded over (None: not
    sharded).
    """
    dtype = sumtable.dtype
    pinv = prop_invar.to(dtype)
    x, e0 = _exponentials(branch_length, rates, eigenvals, prop_invar, dtype)
    e1 = x * e0
    e2 = x * x * e0

    cat0 = torch.einsum("...rjt,...rj->...rt", sumtable, e0)
    cat1 = torch.einsum("...rjt,...rj->...rt", sumtable, e1)
    cat2 = torch.einsum("...rjt,...rj->...rt", sumtable, e2)

    # +I mixing, 0th component only (core_derivatives.c:676-686)
    inv_lk = _invariant_lk(freqs, invariant, dtype)
    has_pinv = (pinv > 0)[:, None]
    keep = (1.0 - pinv)[:, None]
    cat0 = torch.where(has_pinv, cat0 * keep + inv_lk * pinv[:, None], cat0)
    cat1 = torch.where(has_pinv, cat1 * keep, cat1)
    cat2 = torch.where(has_pinv, cat2 * keep, cat2)

    rw = rate_weights.to(dtype)
    lk0 = torch.einsum("...rt,r->...t", cat0, rw)
    lk1 = torch.einsum("...rt,r->...t", cat1, rw)
    lk2 = torch.einsum("...rt,r->...t", cat2, rw)

    live = pattern_weights > 0
    if cfg.asc_bias not in (AB_NONE, AB_STAMATAKIS):
        # Lewis/Felsenstein: phantom sites excluded from the main sum and
        # folded in via the closed-form corrections (core_derivatives.c:
        # 851-924).  Stamatakis keeps them in the main sum.
        live = live & _real_mask(cfg, live.device)
    one = torch.ones((), dtype=dtype, device=lk0.device)
    zero = torch.zeros((), dtype=dtype, device=lk0.device)
    safe0 = torch.where(live, lk0, one)
    deriv1 = -lk1 / safe0
    deriv2 = deriv1 * deriv1 - lk2 / safe0

    w = pattern_weights.to(dtype)
    d1 = torch.sum(torch.where(live, w * deriv1, zero), dim=-1)
    d2 = torch.sum(torch.where(live, w * deriv2, zero), dim=-1)

    if cfg.asc_bias not in (AB_LEWIS, AB_FELSENSTEIN):
        d1, d2 = all_reduce_sites([d1, d2], group)
        return d1, d2
    ph = phantom_columns(cfg)
    # scalers cancel in L'/L for the main sum but NOT in the absolute
    # phantom likelihoods: the caller folds thresh^scalers into the
    # sumtable's phantom columns (update_sumtable asc_scalers).
    L0 = torch.sum(lk0[..., ph], dim=-1)
    L1 = torch.sum(lk1[..., ph], dim=-1)
    L2 = torch.sum(lk2[..., ph], dim=-1)
    if cfg.asc_bias == AB_LEWIS:
        sum_w = torch.sum(torch.where(_real_mask(cfg, w.device), w, zero))
    else:
        sum_w = torch.sum(w[ph])
    d1, d2, L0, L1, L2, sum_w = all_reduce_sites(
        [d1, d2, L0, L1, L2, sum_w], group)
    if cfg.asc_bias == AB_LEWIS:
        d1 = d1 + sum_w * (L1 / (L0 - 1.0))
        d2 = d2 + sum_w * (((L0 - 1.0) * L2 - L1 * L1)
                           / ((L0 - 1.0) * (L0 - 1.0)))
    else:
        d1 = d1 - sum_w * (L1 / L0)
        d2 = d2 - sum_w * ((L2 * L0 - L1 * L1) / (L0 * L0))
    return d1, d2


def newton_update(t, d1, d2, lo: float = 1e-8, hi: float = 100.0,
                  hold_nonfinite: bool = True):
    """One safeguarded Newton step on branch lengths from (d1, d2) of
    -lnL: pure Newton where the surface is locally convex (d2 > 0), else
    halve/double along -d1; a non-finite step holds t (f32 pathologies on
    terrible topologies); clip to [lo, hi]."""
    newton = t - d1 / d2
    fallback = torch.where(d1 > 0, t * 0.5, t * 2.0)
    t_new = torch.where(d2 > 0, newton, fallback)
    if hold_nonfinite:
        t_new = torch.where(torch.isfinite(t_new), t_new, t)
    return torch.clamp(t_new, lo, hi)
