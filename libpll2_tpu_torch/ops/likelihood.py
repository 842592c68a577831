"""Root and edge log-likelihood reductions (plain PyTorch).

Counterpart of libpll2_tpu/ops/likelihood.py, with the marginal ancestral
states of a node (`node_ancestral`).  Reference semantics:
pll_core_root_loglikelihood and pll_core_edge_loglikelihood_ii (libpll-2
src/core_likelihood.c:25-209, 1191-1496), including:

  * +I invariant-site mixing:  L_r = (1-p) * L_var,r + p * pi[inv_state]
    per rate category;
  * per-site scaler correction:  logL += scaler * log(scale_threshold);
  * per-rate scalers: per-site common minimum, relative per-rate scalers
    capped at SCALE_RATE_MAXDIFF and undone multiplicatively
    (core_likelihood.c:1388-1414);
  * the invariant term is never scaled — with active scalers the variant
    part is unscaled (capped) before adding the invariant part
    (core_likelihood.c:1462-1481).

Shapes are [R = rate cats, S = states, T = padded sites]; reductions over
sites use pattern weights (zero on padding, so padding is inert).

Site sharding (parallel/): with a process group, `cfg` is a rank's
SiteSlice and T its slice; every weighted site sum is all-reduced over
the group before anything nonlinear is applied to it (the asc-bias
corrections take the summed components), so each rank returns the whole
partition's logL.  Per-site outputs stay the rank's own.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import spans
from ..config import PartitionConfig, phantom_columns, site_columns
from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                         SCALE_RATE_MAXDIFF)


def _real_site_mask(cfg: PartitionConfig):
    """Static bool [T]: True on real alignment columns, False on the
    asc-bias phantom per-state columns and padding (pll.c:525-531)."""
    return site_columns(cfg) < cfg.sites


def _site_mask(cfg: PartitionConfig, device):
    """_real_site_mask made on `device`, not copied from the host, so that
    a CUDA graph can hold it."""
    start = int(site_columns(cfg)[0])
    return torch.arange(start, start + cfg.sites_padded,
                        device=device) < cfg.sites


def all_reduce_sites(parts, group):
    """Sum each of the tensors `parts` over the ranks of `group` (one
    collective for all of them) and return them; `group` None returns
    `parts` as they are."""
    if group is None:
        return list(parts)
    import torch.distributed as dist
    parts = torch.broadcast_tensors(*parts)
    buf = torch.stack(parts)
    dist.all_reduce(buf, group=group)
    return list(buf.unbind(0))


def _asc_parts(term, site_scalings, pattern_weights, cfg: PartitionConfig,
               dtype):
    """The site sums the asc-bias correction is a function of, over the
    columns `cfg` holds (_asc_sums)."""
    ph = phantom_columns(cfg)

    def real_weight():
        real = _site_mask(cfg, pattern_weights.device)
        return torch.sum(torch.where(real, pattern_weights, 0.0).to(dtype))

    return _asc_sums(term[..., ph], site_scalings[..., ph].to(dtype),
                     pattern_weights[ph].to(dtype),
                     lambda x: torch.sum(x, dim=-1), real_weight, cfg)


def _asc_sums(term, scalings, weights, total, real_weight,
              cfg: PartitionConfig):
    """The parts of _asc_finish: Stamatakis [the correction itself]; Lewis
    [base, sum of the real sites' weights]; Felsenstein [base, sum of the
    phantom sites' weights].  `term`, `scalings` and `weights` are the
    phantom per-state columns' pre-log likelihoods, scaler counts and
    weights, `total` sums them over the phantom columns of each logL, and
    `real_weight()` gives the real sites' weights summed."""
    log_thresh = cfg.log_scale_threshold
    if cfg.asc_bias == AB_STAMATAKIS:
        # the reference adds the scaler correction unweighted
        # (likelihood.c:97-101)
        return [total(weights * torch.log(term) + scalings * log_thresh)]
    base = total(term * torch.exp(scalings * log_thresh))
    if cfg.asc_bias == AB_LEWIS:
        return [base, real_weight()]
    if cfg.asc_bias == AB_FELSENSTEIN:
        return [base, total(weights)]
    raise ValueError(f"illegal asc bias type {cfg.asc_bias}")


def _asc_finish(parts, cfg: PartitionConfig):
    """The asc-bias correction from the (summed) parts of _asc_parts."""
    if cfg.asc_bias == AB_STAMATAKIS:
        return parts[0]
    base, sum_w = parts
    if cfg.asc_bias == AB_LEWIS:
        return -(sum_w * torch.log1p(-base))
    return sum_w * torch.log(base)


def asc_bias_correction(term, site_scalings, pattern_weights,
                        cfg: PartitionConfig, dtype, group=None):
    """Ascertainment-bias logL correction from the phantom per-state sites
    (compute_asc_bias_correction + root_loglikelihood_asc_bias,
    likelihood.c:24-120).  `term` is the pre-log per-site likelihood,
    `site_scalings` the per-site scaler counters, both [..., T] (leading
    axes are batch axes, e.g. the slots of a search round).  With a
    process group the components are summed over its ranks first."""
    return _asc_finish(all_reduce_sites(
        _asc_parts(term, site_scalings, pattern_weights, cfg, dtype),
        group), cfg)


def _reduce_logl(logl, term, site_scalings, pattern_weights,
                 cfg: PartitionConfig, dtype, group):
    """The weighted site sum `logl` summed over the ranks of `group`, plus
    the asc-bias correction from the summed components: one collective."""
    asc = cfg.asc_bias != AB_NONE
    parts = _asc_parts(term, site_scalings, pattern_weights, cfg,
                       dtype) if asc else []
    logl, *parts = all_reduce_sites([logl] + parts, group)
    return logl + _asc_finish(parts, cfg) if asc else logl


def _acc_dtype(clv):
    """The dtype a reduction over `clv` accumulates in."""
    return torch.float32 if clv.dtype == torch.bfloat16 else clv.dtype


def _per_rate_undo(scaler_p, scaler_c, cfg: PartitionConfig, dtype):
    """Combine per-rate scalers of two nodes into (site_min, undo_factor).

    Returns (site_scalings [..., T] int32, undo [..., R, T] multiplicative
    factor); leading axes are batch axes.
    """
    total = scaler_p + scaler_c                             # [..., R, T]
    site_scalings = torch.min(total, dim=-2).values         # [..., T]
    rel = torch.clamp(total - site_scalings[..., None, :],
                      max=SCALE_RATE_MAXDIFF)
    undo = torch.pow(torch.full((), cfg.scale_threshold, dtype=dtype,
                                device=rel.device),
                     rel.to(dtype))                         # rel=0 -> 1
    return site_scalings, undo


def _invariant_site_lk(freqs, invariant):
    """pi[inv_state] per (rate, site); 0 where the site is variant.

    freqs: [..., R, S]; invariant: [..., T] int (-1 = variant); leading
    axes are batch axes (one set of frequencies each).
    """
    idx = torch.clamp(invariant, min=0).long()[..., None, :]   # [..., 1, T]
    vals = torch.gather(freqs, -1, idx.expand(
        *freqs.shape[:-1], idx.shape[-1]))                     # [..., R, T]
    return torch.where(invariant[..., None, :] >= 0, vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def _edge_terms(terma_r, scaler_p, scaler_c, inv_lk, prop_invar,
                rate_weights, cfg: PartitionConfig):
    """(terma, terminv, site_scalings) [..., T] of the edge terms terma_r
    [..., R, T]: the scaler undo, the variant part weighted by (1 - p) and
    the rate weights, the invariant part (inv_lk [..., R, T]) by p and the
    rate weights apart, and the sites' scaler counts.  prop_invar and
    rate_weights are [R] or, per batch entry, [..., R]."""
    dtype = terma_r.dtype
    if cfg.per_rate_scalers:
        site_scalings, undo = _per_rate_undo(scaler_p, scaler_c, cfg, dtype)
        terma_r = terma_r * undo
    else:
        site_scalings = scaler_p + scaler_c
    pinv = prop_invar.to(dtype)
    rw = rate_weights.to(dtype)
    terma = torch.einsum("...rt,...r->...t",
                         terma_r * (1.0 - pinv)[..., None], rw)
    terminv = torch.einsum("...rt,...r->...t", inv_lk * pinv[..., None], rw)
    return terma, terminv, site_scalings


def root_loglikelihood(clv,              # [..., R, S, T]
                       scaler,           # [..., T] int32 or [..., R, T]
                       freqs,            # [R, S]
                       rate_weights,     # [R]
                       prop_invar,       # [R]
                       invariant,        # [T] int, -1 = variant
                       pattern_weights,  # [T] (0 on padding)
                       cfg: PartitionConfig,
                       with_persite: bool = False,
                       group=None):
    """Weighted log-likelihood at a (virtual) root CLV
    (pll_core_root_loglikelihood, core_likelihood.c:25-209).  Per-rate
    scalers use the edge kernel's min+cap protocol.  Leading axes of clv
    and scaler are batch axes (one logL each), e.g. candidate edges.
    `group`: the process group the sites are sharded over (None: not
    sharded)."""
    # bf16 is a CLV storage format: the reduction runs in f32 (a bf16 sum
    # would quantize the total logL itself)
    dtype = _acc_dtype(clv)
    term_r = torch.einsum("...rst,rs->...rt", clv.to(dtype), freqs.to(dtype))

    if cfg.per_rate_scalers:
        site_scalings, undo = _per_rate_undo(
            scaler, torch.zeros_like(scaler), cfg, dtype)
        term_r = term_r * undo
    else:
        site_scalings = scaler                                    # [T]

    pinv = prop_invar.to(dtype)                                   # [R]
    inv_lk = _invariant_site_lk(freqs.to(dtype), invariant)       # [R, T]
    mixed = term_r * (1.0 - pinv)[:, None] + inv_lk * pinv[:, None]
    term_r = torch.where((pinv > 0)[:, None], mixed, term_r)

    term = torch.einsum("...rt,r->...t", term_r, rate_weights.to(dtype))

    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        # phantom per-state sites feed the correction, not the main sum
        live = live & _site_mask(cfg, live.device)
    one = torch.ones((), dtype=dtype, device=term.device)
    site_lk = torch.log(torch.where(live, term, one))
    site_lk = site_lk + site_scalings.to(dtype) * cfg.log_scale_threshold
    site_lk = torch.where(live, site_lk * pattern_weights.to(dtype),
                          torch.zeros_like(site_lk))

    logl = _reduce_logl(torch.sum(site_lk, dim=-1), term, site_scalings,
                        pattern_weights, cfg, dtype, group)
    if with_persite:
        return logl, site_lk
    return logl


def edge_loglikelihood(clvp,             # [R, S, T] parent CLV
                       scaler_p,         # [T] or [R, T] int32
                       clvc,             # [R, S, T] child CLV
                       scaler_c,         # [T] or [R, T] int32
                       pmat,             # [R, S, S] P-matrix of the edge
                       freqs,            # [R, S]
                       rate_weights,     # [R]
                       prop_invar,       # [R]
                       invariant,        # [T] int
                       pattern_weights,  # [T]
                       cfg: PartitionConfig,
                       with_persite: bool = False,
                       group=None):
    """Log-likelihood across an edge: parent CLV . P(t) . child CLV
    (pll_core_edge_loglikelihood_ii, core_likelihood.c:1191-1496).
    `group`: the process group the sites are sharded over (None: not
    sharded)."""
    with spans.span("root"):
        dtype = _acc_dtype(clvp)                # bf16 CLVs: f32 sums
        termb = torch.einsum("rjk,rkt->rjt", pmat.to(dtype),
                             clvc.to(dtype))
        terma_r = torch.einsum("rjt,rj,rjt->rt", clvp.to(dtype),
                               freqs.to(dtype), termb)            # [R, T]
        return edge_reduce(terma_r, scaler_p, scaler_c, freqs, rate_weights,
                           prop_invar, invariant, pattern_weights, cfg,
                           with_persite=with_persite, group=group)


def edge_reduce(terma_r,          # [..., R, T] pre-log edge terms
                scaler_p,         # [..., T] or [..., R, T] int32
                scaler_c,         # [..., T] or [..., R, T] int32
                freqs,            # [R, S]
                rate_weights,     # [R]
                prop_invar,       # [R]
                invariant,        # [T] int
                pattern_weights,  # [T]
                cfg: PartitionConfig,
                with_persite: bool = False,
                group=None):
    """Reduction tail of edge_loglikelihood from the per-(rate, site) edge
    terms sum_ij pi_i . clvp_i . P_ij . clvc_j (at the CLVs' stored
    scaling): scaler undo, +I mixing and asc-bias corrections.  Leading
    axes of terma_r and the scalers are batch axes (one logL each), e.g.
    the edges of the analytic reverse pass.  `group`: as in
    edge_loglikelihood."""
    dtype = terma_r.dtype
    inv_lk = _invariant_site_lk(freqs.to(dtype), invariant)       # [R, T]
    terma, terminv, site_scalings = _edge_terms(
        terma_r, scaler_p, scaler_c, inv_lk, prop_invar, rate_weights, cfg)

    live = pattern_weights > 0
    if cfg.asc_bias != AB_NONE:
        live = live & _site_mask(cfg, live.device)
    site_lk = _site_logl(terma, terminv, site_scalings, live,
                         pattern_weights, cfg, dtype)
    # pinv is disallowed with asc bias, so terma+terminv == raw term
    term = terma + terminv if cfg.asc_bias != AB_NONE else None
    logl = _reduce_logl(torch.sum(site_lk, dim=-1), term, site_scalings,
                        pattern_weights, cfg, dtype, group)
    if with_persite:
        return logl, site_lk
    return logl


def _site_logl(terma, terminv, site_scalings, live, pattern_weights,
               cfg: PartitionConfig, dtype):
    """Weighted per-site logL from the variant and invariant edge terms
    and the per-site scaler counts, 0 where `live` is False; three cases
    (core_likelihood.c:1462-1481)."""
    log_thresh = cfg.log_scale_threshold
    scal = site_scalings.to(dtype)
    capped = torch.clamp(site_scalings, max=SCALE_RATE_MAXDIFF).to(dtype)
    cap_factor = torch.exp(capped * log_thresh)     # thresh^capped
    has_scal = site_scalings > 0
    has_inv = terminv > 0.0

    # each case's argument is 1 wherever the case is not taken, so that
    # the logarithm of a case not taken (terma * cap_factor underflows to
    # 0 at f32 once a site was rescued five times) is finite and its
    # gradient 0 rather than 0 * inf
    one = torch.ones((), dtype=dtype, device=terma.device)
    plain = torch.where(live & ~has_scal, terma + terminv, one)
    scaled_inv = torch.where(live & has_scal & has_inv,
                             terma * cap_factor + terminv, one)
    scaled_plain = torch.where(live & has_scal & ~has_inv, terma, one)

    site_lk = torch.where(
        has_scal,
        torch.where(has_inv,
                    torch.log(scaled_inv),
                    torch.log(scaled_plain) + scal * log_thresh),
        torch.log(plain))
    return torch.where(live, site_lk * pattern_weights.to(dtype),
                       torch.zeros_like(site_lk))


def segment_sums(values, segment_blocks):
    """Sums of `values` [N] over each row of segment_blocks [n, B] (block
    indices, N where a segment has fewer than B blocks): [n], in the order
    of the rows, with no atomics, so the same on every run."""
    padded = torch.cat([values, values.new_zeros(1)])
    return padded[segment_blocks].sum(dim=1)


def edge_loglikelihood_blocks(clvp,            # [N, R, S, TB] parent CLV
                              scaler_p,        # [N, TB] or [N, R, TB]
                              clvc,            # [N, R, S, TB] child CLV
                              scaler_c,        # [N, TB] or [N, R, TB]
                              pmat,            # [n, R, S, S]
                              freqs,           # [n, R, S]
                              rate_weights,    # [n, R]
                              prop_invar,      # [n, R]
                              invariant,       # [N, TB] int
                              pattern_weights,  # [N, TB]
                              block_segment,   # [N] int64
                              segment_blocks,  # [n, B] int64
                              cfg: PartitionConfig,
                              real=None,       # [N, TB] bool
                              phantom=None):   # [N, TB] bool
    """edge_loglikelihood of n segments at once, each with its own edge
    P-matrix, frequencies, rate weights and p-inv: the site axis cut into
    N blocks of TB columns, block i of segment block_segment[i], and
    segment_blocks its inverse (segment_sums).  Segments are partitions
    that share the states, rate categories, dtype, scaler mode and
    asc-bias mode of `cfg` (multipartition.py).  Under asc bias `real` and
    `phantom` mark each block's real and phantom columns, and each segment
    gets the correction of its own phantom columns.  Returns [n] f64: the
    weighted site sums, summed in f64, plus each segment's correction."""
    with spans.span("root"):
        dtype = _acc_dtype(clvp)
        seg = block_segment
        termb = torch.einsum("nrjk,nrkt->nrjt", pmat.to(dtype)[seg],
                             clvc.to(dtype))
        fq = freqs.to(dtype)[seg]                                 # [N, R, S]
        terma_r = torch.einsum("nrjt,nrj,nrjt->nrt", clvp.to(dtype), fq,
                               termb)                             # [N, R, TB]
        inv_lk = _invariant_site_lk(fq, invariant)                # [N, R, TB]
        terma, terminv, site_scalings = _edge_terms(
            terma_r, scaler_p, scaler_c, inv_lk, prop_invar.to(dtype)[seg],
            rate_weights.to(dtype)[seg], cfg)

        asc = cfg.asc_bias != AB_NONE
        live = pattern_weights > 0
        if asc:
            live = live & real
        site_lk = _site_logl(terma, terminv, site_scalings, live,
                             pattern_weights, cfg, dtype)
        logl = segment_sums(site_lk.double().sum(dim=-1), segment_blocks)
        if not asc:
            return logl

        def total(x):                  # [N, TB], over phantom columns
            x = torch.where(phantom, x.double(), 0.0)
            return segment_sums(x.sum(dim=-1), segment_blocks)

        def real_weight():
            w = torch.where(real, pattern_weights.double(), 0.0)
            return segment_sums(w.sum(dim=-1), segment_blocks)

        # pinv is disallowed with asc bias, so terma + terminv is the term
        term = torch.where(phantom, terma + terminv, 1.0)
        parts = _asc_sums(term, site_scalings.to(dtype),
                          pattern_weights.to(dtype), total, real_weight, cfg)
        return logl + _asc_finish(parts, cfg)


def node_ancestral(clv_node,         # [R, S, T] CLV toward the edge
                   scaler_node,      # [T] / [R, T] int32
                   clv_other,        # [R, S, T] CLV of the other direction
                   scaler_other,     # [T] / [R, T] int32
                   pmat,             # [R, S, S] P-matrix across the edge
                   freqs,            # [R, S]
                   rate_weights,     # [R]
                   cfg: PartitionConfig):
    """Marginal ancestral state probabilities at a node, [T, S].

    pll_compute_node_ancestral (likelihood.c:639-823): the node's own CLV
    passes through an identity P-matrix, the other direction through
    `pmat`; then anc[t, j] is proportional to
    sum_r rw_r * pi_{r,j} * combined[r, j, t], normalized over states.
    Per-site scalers cancel in the normalization; per-rate scalers are
    undone (capped at SCALE_RATE_MAXDIFF) before the rate sum.  Padding
    sites, normalized against a sum of 0, are clamped to 0.
    """
    dtype = cfg.dtype
    combined = clv_node * torch.einsum("rij,rjt->rit", pmat.to(dtype),
                                       clv_other)
    if cfg.per_rate_scalers:
        _, undo = _per_rate_undo(scaler_node, scaler_other, cfg, dtype)
        combined = combined * undo[:, None, :]
    weighted = torch.einsum("r,rs,rst->ts", rate_weights.to(dtype),
                            freqs.to(dtype), combined)
    total = torch.sum(weighted, dim=1, keepdim=True)
    positive = total > 0
    return torch.where(positive,
                       weighted / torch.where(positive, total,
                                              torch.ones_like(total)),
                       torch.zeros_like(weighted))
