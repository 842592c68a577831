"""Static partition configuration (hashable; one per alignment partition).

Counterpart of libpll2_tpu/config.py with torch dtypes.  libpll-2's
pll_partition_t (pll.h:241-288) splits into two halves here as well:

  * PartitionConfig — static shape/mode information fixed at creation;
  * tensors (engine.Model buffers, CLVs, scalers) — everything numeric.

Sites are padded to a multiple of `site_block` so the site axis divides
into the CUDA sweep's site blocks; padding columns carry pattern_weight 0
and never contribute to results.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .constants import AB_NONE


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Mirror of pll_partition_create's static arguments (pll.c:424-868)."""
    tips: int
    clv_buffers: int
    states: int
    sites: int
    rate_matrices: int
    prob_matrices: int
    rate_cats: int
    scale_buffers: int
    per_rate_scalers: bool = False
    # PATTERN_TIP (pll.h:124): the engine always keeps tips as packed
    # state bitmasks and expands them on the fly; the flag is accepted for
    # API parity and does not change the layout.
    pattern_tip: bool = False
    site_repeats: bool = False
    asc_bias: int = AB_NONE
    asc_bias_flag: bool = False  # apply correction during logL computation
    dtype: torch.dtype = torch.float64
    site_block: int = 128
    # None: the CUDA kernels for CUDA tensors — the tree sweep (f32 or bf16
    # CLV storage; a case it cannot take, f64 among them, runs the dense
    # path on the card with a warning) and the search's edge scorer (where
    # its contract holds, else the plain scorer) — and the plain paths for
    # CPU tensors.
    # True: the kernels or raise (their plain versions on CPU tensors).
    # False: the plain paths (ops/partials.py, the plain scorer).
    use_kernel: Optional[bool] = None
    # Form of the tree-sweep kernel: None lets ops/partials_tree.choose pick
    # by op count; "fma" or "mma" forces one (a case it cannot take raises
    # under use_kernel=True and runs the dense path, warned, under None).
    sweep_mode: Optional[str] = None

    def __post_init__(self):
        # the reference refuses the combination at partition creation; the
        # JAX engine's _asc_scalers would drop the asc scalers silently
        if self.per_rate_scalers and self.asc_bias != AB_NONE:
            raise ValueError("per-rate scalers cannot combine with "
                             "ascertainment bias correction")

    @property
    def num_clvs(self) -> int:
        return self.tips + self.clv_buffers

    @property
    def sites_alloc(self) -> int:
        """True sites plus asc-bias phantom sites (pll.c:525-531)."""
        if self.asc_bias != AB_NONE:
            return self.sites + self.states
        return self.sites

    @property
    def sites_padded(self) -> int:
        return round_up(self.sites_alloc, self.site_block)

    @property
    def span(self) -> int:
        return self.states * self.rate_cats

    # --- reserved array rows -------------------------------------------------
    # CLV row layout:    [0, num_clvs) real, num_clvs = scratch (dummy writes).
    # Scaler row layout: [0, scale_buffers) real, scale_buffers = always-zero
    #                    (reads for SCALE_BUFFER_NONE), scale_buffers+1 =
    #                    scratch (dummy writes).
    @property
    def clv_scratch(self) -> int:
        return self.num_clvs

    @property
    def scaler_zero(self) -> int:
        return self.scale_buffers

    @property
    def scaler_scratch(self) -> int:
        return self.scale_buffers + 1

    @property
    def scale_threshold(self) -> float:
        """Underflow-rescue threshold; dtype-dependent.

        f64 matches the reference exactly (2^-256, pll.h:96-99).  f32 cannot
        represent 2^-256; it uses 2^-30 so that a product of two rescued
        CLVs (root-edge logL, core_likelihood.c:1191+) stays >= 2^-60,
        inside the f32 normal range.  Same rule as libpll2_tpu, so scaler
        rows compare exactly between the two packages.
        """
        if self.dtype == torch.float64:
            return 2.0 ** -256
        return 2.0 ** -30

    @property
    def scale_factor(self) -> float:
        if self.dtype == torch.float64:
            return 2.0 ** 256
        return 2.0 ** 30

    @property
    def log_scale_threshold(self) -> float:
        return math.log(self.scale_threshold)


@dataclasses.dataclass(frozen=True)
class SiteSlice(PartitionConfig):
    """One rank's slice of a partition whose site axis is sharded
    (parallel/): the padded columns [slice_start, slice_start +
    slice_width).  `sites` and `sites_alloc` stay the whole partition's;
    `sites_padded` is the slice's width, so every tensor the engine makes
    has the slice's shape, and `site_columns` gives the masks each local
    column's global index (the asc-bias phantom columns [sites, sites +
    states) may lie in any slice, or straddle two).
    parallel.sharding.local_config builds one."""
    slice_start: int = 0
    slice_width: int = 0

    @property
    def sites_padded(self) -> int:
        return self.slice_width


def site_columns(cfg: PartitionConfig) -> np.ndarray:
    """Global index of each site column `cfg` holds: [sites_padded]."""
    start = cfg.slice_start if isinstance(cfg, SiteSlice) else 0
    return np.arange(start, start + cfg.sites_padded)


def phantom_columns(cfg: PartitionConfig) -> slice:
    """The local columns of the asc-bias phantom sites [sites, sites +
    states) that `cfg` holds (empty where its slice has none)."""
    start = cfg.slice_start if isinstance(cfg, SiteSlice) else 0
    lo, hi = cfg.sites - start, cfg.sites + cfg.states - start
    return slice(min(max(lo, 0), cfg.sites_padded),
                 min(max(hi, 0), cfg.sites_padded))
