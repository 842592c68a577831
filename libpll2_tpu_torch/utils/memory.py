"""Device-memory residency accounting and the max-sites-per-card table.

Counterpart of libpll2_tpu/utils/memory.py with torch dtypes.  The dense
paths (a `Partition`, the engine's level-batched path) keep one CLV slab
and the scaler rows; their lever is bf16 CLV storage (levels accumulate in
f32 and round the stored parent once, ops/partials.py).  The engine's
kernel path (csrc/tree_sweep.cu) keeps no inner CLV in device memory: its
residency is the packed tip bitmasks, the exported rows and the
P-matrices.  The card's memory comes from the caller (`hbm_bytes`), or
from `device_memory_bytes`.
"""
from __future__ import annotations

import torch

from ..config import PartitionConfig


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def device_memory_bytes(device="cuda") -> int:
    """Total memory of a CUDA device (raises where there is none)."""
    return torch.cuda.get_device_properties(torch.device(device)) \
        .total_memory


def dense_clv_bytes(cfg: PartitionConfig) -> int:
    """CLV residency of the dense paths: one [num_clvs+1, R, S, T] slab
    (pll_partition_t's per-node CLVs in one allocation) plus the scaler
    rows — what a `Partition` allocates for `clv` and `scalers`."""
    it = _itemsize(cfg.dtype)
    clv = (cfg.num_clvs + 1) * cfg.rate_cats * cfg.states \
        * cfg.sites_padded * it
    sr = cfg.rate_cats if cfg.per_rate_scalers else 1
    scal = (cfg.scale_buffers + 2) * sr * cfg.sites_padded * 4
    return clv + scal


def fast_path_bytes(cfg: PartitionConfig, n_exports: int = 2) -> int:
    """Device residency of engine.loglikelihood through the tree-sweep
    kernel: the packed tip bitmasks and their block-major copy
    (engine.block_tips), the exported rows and scalers the kernel writes,
    their site-major copies for the reduction, the f32 P-matrices and the
    O(T) reduction temporaries.  Inner CLVs live in shared memory only."""
    T = cfg.sites_padded
    sr = cfg.rate_cats if cfg.per_rate_scalers else 1
    tips = 2 * cfg.tips * T * 4                           # packed int32
    rows = 2 * n_exports * cfg.rate_cats * cfg.states * T * 4
    scal = n_exports * sr * T * 4
    pmat = cfg.prob_matrices * cfg.rate_cats * cfg.states ** 2 * 4
    reduction = 4 * T * 4                                 # site_lk etc.
    return tips + rows + scal + pmat + reduction


def max_sites(tips: int, states: int = 4, rate_cats: int = 4,
              dtype=torch.float32, fast_path: bool = True, *,
              hbm_bytes: int, reserve_fraction: float = 0.25) -> int:
    """Largest site count (a multiple of 128) whose residency fits
    `hbm_bytes` for a full binary tree on `tips` taxa, leaving
    `reserve_fraction` for workspace.

    fast_path=True: the tree-sweep kernel path (f32; per-site cost
    8·tips + O(R·S)); False: the dense CLV paths at `dtype` (per-site cost
    ~2·tips·R·S·itemsize), the JAX package's formula.
    """
    budget = int(hbm_bytes * (1.0 - reserve_fraction))
    if fast_path:
        per_site = tips * 8 + 2 * (2 * rate_cats * states * 4 + 4) + 16
        fixed = (2 * tips - 3) * rate_cats * states ** 2 * 4
    else:
        it = _itemsize(dtype)
        num_clvs = 2 * tips - 2 + 1                      # tips + inners + 1
        per_site = num_clvs * rate_cats * states * it + tips * 4 \
            + (tips + 1) * 4
        fixed = (2 * tips - 3) * rate_cats * states ** 2 * it
    sites = (budget - fixed) // per_site
    return max(0, (sites // 128) * 128)


def max_sites_table(hbm_bytes: int) -> str:
    """Markdown table of the max sites on one card of `hbm_bytes` across
    tree sizes and modes."""
    rows = ["| taxa | states | dense f64 | dense f32 | dense bf16 | "
            "kernel path (f32) |",
            "|---|---|---|---|---|---|"]
    for tips in (64, 256, 1024, 4096):
        for states in (4, 20):
            vals = [max_sites(tips, states, 4, dt, False,
                              hbm_bytes=hbm_bytes)
                    for dt in (torch.float64, torch.float32,
                               torch.bfloat16)]
            fast = max_sites(tips, states, 4, torch.float32, True,
                             hbm_bytes=hbm_bytes)
            rows.append(f"| {tips} | {states} | " +
                        " | ".join(f"{v:,}" for v in vals) +
                        f" | {fast:,} |")
    return "\n".join(rows)
