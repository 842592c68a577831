"""Site repeats — per-node identical-subtree-column classes (C7).

Reference semantics (libpll-2 src/repeats.c):

  * tip classes from character/state identity in first-occurrence order
    (pll_update_repeats_tips, repeats.c:189-254; chars with equal map
    values share a class, repeats_fill_charmap :28-45);
  * inner-node classes: unique (left_class, right_class) pairs hashed
    through a flat lookup of capacity 2,000,000
    (pll_update_repeats, :299-382; PLL_REPEATS_LOOKUP_SIZE pll.h:135);
  * heuristic gate: repeats used only when both children have classes,
    ids_left*ids_right < lookup capacity, and each child has <= sites/2
    classes (pll_default_enable_repeats, :100-110); a parent whose class
    count reaches the site count degenerates to dense (:366-370);
  * CLVs/scalers of a class-indexed node store one entry per class;
    consumers expand through site_id.  Computed values are bit-identical
    to the dense path — that invariant is the test.

Counterpart of libpll2_tpu/repeats.py (host numpy; the tables equal the
JAX package's entry for entry).  CLVs keep their [R, S, T] shape (class
slots in the leading positions, capacity = padded sites).  The class
structure is computed on the host (numpy hashing per operation) and
compiled into per-operation gather index arrays [T] over the site axis;
the level-batched CLV update becomes the dense update plus one gather per
child (ops/partials.py).  Expansion back to site-indexed rows is a single
gather at the consumers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .constants import SCALE_BUFFER_NONE

REPEATS_LOOKUP_SIZE = 2000000  # PLL_REPEATS_LOOKUP_SIZE (pll.h:135)
MIN_SITES = 16                 # repeats auto-disabled below (pll.c:446-449)


def first_occurrence_classes(keys: np.ndarray):
    """Map keys -> class ids in order of first occurrence.

    Returns (site_id [n] int32, id_site [ids] int32, ids)."""
    _, first_idx, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")      # sorted-id -> rank
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    site_id = rank[inverse].astype(np.int32)
    id_site = first_idx[order].astype(np.int32)
    return site_id, id_site, order.size


class Repeats:
    """Host-side class structure (mirrors pll_repeats_t, pll.h:290-321)."""

    def __init__(self, nodes: int, scale_buffers: int, sites: int,
                 additional_sites: int,
                 lookup_size: int = REPEATS_LOOKUP_SIZE):
        self.sites = sites
        self.additional_sites = additional_sites
        self.lookup_size = lookup_size
        sa = sites + additional_sites
        ident = np.arange(sa, dtype=np.int32)
        self.pernode_site_id = np.tile(ident, (nodes, 1))
        self.pernode_id_site = np.tile(ident, (nodes, 1))
        self.pernode_ids = np.zeros(nodes, dtype=np.int32)
        self.perscale_ids = np.zeros(scale_buffers, dtype=np.int32)
        self.perscale_node: Dict[int, int] = {}

    # --- queries (repeats.c:63-98) -----------------------------------------

    def sites_number(self, clv_index: int) -> int:
        ids = int(self.pernode_ids[clv_index])
        return (ids if ids else self.sites) + self.additional_sites

    def site_id(self, clv_index: int) -> Optional[np.ndarray]:
        if self.pernode_ids[clv_index]:
            return self.pernode_site_id[clv_index]
        return None

    def id_site(self, clv_index: int) -> Optional[np.ndarray]:
        if self.pernode_ids[clv_index]:
            return self.pernode_id_site[
                clv_index, :self.sites_number(clv_index)]
        return None

    # --- updates -----------------------------------------------------------

    def update_tip(self, tip_index: int, codes: np.ndarray) -> None:
        """Tip classes from state identity (repeats.c:189-254)."""
        site_id, id_site, ids = first_occurrence_classes(codes[:self.sites])
        self.pernode_site_id[tip_index, :self.sites] = site_id
        self.pernode_id_site[tip_index, :id_site.size] = id_site
        for s in range(self.additional_sites):
            self.pernode_site_id[tip_index, self.sites + s] = ids + s
            self.pernode_id_site[tip_index, ids + s] = self.sites + s
        self.pernode_ids[tip_index] = ids

    def enable(self, left: int, right: int) -> bool:
        """pll_default_enable_repeats (repeats.c:100-110)."""
        il = int(self.pernode_ids[left])
        ir = int(self.pernode_ids[right])
        return not (il * ir == 0 or self.lookup_size <= il * ir
                    or il > self.sites // 2 or ir > self.sites // 2)

    def update(self, parent: int, left: int, right: int,
               parent_scaler: int) -> None:
        """Parent classes from child class pairs (repeats.c:299-382)."""
        if not self.enable(left, right):
            ids = 0
        else:
            keys = (self.pernode_site_id[left, :self.sites].astype(np.int64)
                    + self.pernode_site_id[right, :self.sites]
                    .astype(np.int64)
                    * int(self.pernode_ids[left]))
            site_id, id_site, ids = first_occurrence_classes(keys)
            if ids >= self.sites:
                ids = 0          # no benefit: degenerate to dense (:366-370)
            else:
                self.pernode_site_id[parent, :self.sites] = site_id
                self.pernode_id_site[parent, :ids] = id_site
                for s in range(self.additional_sites):
                    self.pernode_site_id[parent, self.sites + s] = ids + s
                    self.pernode_id_site[parent, ids + s] = self.sites + s
        if ids == 0:
            sa = self.sites + self.additional_sites
            self.pernode_site_id[parent] = np.arange(sa, dtype=np.int32)
            self.pernode_id_site[parent] = np.arange(sa, dtype=np.int32)
        self.pernode_ids[parent] = ids
        if parent_scaler != SCALE_BUFFER_NONE:
            self.perscale_ids[parent_scaler] = ids
            self.perscale_node[parent_scaler] = parent

    # --- gather compilation -----------------------------------------------

    def child_gather(self, parent: int, child: int, padded: int
                     ) -> np.ndarray:
        """Index array g [padded]: child CLV slot feeding each parent slot.

        parent slot t (class rep site r = id_site[parent][t], identity when
        dense) reads child slot site_id[child][r] (identity when the child
        is dense).  Pad slots gather 0 — computed but never consumed."""
        sa = self.sites + self.additional_sites
        g = np.zeros(padded, dtype=np.int32)
        reps = self.pernode_id_site[parent, :sa]
        g[:sa] = self.pernode_site_id[child, reps]
        return g

    def expand_gather(self, clv_index: int, padded: int) -> np.ndarray:
        """Index array mapping site-indexed positions to class slots."""
        sa = self.sites + self.additional_sites
        g = np.zeros(padded, dtype=np.int32)
        g[:sa] = self.pernode_site_id[clv_index, :sa]
        return g
