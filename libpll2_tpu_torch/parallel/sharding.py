"""Multi-GPU execution: shard alignment sites across the ranks of a
process group.

Counterpart of libpll2_tpu/parallel/sharding.py.  The reference library is
single-threaded; its clients (RAxML-NG) scale by giving each MPI rank a
site slice and all-reducing per-site logL / derivative sums (SURVEY.md
§2.6).  The JAX package runs one program over a device mesh and XLA
inserts the psums.  PyTorch inserts nothing: here each rank is a process
that runs the single-device engine on its contiguous slice of the site
axis (innermost on every site-indexed tensor), and every weighted site sum
is all-reduced over the group by the engine itself (the `group=` argument
of ops/likelihood.py, ops/derivatives.py, engine.py and
search_fast._spr_round_device).  The tree program, P-matrices and model
are replicated: every rank builds them.

Because log-likelihood and (d1, d2) are exact per-site weighted sums, site
sharding changes nothing numerically (up to reduction order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import PartitionConfig, SiteSlice

SITES_AXIS = "sites"


@dataclasses.dataclass(frozen=True)
class SiteMesh:
    """1-D 'sites' mesh over the ranks of a process group: the group
    (None for one process, which reduces nothing), this process's rank,
    the number of ranks and this rank's device."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class SiteSharding:
    """How a tensor lies on a SiteMesh: `spec` names, per tensor axis, the
    mesh axis it is split over, as jax's PartitionSpec does (an axis it
    does not name is whole on every rank)."""
    mesh: SiteMesh
    spec: tuple

    def local(self, array) -> torch.Tensor:
        """This rank's part of `array` (numpy array or tensor), on the
        mesh's device: a contiguous slice of each split axis."""
        t = array if isinstance(array, torch.Tensor) \
            else torch.as_tensor(np.asarray(array))
        for axis, name in enumerate(self.spec):
            if name != SITES_AXIS:
                continue
            n, size = t.shape[axis], self.mesh.size
            if n % size:
                raise ValueError(
                    f"axis {axis} of {n} sites does not split into {size} "
                    f"equal slices (pad with pad_sites_to_mesh)")
            t = t.narrow(axis, self.mesh.rank * (n // size), n // size)
        return t.to(self.mesh.device).contiguous()


def make_mesh(devices: Optional[Sequence] = None) -> SiteMesh:
    """1-D mesh, axis name 'sites', over the ranks of the default process
    group (parallel.initialize), or over this one process without one.

    `devices`: one device per rank in rank order, of which this rank takes
    its own; None takes the card parallel.initialize chose for this rank
    (the current CUDA device), and raises where there is none.  Unlike a
    jax Mesh, a rank sees only its own device."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = (dist.group.WORLD, dist.get_rank(),
                             dist.get_world_size())
    else:
        group, rank, size = None, 0, 1
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(['cpu'] * ranks) for a CPU mesh")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = torch.device(devices[rank])
    return SiteMesh(group, rank, size, device)


def site_sharding(mesh: SiteMesh, ndim: int) -> SiteSharding:
    """Sharding that splits the innermost (site) axis of an ndim tensor."""
    return SiteSharding(mesh, (None,) * (ndim - 1) + (SITES_AXIS,))


def replicated(mesh: SiteMesh) -> SiteSharding:
    """Sharding that keeps a tensor whole on every rank."""
    return SiteSharding(mesh, ())


def shard_site_arrays(mesh: SiteMesh, *arrays):
    """This rank's slice of each array's innermost (site) axis, on the
    rank's device (one tensor for one array, else a tuple)."""
    out = tuple(site_sharding(mesh, a.ndim if isinstance(a, torch.Tensor)
                              else np.ndim(a)).local(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def pad_sites_to_mesh(cfg_site_block: int, n_devices: int) -> int:
    """Site padding granularity so each shard keeps whole site blocks."""
    return cfg_site_block * n_devices


def local_config(cfg: PartitionConfig, group) -> PartitionConfig:
    """The SiteSlice of `cfg` that this rank of `group` holds: the padded
    site axis in equal contiguous slices, in rank order.  `cfg` itself
    where `group` is None or `cfg` is already a slice."""
    if group is None or isinstance(cfg, SiteSlice):
        return cfg
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if cfg.sites_padded % size:
        raise ValueError(
            f"{cfg.sites_padded} padded sites do not split into {size} "
            f"equal slices (site_block = pad_sites_to_mesh(block, {size}))")
    width = cfg.sites_padded // size
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(PartitionConfig)}
    return SiteSlice(**fields, slice_start=rank * width, slice_width=width)


def check_slice(cfg: PartitionConfig, tipchars) -> None:
    """Raise unless `tipchars` has the width of `cfg`'s site slice."""
    if tipchars.shape[-1] != cfg.sites_padded:
        raise ValueError(
            f"site-indexed inputs hold {tipchars.shape[-1]} columns, this "
            f"rank's slice has {cfg.sites_padded} (shard them with "
            f"parallel.shard_engine_inputs)")
