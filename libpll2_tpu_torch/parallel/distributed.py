"""Multi-process runtime: process-group bring-up, the global site mesh
and the placement of site-indexed inputs.

Counterpart of libpll2_tpu/parallel/distributed.py.  `initialize()`
brings up a torch.distributed process group (one process per GPU, or
several processes sharing one GPU over gloo), `global_site_mesh()` spans
its ranks with the 'sites' axis, and `make_global_site_array()` gives
each rank its slice of a site-indexed array.  PyTorch has no global
array: what a jax.Array would hold across hosts is here the slices the
ranks hold, and the engine's site sums all-reduce over the group
(parallel/sharding.py).  A single process, with no group, runs the same
code and reduces nothing.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .sharding import SiteMesh, make_mesh, site_sharding

# A collective that waits longer than this for a peer fails instead of
# hanging (a rank that died or was never started).
GROUP_TIMEOUT_S = 120


def _backend(num_processes: int, local_device_ids=None) -> tuple:
    """(backend, reason): NCCL where every process has a GPU of its own
    (the caller names this process's cards, or this host has at least one
    card a process), gloo otherwise: on CPUs, and for processes that share
    a GPU, where NCCL refuses two ranks on one device.  Gloo all-reduces
    CUDA tensors through the host."""
    if not torch.cuda.is_available():
        return "gloo", "no CUDA device"
    count = torch.cuda.device_count()
    if not dist.is_nccl_available():
        return "gloo", "this torch has no NCCL"
    if local_device_ids is not None:
        return "nccl", f"this process's cards are {list(local_device_ids)}"
    if count >= num_processes:
        return "nccl", f"{count} GPUs for {num_processes} processes"
    return "gloo", (f"{num_processes} processes share {count} GPU(s); NCCL "
                    f"refuses two ranks on one GPU")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> int:
    """Bring up the default process group; returns the process count.

    `coordinator_address`: "host:port" (TCP), or an init method URL such
    as "file:///path" (a FileStore) or "tcp://host:port"; with it
    `num_processes` and `process_id` are required.  With no argument the
    launcher's environment is read (torchrun's WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT); without that, one process stays alone and
    1 is returned with no group.  Idempotent: a second call returns the
    existing group's size.  The backend is chosen by `_backend` and
    printed; this rank's card (local_device_ids[0], else rank mod the
    card count) becomes the current CUDA device."""
    if dist.is_initialized():
        return dist.get_world_size()
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return 1
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif any(x is None for x in given):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend, reason = _backend(num_processes, local_device_ids)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device_ids[0] if local_device_ids
                              else process_id % torch.cuda.device_count())
    print(f"[parallel] rank {process_id} of {num_processes}: backend "
          f"{backend} ({reason})", flush=True)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.get_world_size()


def global_site_mesh(devices: Optional[Sequence] = None) -> SiteMesh:
    """1-D 'sites' mesh over every rank of every process (make_mesh)."""
    return make_mesh(devices)


def make_global_site_array(mesh: SiteMesh, global_array) -> torch.Tensor:
    """This rank's slice of `global_array`'s site axis (innermost), on the
    rank's device: each process materializes only its own part of the
    host copy, as a jax.Array's addressable shards."""
    ndim = global_array.ndim if isinstance(global_array, torch.Tensor) \
        else np.ndim(global_array)
    return site_sharding(mesh, ndim).local(global_array)


def shard_engine_inputs(mesh: SiteMesh, tipchars, pattern_weights,
                        invariant):
    """This rank's slices of the engine's site-indexed inputs; the model,
    tree program and branch lengths stay replicated (tiny)."""
    return (make_global_site_array(mesh, tipchars),
            make_global_site_array(mesh, pattern_weights),
            make_global_site_array(mesh, invariant))


def process_site_slice(cfg_sites_padded: int, mesh: SiteMesh) -> slice:
    """The half-open site range this process owns under the 1-D mesh."""
    per = cfg_sites_padded // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)
