"""Carry state across from libpll2_tpu without importing it.

The JAX package's objects are read by attribute (duck-typed) and their
arrays are passed as numpy arrays, so this module needs neither jax nor
libpll2_tpu.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .engine import Model, TreeProgram


def model_arrays(model) -> dict[str, np.ndarray]:
    """The eight fields of a JAX `engine.Model` (or of a port Model) as
    numpy arrays."""
    out = {}
    for name in Model.FIELDS:
        value = getattr(model, name)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out


def model_from_jax(arrays: Mapping[str, np.ndarray], device="cpu") -> Model:
    """Build the port's Model from the JAX Model's eight fields given as
    numpy arrays (see model_arrays).  The eigenvectors are taken as they
    are, not decomposed again, so both packages price the same numbers."""
    missing = [f for f in Model.FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"model arrays lack {missing}")
    return Model(*(torch.as_tensor(np.array(arrays[f]), device=device)
                   for f in Model.FIELDS))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    return a == b


def program_mismatches(port: TreeProgram, ref) -> list[str]:
    """Fields in which a port TreeProgram differs from a JAX one (empty
    when they agree).  Arrays compare byte for byte, with shape and dtype;
    the tree-sweep schedule compares ops, pool size, exports and maps."""
    out = []
    for name in ("level_ops", "pmatrix_indices", "default_branch_lengths",
                 "root_clv", "root_scaler", "root_back_clv",
                 "root_back_scaler", "root_pmatrix", "tip_count",
                 "inner_count"):
        if not _same(getattr(port, name), getattr(ref, name)):
            out.append(name)
    a, b = port.vmem_prog, ref.vmem_prog
    if (a is None) != (b is None):
        out.append("vmem_prog")
    elif a is not None:
        for name in ("ops", "pool_size", "exports", "export_clv_map",
                     "export_scaler_map"):
            if not _same(getattr(a, name), getattr(b, name)):
                out.append(f"vmem_prog.{name}")
    return out
