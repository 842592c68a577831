"""Checkpoint / resume for long-running optimizations.

Counterpart of libpll2_tpu/utils/checkpoint.py.  The reference has no
checkpointing (SURVEY.md §6: clients persist their own state; the
library's only serialization is newick export).  The natural unit of
persisted state is a tree of tensors — fit.FitParams, optimizer state,
branch-length vectors — saved as one .npz of its leaves (depth-first
order) beside a JSON record of its structure.  `restore` takes the
structure, the dtypes and the device from a `like` value, so a checkpoint
written on the card restores on the CPU and back.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch


def _children(node):
    """(children, rebuild) of a container, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([getattr(node, n) for n in names],
                lambda xs: dataclasses.replace(node, **dict(zip(names, xs))))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda xs: type(node)(*xs)
    if isinstance(node, (tuple, list)):
        return list(node), lambda xs: type(node)(xs)
    if isinstance(node, dict):
        keys = list(node)
        return ([node[k] for k in keys],
                lambda xs: type(node)(zip(keys, xs)))
    return None


def _flatten(node) -> list:
    split = _children(node)
    if split is None:
        return [node]
    return [leaf for child in split[0] for leaf in _flatten(child)]


def _unflatten(like, leaves):
    split = _children(like)
    if split is None:
        return next(leaves)
    children, rebuild = split
    return rebuild([_unflatten(c, leaves) for c in children])


def _structure(node):
    split = _children(node)
    if split is None:
        if isinstance(node, torch.Tensor):
            return {"tensor": str(node.dtype), "shape": list(node.shape)}
        arr = np.asarray(node)
        return {"array": str(arr.dtype), "shape": list(arr.shape)}
    return {"type": type(node).__name__,
            "children": [_structure(c) for c in split[0]]}


def _layout(record):
    """A structure record without its leaves' kinds and dtypes, which
    restore() takes from `like`: containers and shapes."""
    if "children" in record:
        return {"type": record["type"],
                "children": [_layout(c) for c in record["children"]]}
    return {"shape": record.get("shape")}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path, pytree) -> None:
    """Persist a tree of tensors (dataclass, named tuple, tuple, list or
    dict, nested) to the directory `path`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = _flatten(pytree)
    np.savez(path / "state.npz",
             **{f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)})
    (path / "structure.json").write_text(json.dumps(_structure(pytree)))


def restore(path, like):
    """Restore a tree saved by save(): `like` gives the structure, and each
    leaf's dtype and device (tensors come back as tensors on `like`'s
    device, other leaves as numpy arrays of `like`'s dtype).  A checkpoint
    whose containers or shapes differ from `like`'s raises ValueError."""
    path = Path(path)
    saved = json.loads((path / "structure.json").read_text())
    if _layout(saved) != _layout(_structure(like)):
        raise ValueError(f"checkpoint structure {_layout(saved)} differs "
                         f"from `like`'s {_layout(_structure(like))}")
    data = np.load(path / "state.npz")
    leaves_like = _flatten(like)
    leaves = []
    for i, ref in enumerate(leaves_like):
        value = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            leaves.append(torch.as_tensor(value).to(device=ref.device,
                                                    dtype=ref.dtype))
        else:
            leaves.append(np.asarray(value, np.asarray(ref).dtype))
    return _unflatten(like, iter(leaves))
