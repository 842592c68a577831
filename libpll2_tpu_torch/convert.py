"""Carry state across from libpll2_tpu without importing it: models, fit
parameters and partitions, and the comparison of compiled programs.

The JAX package's objects are read by attribute (duck-typed) and their
arrays are passed as numpy arrays, so this module needs neither jax nor
libpll2_tpu.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import PartitionConfig
from .engine import FullTreeProgram, Model, TreeProgram


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


def model_from_jax(arrays: Mapping[str, np.ndarray], device="cuda") -> Model:
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


def config_mismatches(port: PartitionConfig, ref) -> list[str]:
    """Fields in which a port PartitionConfig differs from a JAX one.
    dtypes compare by name; use_kernel and sweep_mode have no JAX
    counterpart."""
    out = []
    for f in dataclasses.fields(port):
        if f.name in ("use_kernel", "sweep_mode"):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "dtype":
            a, b = str(a).removeprefix("torch."), np.dtype(b).name
        if a != b:
            out.append(f.name)
    return out


def full_program_mismatches(port: FullTreeProgram, ref) -> list[str]:
    """Fields in which a port FullTreeProgram (engine.compile_tree_full)
    differs from a JAX one; arrays compare byte for byte."""
    out = [f"cfg_ext.{n}" for n in config_mismatches(port.cfg_ext,
                                                     ref.cfg_ext)]
    for f in dataclasses.fields(port):
        if f.name in ("cfg_ext", "_device"):     # _device: the port's cache
            continue
        if not _same(getattr(port, f.name), getattr(ref, f.name)):
            out.append(f.name)
    return out


def _color_masks_same(port: np.ndarray, ref: np.ndarray) -> bool:
    """The port keeps one mask per colour class; the JAX package keeps
    classes 0-3 only and never smooths a branch of a further colour.  The
    same: classes 0-3 equal, and the port's further classes partition
    exactly the branches the JAX masks leave out."""
    n = ref.shape[0]
    head = np.zeros_like(ref)
    head[:min(n, port.shape[0])] = port[:n]
    rest = port[n:]
    return (port.dtype == ref.dtype and port.shape[1:] == ref.shape[1:]
            and np.array_equal(head, ref)
            and np.array_equal(rest.sum(axis=0), ~ref.any(axis=0)))


def spr_program_mismatches(port, ref) -> list[str]:
    """Fields in which a port search_fast.SprProgram differs from a JAX
    one, ball groups included (arrays byte for byte, candidate sets by
    equality, the tree by its full-precision newick; colour masks by
    _color_masks_same)."""
    from .tree.utree import export_newick
    out = []
    for name in ("cfg", "cfg_ext"):
        out += [f"{name}.{n}" for n in config_mismatches(
            getattr(port, name), getattr(ref, name))]
    if export_newick(port.tree.vroot, precision=None) != \
            export_newick(ref.tree.vroot, precision=None):
        out.append("tree")
    for f in dataclasses.fields(port):
        if f.name in ("tree", "cfg", "cfg_ext", "ball_groups"):
            continue
        if f.name == "color_masks":
            if not _color_masks_same(port.color_masks, ref.color_masks):
                out.append(f.name)
            continue
        if not _same(getattr(port, f.name), getattr(ref, f.name)):
            out.append(f.name)
    a, b = port.ball_groups, ref.ball_groups
    if (a is None) != (b is None) or (a is not None and len(a) != len(b)):
        out.append("ball_groups")
    elif a is not None:
        for i, (ga, gb) in enumerate(zip(a, b)):
            for f in dataclasses.fields(ga):
                va, vb = getattr(ga, f.name), getattr(gb, f.name)
                if isinstance(va, tuple):
                    same = len(va) == len(vb) and all(
                        _same(x, y) for x, y in zip(va, vb))
                else:
                    same = _same(va, vb)
                if not same:
                    out.append(f"ball_groups[{i}].{f.name}")
    return out


def spr_programs_mismatches(ports, refs) -> list[str]:
    """spr_program_mismatches over the K programs of compile_spr_multi,
    each name prefixed by its partition."""
    if len(ports) != len(refs):
        return ["n_partitions"]
    return [f"[{k}].{name}" for k, (p, r) in enumerate(zip(ports, refs))
            for name in spr_program_mismatches(p, r)]


def multipartition_mismatches(port, ref) -> list[str]:
    """Fields in which a port multipartition.MultiPartition differs from a
    JAX one: programs, all-edge programs and configs per partition."""
    if port.n_partitions != ref.n_partitions:
        return ["n_partitions"]
    out = []
    for k in range(port.n_partitions):
        out += [f"programs[{k}].{n}" for n in program_mismatches(
            port.programs[k], ref.programs[k])]
        out += [f"fulls[{k}].{n}" for n in full_program_mismatches(
            port.fulls[k], ref.fulls[k])]
        out += [f"cfgs[{k}].{n}" for n in config_mismatches(
            port.cfgs[k], ref.cfgs[k])]
    return out


FIT_FIELDS = ("log_subst", "freq_logits", "log_branch", "log_alpha")


def fit_params_arrays(params) -> dict[str, np.ndarray]:
    """The four fields of a FitParams (JAX's or the port's) as numpy
    arrays."""
    out = {}
    for name in FIT_FIELDS:
        value = getattr(params, name)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out


def fit_params_from_jax(arrays: Mapping[str, np.ndarray], device="cuda"):
    """The port's fit.FitParams from a JAX FitParams' fields given as
    numpy arrays (see fit_params_arrays): the same unconstrained values."""
    from .fit import FitParams
    return FitParams(*(torch.as_tensor(np.array(arrays[f]), device=device)
                       for f in FIT_FIELDS))


PARTITION_FIELDS = ("clv", "scalers", "pmatrix", "frequencies",
                    "subst_params", "rates", "rate_weights", "prop_invar",
                    "pattern_weights", "eigenvals", "eigenvecs",
                    "inv_eigenvecs", "eigen_decomp_valid", "tipchars",
                    "tipchars_valid")
REPEATS_FIELDS = ("pernode_site_id", "pernode_id_site", "pernode_ids",
                  "perscale_ids")


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def partition_arrays(p) -> dict[str, np.ndarray]:
    """The state of a JAX `Partition` (or of a port one) as numpy arrays:
    PARTITION_FIELDS, `invariant` where it was computed, and the `Repeats`
    tables as `repeats_<field>` with `repeats_perscale_node` [scale
    buffers] (-1 where a scaler has no node)."""
    out = {name: _numpy(getattr(p, name)) for name in PARTITION_FIELDS}
    if p.invariant is not None:
        out["invariant"] = _numpy(p.invariant)
    if p.repeats is not None:
        for name in REPEATS_FIELDS:
            out[f"repeats_{name}"] = _numpy(getattr(p.repeats, name))
        node = np.full(len(p.repeats.perscale_ids), -1, dtype=np.int64)
        for scaler, n in p.repeats.perscale_node.items():
            node[scaler] = n
        out["repeats_perscale_node"] = node
    return out


def _tensor(a: np.ndarray, dtype, device):
    """A float array (f64, f32 or the JAX package's bf16) as a tensor of
    `dtype` (a copy); the widening to f64 is exact."""
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float64)
    return torch.tensor(a, device=device).to(dtype)


def partition_from_jax(arrays: Mapping[str, np.ndarray], cfg,
                       device="cuda"):
    """The port's `Partition` in the state of a JAX one: `arrays` from
    partition_arrays, `cfg` the JAX partition's PartitionConfig (or the
    port's).  Nothing is recomputed: CLVs, scalers and P-matrices are
    taken as they are, and the eigenvectors too."""
    from .partition import Partition
    dtype = cfg.dtype if isinstance(cfg.dtype, torch.dtype) \
        else getattr(torch, np.dtype(cfg.dtype).name)
    p = Partition(cfg.tips, cfg.clv_buffers, cfg.states, cfg.sites,
                  cfg.rate_matrices, cfg.prob_matrices, cfg.rate_cats,
                  cfg.scale_buffers, per_rate_scalers=cfg.per_rate_scalers,
                  pattern_tip=cfg.pattern_tip,
                  site_repeats=cfg.site_repeats, asc_bias=cfg.asc_bias,
                  dtype=dtype, site_block=cfg.site_block, device=device)
    p.clv = _tensor(arrays["clv"], dtype, p.device)
    p.pmatrix = _tensor(arrays["pmatrix"], dtype, p.device)
    p.scalers = torch.tensor(arrays["scalers"], dtype=torch.int32,
                             device=p.device)
    for name in PARTITION_FIELDS[3:]:
        setattr(p, name, np.array(arrays[name]))
    if "invariant" in arrays:
        p.invariant = np.array(arrays["invariant"])
    if p.repeats is not None:
        for name in REPEATS_FIELDS:
            setattr(p.repeats, name, np.array(arrays[f"repeats_{name}"]))
        node = arrays["repeats_perscale_node"]
        p.repeats.perscale_node = {int(s): int(n) for s, n in
                                   enumerate(node) if n >= 0}
    return p
