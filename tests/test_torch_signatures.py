"""The public signatures of the port against libpll2_tpu's: every public
function, class and method of a JAX module has a counterpart of the same
name in the port module of the same path, with the same parameters (names,
order, kinds, and whether each has a default), apart from the differences
listed in INTENDED.  Then the two calls that once differed (P6, P7) run
with keywords through both packages."""
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

import libpll2_tpu as jpll
from libpll2_tpu.utils import checkpoint as jcheckpoint
from libpll2_tpu_torch import Partition
from libpll2_tpu_torch.utils import checkpoint

REPO = pathlib.Path(__file__).resolve().parent.parent

# JAX modules with no port module of the same path: TPU kernels replaced
# by the CUDA wrappers of ops/partials_tree.py and ops/edge_score.py
# (compared below under PAIRED).
NO_COUNTERPART = {"libpll2_tpu.ops.partials_pallas_tree",
                  "libpll2_tpu.ops.edge_score_pallas"}
PAIRED = {"libpll2_tpu.ops.partials_pallas_tree":
          "libpll2_tpu_torch.ops.partials_tree",
          "libpll2_tpu.ops.edge_score_pallas":
          "libpll2_tpu_torch.ops.edge_score"}

DEVICE = "a `device` argument: the port runs on the card unless asked"
GROUP = "a `group` argument: the process group of a site-sharded call"
INTENDED = {
    "engine.make_model": DEVICE,
    "fit.pack": DEVICE,
    "infer.infer_ml_tree": DEVICE,
    "parsimony.fitch.FastParsimony": DEVICE,
    "parsimony.fitch.FastParsimony.__init__": DEVICE,
    "parsimony.sankoff.Parsimony": DEVICE,
    "parsimony.sankoff.Parsimony.__init__": DEVICE,
    "partition.Partition": DEVICE,
    "partition.Partition.__init__": DEVICE,
    "ops.likelihood.asc_bias_correction": GROUP,
    "ops.likelihood.root_loglikelihood": GROUP,
    "ops.likelihood.edge_loglikelihood": GROUP,
    "ops.likelihood.edge_reduce": GROUP,
    "ops.derivatives.sumtable_loglikelihood": GROUP,
    "ops.derivatives.likelihood_derivatives": GROUP,
    "config.PartitionConfig": "use_pallas and pallas_precision are "
                              "use_kernel and sweep_mode",
    "config.PartitionConfig.__init__": "as config.PartitionConfig",
    "engine.TreeProgram": "a private field: a device cache, not a hash",
    "engine.TreeProgram.__init__": "as engine.TreeProgram",
    "engine.FullTreeProgram": "no private hash field (no jit cache)",
    "engine.FullTreeProgram.__init__": "as engine.FullTreeProgram",
    "multipartition.MultiPartition": "no private hash field",
    "multipartition.MultiPartition.__init__": "no private hash field",
    "ops.partials_pallas_tree.TreeVmemProgram": "a device cache field",
    "ops.partials_pallas_tree.TreeVmemProgram.__init__": "as above",
    "ops.partials_pallas_tree.pick_site_block": "CUDA-shaped: shared "
                                                "memory and SM count",
    "ops.partials_pallas_tree.choose": "CUDA-shaped: shared memory and "
                                       "SM count",
    "utils.memory.max_sites": "hbm_bytes is the caller's (the JAX default "
                              "is a TPU's memory)",
    "utils.memory.max_sites_table": "as utils.memory.max_sites",
    "engine.Model.tree_flatten": "missing: a JAX pytree hook",
    "models.gamma.gamma_quantile_jax": "missing: a JAX-traced variant",
    "models.gamma.compute_gamma_cats_jax": "missing: a JAX-traced variant",
    "models.ratematrix.build_rate_matrix_jax": "missing: a JAX-traced "
                                               "variant",
    "models.ratematrix.update_eigen_jax": "missing: a JAX-traced variant",
}


def _modules():
    for f in sorted((REPO / "libpll2_tpu").rglob("*.py")):
        yield ".".join(("libpll2_tpu",) + f.relative_to(
            REPO / "libpll2_tpu").with_suffix("").parts) \
            .removesuffix(".__init__")


def _public(module):
    """Public functions and classes defined in `module`, and the public
    methods and __init__ of those classes."""
    for name, obj in vars(module).items():
        if name.startswith("_") \
                or getattr(obj, "__module__", None) != module.__name__:
            continue
        if inspect.isfunction(obj):
            yield name, obj
        elif inspect.isclass(obj):
            yield name, obj
            for method, fn in vars(obj).items():
                if inspect.isfunction(fn) and (not method.startswith("_")
                                               or method == "__init__"):
                    yield f"{name}.{method}", fn


def _signature(fn):
    try:
        params = inspect.signature(fn).parameters.values()
    except ValueError:              # a class with no signature (errors)
        return None
    return [(p.name, p.kind, p.default is not p.empty) for p in params]


def signature_differences() -> dict:
    """{name relative to the package: what differs} over every module."""
    found = {}
    for name in _modules():
        if name in NO_COUNTERPART and name not in PAIRED:
            continue
        ref = importlib.import_module(name)
        port = importlib.import_module(
            PAIRED.get(name, name.replace("libpll2_tpu", "libpll2_tpu_torch",
                                          1)))
        ours = dict(_public(port))
        short = name.removeprefix("libpll2_tpu").lstrip(".")
        for attr, fn in _public(ref):
            key = f"{short}.{attr}" if short else attr
            if attr not in ours:
                if name not in PAIRED:      # TPU-only names stay there
                    found[key] = "missing"
            elif _signature(fn) != _signature(ours[attr]):
                found[key] = (_signature(fn), _signature(ours[attr]))
    return found


def test_signatures_differ_only_as_intended():
    found = signature_differences()
    unexpected = {k: v for k, v in found.items() if k not in INTENDED}
    stale = sorted(set(INTENDED) - set(found))
    assert not unexpected, f"signatures differ: {unexpected}"
    assert not stale, f"listed differences no longer differ: {stale}"


def test_set_tip_clv_padded_keyword():
    """P6: Partition.set_tip_clv(..., padded=False) in both packages."""
    tips, sites = 4, 6
    rng = np.random.default_rng(3)
    clv = rng.uniform(0.1, 1.0, (sites, 4, 4))
    args = (tips, 2, 4, sites, 1, 5, 4, 2)
    jp = jpll.Partition(*args, dtype=jnp.float64)
    pp = Partition(*args, dtype=torch.float64, device="cpu")
    for p in (jp, pp):
        p.set_tip_clv(1, clv, padded=False)
    np.testing.assert_array_equal(np.asarray(pp.clv[1]),
                                  np.asarray(jp.clv[1]))
    assert not pp.tipchars_valid[1] and not jp.tipchars_valid[1]


def test_checkpoint_save_pytree_keyword(tmp_path):
    """P7: checkpoint.save(path, pytree=...) in both packages."""
    values = {"bl": np.arange(5, dtype=np.float64), "alpha": np.float64(0.7)}
    jcheckpoint.save(tmp_path / "jax", pytree=values)
    checkpoint.save(tmp_path / "port", pytree={
        "bl": torch.as_tensor(values["bl"]), "alpha": values["alpha"]})
    like = {"bl": np.zeros(5), "alpha": np.float64(0.0)}
    got = checkpoint.restore(tmp_path / "port", {
        "bl": torch.zeros(5, dtype=torch.float64), "alpha": np.float64(0)})
    want = jcheckpoint.restore(tmp_path / "jax", like)
    np.testing.assert_array_equal(got["bl"].numpy(), want["bl"])
    assert float(got["alpha"]) == float(want["alpha"]) == 0.7
