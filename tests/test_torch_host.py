"""Host layer of the PyTorch port against libpll2_tpu: the compiled tree
program, tip padding and the numpy model math must be byte-equal, and the
port must never import jax."""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.constants import AB_LEWIS
from libpll2_tpu.models import gamma as jgamma
from libpll2_tpu.models import ratematrix as jratematrix
from libpll2_tpu.tree import generate as jgenerate
from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.models import gamma, ratematrix
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.partition import Operation
from libpll2_tpu_torch.tree import generate

REPO = pathlib.Path(__file__).resolve().parent.parent

# The suite runs several pytest workers side by side.  torch's intra-op pool
# would start one thread per core in each of them, and the small tensors of
# these tests then spend their time contending for the cores (the port's
# test files took eight times as long).  Every worker imports this module
# when it collects, so the setting holds for all test_torch_* files.
torch.set_num_threads(1)


def caterpillar_newick(n):
    s = "(t0:0.1,t1:0.2)"
    for i in range(2, n - 2):
        s = f"({s}:0.05,t{i}:0.1)"
    return f"({s}:0.05,t{n - 2}:0.1,t{n - 1}:0.1);"


def newick_of(kind, n, seed):
    if kind == "random":
        return generate.random_newick(n, np.random.default_rng(seed))
    if kind == "balanced":
        return generate.balanced_newick(n)
    return caterpillar_newick(n)


def both_configs(newick, sites=300, **kw):
    jt = jtree.parse_newick_string(newick)
    pt = T.parse_newick_string(newick)
    common = dict(tips=pt.tip_count, clv_buffers=pt.inner_count, states=4,
                  sites=sites, rate_matrices=1,
                  prob_matrices=2 * pt.tip_count - 3, rate_cats=4,
                  scale_buffers=pt.inner_count, **kw)
    return (jt, JConfig(**common, dtype=jnp.float32),
            pt, PartitionConfig(**common, dtype=torch.float32))


@pytest.mark.parametrize("kind,n,seed", [
    ("random", 5, 0), ("random", 24, 1), ("random", 48, 2),
    ("balanced", 16, 0), ("balanced", 48, 0),
    ("caterpillar", 12, 0), ("caterpillar", 40, 0),
])
def test_compile_tree_byte_equal(kind, n, seed):
    """level_ops, the schedule (ops, pool_size, exports, export maps),
    pmatrix_indices, default_branch_lengths and the root fields."""
    jt, jcfg, pt, pcfg = both_configs(newick_of(kind, n, seed))
    ref = jengine.compile_tree(jt, jcfg)
    got = engine.compile_tree(pt, pcfg)
    assert convert.program_mismatches(got, ref) == []
    assert got.vmem_prog.ops.dtype == np.int32


def test_program_mismatches_detects_difference():
    jt, jcfg, _, _ = both_configs(newick_of("random", 12, 3))
    _, _, pt, pcfg = both_configs(newick_of("random", 12, 4))
    mism = convert.program_mismatches(engine.compile_tree(pt, pcfg),
                                      jengine.compile_tree(jt, jcfg))
    assert "vmem_prog.ops" in mism and "level_ops" in mism


@pytest.mark.parametrize("n,seed", [(7, 0), (30, 5)])
def test_generators_equal(n, seed):
    assert generate.random_newick(n, np.random.default_rng(seed)) == \
        jgenerate.random_newick(n, np.random.default_rng(seed))
    assert generate.balanced_newick(n) == jgenerate.balanced_newick(n)
    np.testing.assert_array_equal(
        generate.random_tipchars(n, 50, np.random.default_rng(seed), 20),
        jgenerate.random_tipchars(n, 50, np.random.default_rng(seed), 20))


def test_newick_roundtrip_equal():
    newick = newick_of("random", 20, 9)
    assert T.export_newick(T.parse_newick_string(newick).vroot) == \
        jtree.export_newick(jtree.parse_newick_string(newick).vroot)
    assert T.show_ascii(T.parse_newick_string(newick).vroot) == \
        jtree.show_ascii(jtree.parse_newick_string(newick).vroot)


@pytest.mark.parametrize("asc", [False, True])
def test_pad_tipchars_equal(asc):
    kw = {"asc_bias": AB_LEWIS} if asc else {}
    _, jcfg, _, pcfg = both_configs(newick_of("random", 10, 0), sites=77,
                                    **kw)
    raw = generate.random_tipchars(10, 77, np.random.default_rng(1))
    got = engine.pad_tipchars(raw, pcfg)
    want = jengine.pad_tipchars(raw, jcfg)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("states,zero_freq", [(4, False), (4, True),
                                              (20, False)])
def test_update_eigen_equal(states, zero_freq):
    rng = np.random.default_rng(states)
    subst = rng.uniform(0.1, 4.0, states * (states - 1) // 2)
    freqs = rng.dirichlet(np.ones(states))
    if zero_freq:
        freqs[1] = 0.0
        freqs /= freqs.sum()
    got = ratematrix.update_eigen(subst, freqs)
    want = jratematrix.update_eigen(subst, freqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ratematrix.normalize_frequencies(freqs * 3),
                                  jratematrix.normalize_frequencies(freqs * 3))


@pytest.mark.parametrize("alpha,cats,mode", [
    (0.3, 4, 0), (1.0, 4, 0), (2.5, 8, 0), (0.8, 4, 1), (5.0, 6, 1),
    (1.0, 1, 0)])
def test_compute_gamma_cats_equal(alpha, cats, mode):
    np.testing.assert_array_equal(gamma.compute_gamma_cats(alpha, cats, mode),
                                  jgamma.compute_gamma_cats(alpha, cats, mode))


def test_schedule_rejects_non_forest():
    # child 5 never produced and not a tip -> partial traversal -> None
    ops = [Operation(6, 0, 5, 0, 1, 0, -1, -1)]
    assert partials_tree.schedule(ops, tips=4, export_clvs=[6]) is None


def test_site_block_and_unsupported():
    _, _, pt, pcfg = both_configs(generate.balanced_newick(256),
                                  sites=65536)
    prog = engine.compile_tree(pt, pcfg).vmem_prog
    tb = partials_tree.pick_site_block(prog, pcfg)
    # one thread per rate of two sites: 128 sites x 4 rates fill a
    # 256-thread CTA
    assert tb == 128 and partials_tree.fma_threads(pcfg, tb) == 256
    assert partials_tree.pick_site_block(prog, pcfg, mode="mma") == 256
    assert partials_tree.smem_bytes(prog, pcfg, tb) <= \
        partials_tree.SMEM_LIMIT
    assert partials_tree.unsupported(prog, pcfg) is None
    import dataclasses
    f64 = dataclasses.replace(pcfg, dtype=torch.float64)
    assert "f32" in partials_tree.unsupported(prog, f64)
    # any state count of an int32 tip mask (3: the generic instantiation)
    three = dataclasses.replace(pcfg, states=3)
    assert partials_tree.unsupported(prog, three) is None
    too_many = dataclasses.replace(pcfg, states=33)
    assert "states" in partials_tree.unsupported(prog, too_many)
    assert "shared memory" in partials_tree.unsupported(prog, pcfg,
                                                        smem_limit=1024)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = sorted((REPO / "libpll2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    assert {"multipartition.py", "fit.py", "cache.py", "constructs.py",
            "infer.py", "native.py", "fitch.py", "stepwise.py",
            "checkpoint.py", "compress.py", "sharding.py", "distributed.py",
            "launcher.py", "_rank.py", "legacy_search.py", "profiling.py",
            "_common.py", "optimize_demo.py", "large_search.py",
            "infer_demo.py"} <= {f.name for f in files}
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "libpll2_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_port_import_loads_no_jax():
    code = ("import sys, libpll2_tpu_torch.engine, libpll2_tpu_torch.convert,"
            " libpll2_tpu_torch.search_fast, libpll2_tpu_torch.tree.moves,"
            " libpll2_tpu_torch.multipartition, libpll2_tpu_torch.fit,"
            " libpll2_tpu_torch.probes.mma, libpll2_tpu_torch.probes.cache,"
            " libpll2_tpu_torch.probes.constructs, libpll2_tpu_torch.infer,"
            " libpll2_tpu_torch.io, libpll2_tpu_torch.native,"
            " libpll2_tpu_torch.parsimony, libpll2_tpu_torch.utils.checkpoint,"
            " libpll2_tpu_torch.parallel, libpll2_tpu_torch.parallel._rank,"
            " libpll2_tpu_torch.legacy_search, libpll2_tpu_torch.profiling,"
            " libpll2_tpu_torch.examples.optimize_demo,"
            " libpll2_tpu_torch.examples.large_search,"
            " libpll2_tpu_torch.examples.infer_demo,"
            " libpll2_tpu_torch.examples.partial_traversal,"
            " chip_smoke;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libpll2_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _public_functions():
    """Every public function or class of the port's modules (and of
    chip_smoke) that takes a `device` parameter."""
    import importlib
    import inspect
    names = ["chip_smoke"] + [
        ".".join(("libpll2_tpu_torch",)
                 + f.relative_to(REPO / "libpll2_tpu_torch")
                 .with_suffix("").parts).removesuffix(".__init__")
        for f in sorted((REPO / "libpll2_tpu_torch").rglob("*.py"))]
    for name in names:
        module = importlib.import_module(name)
        for attr, fn in vars(module).items():
            if attr.startswith("_") or not (
                    inspect.isfunction(fn) or inspect.isclass(fn)) \
                    or fn.__module__ != name:
                continue
            try:
                params = inspect.signature(fn).parameters
            except ValueError:          # a class with no signature (errors)
                continue
            param = params.get("device")
            if param is not None:
                yield f"{name}.{attr}", param


def test_no_public_function_defaults_to_the_cpu():
    """An entry point runs on the card unless the caller asks for the CPU:
    a `device` parameter has no default or the card as its default."""
    found = dict(_public_functions())
    assert {"libpll2_tpu_torch.engine.make_model",
            "libpll2_tpu_torch.engine.build_case",
            "libpll2_tpu_torch.engine.entry",
            "libpll2_tpu_torch.convert.model_from_jax",
            "libpll2_tpu_torch.convert.fit_params_from_jax",
            "libpll2_tpu_torch.fit.pack",
            "libpll2_tpu_torch.probes.mma.probe_inputs",
            "libpll2_tpu_torch.probes.cache.probe_input",
            "libpll2_tpu_torch.probes.constructs.probe_inputs",
            "libpll2_tpu_torch.infer.infer_ml_tree",
            "libpll2_tpu_torch.infer.parsimony_start",
            "libpll2_tpu_torch.infer.fit_inputs",
            "libpll2_tpu_torch.parsimony.fitch.FastParsimony",
            "libpll2_tpu_torch.parsimony.sankoff.Parsimony",
            "libpll2_tpu_torch.partition.Partition",
            "libpll2_tpu_torch.convert.partition_from_jax",
            "libpll2_tpu_torch.utils.memory.device_memory_bytes",
            "libpll2_tpu_torch.profiling.run",
            "libpll2_tpu_torch.profiling.target_engine",
            "libpll2_tpu_torch.profiling.target_repeats"} \
        <= set(found)
    for name, param in found.items():
        default = param.default
        assert default is param.empty or default is None \
            or str(default).startswith("cuda"), \
            f"{name} defaults to device={default!r}"


def test_default_device_raises_without_a_card():
    """With no GPU the default raises; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from libpll2_tpu_torch.probes import mma
    with pytest.raises((AssertionError, RuntimeError)):
        engine.make_model([[1.0, 2.0, 1.0, 1.0, 2.0, 1.0]], [[0.25] * 4],
                          [1.0])
    with pytest.raises((AssertionError, RuntimeError)):
        engine.build_case(8, 64)
    with pytest.raises((AssertionError, RuntimeError)):
        mma.probe_inputs(0, 32)
    from libpll2_tpu_torch import FastParsimony, Parsimony, infer_ml_tree
    with pytest.raises((AssertionError, RuntimeError)):
        infer_ml_tree({f"t{i}": "ACGTACGT"[i:] + "ACGTACGT"[:i]
                       for i in range(5)})
    from libpll2_tpu_torch.infer import parsimony_start
    with pytest.raises((AssertionError, RuntimeError)):
        parsimony_start([f"t{i}" for i in range(4)],
                        {f"t{i}": np.ones(8, np.uint64) for i in range(4)})
    with pytest.raises((AssertionError, RuntimeError)):
        FastParsimony(tipchars=np.ones((4, 8), np.uint64),
                      weights=np.ones(8), tips=4, states=4, sites=8)
    with pytest.raises((AssertionError, RuntimeError)):
        Parsimony(4, 4, 8, 1.0 - np.eye(4), 3, 3)
    from libpll2_tpu_torch import Partition
    with pytest.raises((AssertionError, RuntimeError)):
        Partition(4, 2, 4, 8, 1, 5, 4, 2)
    from libpll2_tpu_torch.utils import memory
    with pytest.raises((AssertionError, RuntimeError)):
        memory.device_memory_bytes()
