"""The forward slice as a whole: the port's engine.loglikelihood against
libpll2_tpu's, on the CPU, with the JAX model carried across by
convert.model_from_jax and the same numpy tips, weights and branch lengths.

Tolerances: f64 rtol 1e-9 — both packages run the same f64 formulas and
differ only in summation order over a few thousand sites; f32 rtol 5e-6 —
the f32 budget bench.py asserts between the JAX kernel and XLA paths,
covering f32 rounding through the tree depth and the site sum."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.constants import AB_LEWIS, AB_NONE
from libpll2_tpu.tree.generate import random_tipchars
from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

from .test_torch_host import caterpillar_newick

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-9),
          "f32": (jnp.float32, torch.float32, 5e-6)}


def invariant_of(tipchars):
    """State index of sites where every tip shows the same single state."""
    first = tipchars[0]
    same = (tipchars == first).all(axis=0)
    single = (first > 0) & ((first & (first - 1)) == 0)
    state = np.log2(np.maximum(first, 1)).astype(np.int32)
    return np.where(same & single, state, -1).astype(np.int32)


def both(newick, sites, seed, dt, pinv=0.0, per_rate=False, asc=AB_NONE,
         bl_scale=1.0, use_kernel=None):
    """(JAX args, port args) of one loglikelihood call on shared inputs."""
    jdt, pdt, _ = DTYPES[dt]
    jt = jtree.parse_newick_string(newick)
    pt = T.parse_newick_string(newick)
    n = pt.tip_count
    common = dict(tips=n, clv_buffers=pt.inner_count, states=4, sites=sites,
                  rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
                  scale_buffers=pt.inner_count, per_rate_scalers=per_rate,
                  asc_bias=asc)
    jcfg = JConfig(**common, dtype=jdt)
    pcfg = PartitionConfig(**common, dtype=pdt, use_kernel=use_kernel)
    jprog = jengine.compile_tree(jt, jcfg)
    pprog = engine.compile_tree(pt, pcfg)
    jmodel = jengine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4), prop_invar=[pinv], dtype=jdt)
    pmodel = convert.model_from_jax(convert.model_arrays(jmodel),
                                    device="cpu")

    rng = np.random.default_rng(seed)
    raw = random_tipchars(n, sites, rng)
    raw[:, :sites // 8] = raw[0, :sites // 8]       # some invariant sites
    tipchars = jengine.pad_tipchars(raw, jcfg)
    inv = invariant_of(tipchars) if pinv > 0 else \
        np.full(jcfg.sites_padded, -1, np.int32)
    pw = np.zeros(jcfg.sites_padded)
    pw[:jcfg.sites_alloc] = rng.integers(1, 4, jcfg.sites_alloc)
    bl = jprog.default_branch_lengths * bl_scale

    jargs = (jprog, jcfg, jmodel, jnp.asarray(bl, jdt),
             jnp.asarray(tipchars), jnp.asarray(pw, jdt), jnp.asarray(inv))
    pargs = (pprog, pcfg, pmodel, torch.as_tensor(bl, dtype=pdt),
             torch.as_tensor(tipchars), torch.as_tensor(pw, dtype=pdt),
             torch.as_tensor(inv))
    return jargs, pargs


CASES = {
    "random24": dict(newick=lambda: random_newick(24,
                                                  np.random.default_rng(1))),
    "balanced48": dict(newick=lambda: balanced_newick(48)),
    "caterpillar30_scaled": dict(newick=lambda: caterpillar_newick(30),
                                 bl_scale=20.0),
    "pinv": dict(newick=lambda: random_newick(20, np.random.default_rng(2)),
                 pinv=0.25),
    "per_rate_scaled": dict(newick=lambda: random_newick(
        32, np.random.default_rng(3)), per_rate=True, bl_scale=30.0),
    "asc_lewis": dict(newick=lambda: random_newick(
        16, np.random.default_rng(4)), asc=AB_LEWIS),
}


def run(case, dt, sites=384, seed=0, **kw):
    spec = dict(CASES[case])
    newick = spec.pop("newick")()
    jargs, pargs = both(newick, sites, seed, dt, **spec, **kw)
    want = float(jengine.loglikelihood(*jargs))
    got = engine.loglikelihood(*pargs)
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_loglikelihood_f64(case):
    got, want = run(case, "f64")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=DTYPES["f64"][2])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", ["random24", "caterpillar30_scaled", "pinv",
                                  "per_rate_scaled"])
def test_loglikelihood_f32(case, use_kernel):
    """use_kernel=True on CPU tensors runs the tree-sweep path with the
    kernel's plain version; False the dense level-batched path."""
    before = partials_tree.sweep.launches
    got, want = run(case, "f32", use_kernel=use_kernel)
    assert partials_tree.sweep.launches == before   # no kernel on the CPU
    assert got.dtype == torch.float32 and np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), want, rtol=DTYPES["f32"][2])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_site_repeats_flag_changes_no_likelihood(dt):
    """PartitionConfig.site_repeats is read by nothing on the engine path,
    in the JAX package (only its mutable Partition reads it) as in the
    port, and site repeats do not change a likelihood: with the flag on,
    the port's call equals the same call with it off, and the JAX engine's
    result for the same config."""
    spec = dict(CASES["random24"])
    newick = spec.pop("newick")()
    (jprog, jcfg, *jrest), (pprog, pcfg, *prest) = both(newick, 384, 0, dt,
                                                        **spec)
    assert not pcfg.site_repeats and not jcfg.site_repeats
    jon = dataclasses.replace(jcfg, site_repeats=True)
    pon = dataclasses.replace(pcfg, site_repeats=True)
    want = float(jengine.loglikelihood(jengine.compile_tree(
        jtree.parse_newick_string(newick), jon), jon, *jrest))
    off = engine.loglikelihood(pprog, pcfg, *prest)
    on = engine.loglikelihood(engine.compile_tree(
        T.parse_newick_string(newick), pon), pon, *prest)
    assert torch.equal(on, off)
    assert want == float(jengine.loglikelihood(jprog, jcfg, *jrest))
    np.testing.assert_allclose(on.item(), want, rtol=DTYPES[dt][2])


def test_tree_path_equals_dense_path_f32():
    """The two sweeps of the port price the same tree alike."""
    spec = dict(CASES["per_rate_scaled"])
    newick = spec.pop("newick")()
    _, pargs = both(newick, 256, 5, "f32", **spec)
    prog, cfg, *rest = pargs
    tree = engine.loglikelihood(prog, dataclasses.replace(
        cfg, use_kernel=True), *rest)
    dense = engine.loglikelihood(prog, dataclasses.replace(
        cfg, use_kernel=False), *rest)
    np.testing.assert_allclose(tree.item(), dense.item(), rtol=5e-6)


def test_make_model_equal():
    args = ([[1.0, 2.0, 1.0, 1.0, 2.0, 1.5]], [[0.1, 0.2, 0.3, 0.4]],
            pll.compute_gamma_cats(0.5, 4))
    got = convert.model_arrays(engine.make_model(*args, device="cpu"))
    want = convert.model_arrays(jengine.make_model(*args))
    for name in engine.Model.FIELDS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_kernel_choice_follows_use_kernel():
    spec = dict(CASES["random24"])
    _, pargs = both(spec.pop("newick")(), 256, 0, "f64")
    prog, cfg = pargs[:2]
    cpu = torch.device("cpu")
    assert engine.kernel_choice(prog, cfg, cpu) is None     # None: dense
    with pytest.raises(ValueError, match="f32"):
        engine.kernel_choice(
            prog, dataclasses.replace(cfg, use_kernel=True), cpu)
    f32 = dataclasses.replace(cfg, dtype=torch.float32, use_kernel=True)
    assert engine.kernel_choice(prog, f32, cpu) == (128, "fma")
    assert engine.kernel_choice(
        prog, dataclasses.replace(f32, sweep_mode="mma"), cpu) == (256, "mma")
    assert engine.kernel_choice(
        prog, dataclasses.replace(f32, use_kernel=False), cpu) is None


def test_entry_matches_graft_entry():
    fn, args = engine.entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    got = fn(*args)
    want = float(jax.jit(jfn)(*jargs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=DTYPES["f32"][2])
