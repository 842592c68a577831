"""The tree sweep's plain PyTorch version (partials_tree.sweep_reference)
against libpll2_tpu's Pallas tree kernels run in interpret mode on the CPU,
on the same schedule, tips and P-matrices.

Tolerances: CLV rows rtol 1e-6 — the Pallas kernels form f32 products
from six bf16 split terms, the port in plain f32, so the two round
differently in the last bits (the same budget test_pallas_tree.py gives
the static kernel against XLA); scaler rows exactly, since both use the
2^-30 rule at f32.  The kernel itself is compared with this plain version
on the card (chip_smoke.py phase 3 and test_torch_cuda.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.ops import partials_pallas_tree as ppt
from libpll2_tpu.ops import pmatrix as jpmatrix
from libpll2_tpu.tree.generate import random_tipchars
from libpll2_tpu_torch import engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.tree.generate import balanced_newick, random_newick

TB = 128


def build(newick, sites, seed, per_rate=False, bl_scale=1.0):
    """Both packages' (cfg, program) plus shared numpy inputs: blocked
    tips [NT, tips, TB] and the JAX f32 P-matrix buffer."""
    jt = jtree.parse_newick_string(newick)
    pt = T.parse_newick_string(newick)
    n = pt.tip_count
    common = dict(tips=n, clv_buffers=pt.inner_count, states=4, sites=sites,
                  rate_matrices=1, prob_matrices=2 * n - 3, rate_cats=4,
                  scale_buffers=pt.inner_count, per_rate_scalers=per_rate)
    jcfg = JConfig(**common, dtype=jnp.float32)
    pcfg = PartitionConfig(**common, dtype=torch.float32)
    jprog = jengine.compile_tree(jt, jcfg)
    pprog = engine.compile_tree(pt, pcfg)
    model = jengine.make_model(
        [[1.2, 2.1, 0.7, 1.3, 2.5, 1.0]], [[0.3, 0.25, 0.2, 0.25]],
        pll.compute_gamma_cats(0.8, 4), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    tipchars = jengine.pad_tipchars(random_tipchars(n, sites, rng), jcfg)
    nt = jcfg.sites_padded // TB
    tip_b = np.ascontiguousarray(
        tipchars.reshape(n, nt, TB).transpose(1, 0, 2))
    bl = jprog.default_branch_lengths * bl_scale
    num_slots = int(jprog.pmatrix_indices.max()) + 1
    new = jpmatrix.compute_pmatrices(
        jnp.asarray(bl, jnp.float32), model.eigenvals, model.eigenvecs,
        model.inv_eigenvecs, model.rates, model.prop_invar,
        model.params_indices, dtype=jnp.float32)
    pmats = jnp.zeros((num_slots, 4, 4, 4), jnp.float32).at[
        jnp.asarray(jprog.pmatrix_indices)].set(new)
    return jcfg, jprog, pcfg, pprog, tip_b, np.array(pmats)


def run_port(pcfg, pprog, tip_b, pmats, tb=TB):
    return partials_tree.sweep_reference(
        torch.as_tensor(tip_b), torch.as_tensor(pmats), pprog.vmem_prog,
        pcfg, tb)


def assert_rows_match(got, want, rtol=1e-6):
    clv, scal = got
    np.testing.assert_allclose(clv.numpy(), np.asarray(want[0]), rtol=rtol,
                               atol=0)
    np.testing.assert_array_equal(scal.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("per_rate", [False, True])
def test_reference_matches_static(per_rate):
    """Scale-heavy random tree: rescues fire and scalers agree exactly."""
    rng = np.random.default_rng(3)
    jcfg, jprog, pcfg, pprog, tip_b, pmats = build(
        random_newick(24, rng), 384, 3, per_rate=per_rate, bl_scale=30.0)
    want = ppt.sweep_static(jnp.asarray(tip_b), jnp.asarray(pmats),
                            jprog.vmem_prog, jcfg, TB, interpret=True)
    got = run_port(pcfg, pprog, tip_b, pmats)
    assert int(got[1].max()) > 0
    assert got[1].shape[2] == (4 if per_rate else 1)
    assert_rows_match(got, want)


@pytest.mark.parametrize("per_rate", [False, True])
def test_reference_matches_static_segmented(per_rate):
    """The segmented Pallas kernel (carried slots across 8-op segments)
    computes the same rows; the port needs no segments."""
    rng = np.random.default_rng(9)
    jcfg, jprog, pcfg, pprog, tip_b, pmats = build(
        random_newick(40, rng), 256, 9, per_rate=per_rate, bl_scale=30.0)
    assert len(ppt.segment_static(jprog.vmem_prog, seg_ops=8).segments) >= 4
    want = ppt.sweep_static_segmented(
        jnp.asarray(tip_b), jnp.asarray(pmats), jprog.vmem_prog, jcfg, TB,
        interpret=True, seg_ops=8)
    got = run_port(pcfg, pprog, tip_b, pmats)
    assert int(got[1].max()) > 0
    assert_rows_match(got, want)


def test_reference_matches_static_balanced():
    """rtol 2e-6: on this tree each side lies up to ~1e-6 from the f64
    result (measured: 8.4e-7 for the port, 1.1e-6 for the Pallas kernel),
    so their gap can reach twice that."""
    jcfg, jprog, pcfg, pprog, tip_b, pmats = build(balanced_newick(32), 256,
                                                   4)
    want = ppt.sweep_static(jnp.asarray(tip_b), jnp.asarray(pmats),
                            jprog.vmem_prog, jcfg, TB, interpret=True)
    assert_rows_match(run_port(pcfg, pprog, tip_b, pmats), want, rtol=2e-6)


@pytest.mark.parametrize("tb", [32, 64, 256])
def test_reference_independent_of_site_block(tb):
    """Unblocked rows are the same at every site block the kernel takes."""
    rng = np.random.default_rng(5)
    jcfg, jprog, pcfg, pprog, tip_b, pmats = build(
        random_newick(20, rng), 512, 5, bl_scale=10.0)
    base = run_port(pcfg, pprog, tip_b, pmats)
    n, nt = pcfg.tips, pcfg.sites_padded // TB
    flat = tip_b.transpose(1, 0, 2).reshape(n, nt * TB)
    tip_tb = np.ascontiguousarray(
        flat.reshape(n, -1, tb).transpose(1, 0, 2))
    other = run_port(pcfg, pprog, tip_tb, pmats, tb=tb)
    for e in range(base[0].shape[0]):
        np.testing.assert_array_equal(
            partials_tree.unblock_clv_row(other[0][e]).numpy(),
            partials_tree.unblock_clv_row(base[0][e]).numpy())
        np.testing.assert_array_equal(
            partials_tree.unblock_scaler_row(other[1][e]).numpy(),
            partials_tree.unblock_scaler_row(base[1][e]).numpy())


def test_unblock_rows_match_jax():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3, 4, 4, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        partials_tree.unblock_clv_row(torch.as_tensor(rows)).numpy(),
        np.asarray(ppt.unblock_clv_row(jnp.asarray(rows))))
    for sr in (1, 4):
        srow = rng.integers(0, 9, (3, sr, 32)).astype(np.int32)
        np.testing.assert_array_equal(
            partials_tree.unblock_scaler_row(torch.as_tensor(srow)).numpy(),
            np.asarray(ppt.unblock_scaler_row(jnp.asarray(srow))))


def test_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(1)
    _, _, pcfg, pprog, tip_b, pmats = build(random_newick(16, rng), 256, 1)
    before = partials_tree.sweep.launches
    got = partials_tree.sweep(torch.as_tensor(tip_b),
                              torch.as_tensor(pmats), pprog.vmem_prog,
                              pcfg, TB)
    want = run_port(pcfg, pprog, tip_b, pmats)
    assert partials_tree.sweep.launches == before
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_wrapper_rejects_other_devices_and_shapes():
    rng = np.random.default_rng(2)
    _, _, pcfg, pprog, tip_b, pmats = build(random_newick(10, rng), 256, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        partials_tree.sweep(torch.as_tensor(tip_b, device="meta"),
                            torch.as_tensor(pmats, device="meta"),
                            pprog.vmem_prog, pcfg, TB)
    with pytest.raises(ValueError, match="does not match"):
        partials_tree.sweep_reference(torch.as_tensor(tip_b), torch.as_tensor(
            pmats), pprog.vmem_prog, dataclasses.replace(pcfg, sites=1000),
            TB)
