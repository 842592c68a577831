"""The tree sweep's plain PyTorch version (partials_tree.sweep_reference)
against libpll2_tpu's Pallas tree kernels run in interpret mode on the CPU,
on the same schedule, tips and P-matrices.

Tolerances: CLV rows rtol 1e-6 — the Pallas kernels form f32 products
from six bf16 split terms, the port in plain f32, so the two round
differently in the last bits (the same budget test_pallas_tree.py gives
the static kernel against XLA); scaler rows exactly, since both use the
2^-30 rule at f32.  The kernels themselves are compared with this plain
version on the card (chip_smoke.py and test_torch_cuda.py).

`sweep(mode="fma"|"mma")` is held the same way against the runtime-ops
Pallas kernels ("vpu", "mxu", "splitk"), and `choose` beside the JAX
package's `choose`."""
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

from .test_torch_host import caterpillar_newick

TB = 128
# runtime-ops mode of the JAX package -> the port's counterpart
MODE_OF = {"vpu": "fma", "mxu": "mma", "splitk": "mma"}


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


def run_modes(jcfg, jprog, pcfg, pprog, tip_b, pmats, jmode):
    """(port sweep in the counterpart mode, JAX runtime-ops sweep in
    `jmode` run in interpret mode) on the same inputs."""
    want = ppt.sweep(jnp.asarray(tip_b), jnp.asarray(pmats), jprog.vmem_prog,
                     jcfg, TB, mode=jmode, interpret=True)
    before = dict(partials_tree.sweep.launches_by_mode)
    got = partials_tree.sweep(torch.as_tensor(tip_b), torch.as_tensor(pmats),
                              pprog.vmem_prog, pcfg, TB, mode=MODE_OF[jmode])
    assert partials_tree.sweep.launches_by_mode == before  # CPU: plain
    return got, want


@pytest.mark.parametrize("jmode", ["vpu", "mxu"])
@pytest.mark.parametrize("n_tips,sites,seed", [
    (8, 256, 0), (24, 384, 1), (40, 512, 2)])
def test_sweep_mode_matches_runtime_ops(n_tips, sites, seed, jmode):
    """The shapes of test_pallas_tree.test_vmem_matches_xla: rows rtol
    1e-6 (f32 sums in another order), scalers equal."""
    rng = np.random.default_rng(seed)
    args = build(random_newick(n_tips, rng), sites, seed)
    got, want = run_modes(*args, jmode)
    assert_rows_match(got, want)


@pytest.mark.parametrize("jmode", ["vpu", "mxu"])
def test_sweep_mode_scaling_fires(jmode):
    """test_vmem_scaling_fires' shape: rescues fire, scalers equal."""
    rng = np.random.default_rng(7)
    args = build(random_newick(48, rng), 256, 7, bl_scale=30.0)
    got, want = run_modes(*args, jmode)
    assert int(got[1].max()) > 0
    assert_rows_match(got, want)


@pytest.mark.parametrize("jmode", ["vpu", "mxu", "splitk"])
def test_sweep_mode_caterpillar_compensated(jmode):
    """test_vmem_caterpillar_pool_small's shape: on a depth-62 chain a
    rescue decision can flip where a CLV sits within an ulp of the
    threshold; CLV x 2^30k and scaler + k compensate exactly, so compare
    scaling-compensated values at that test's rtol 2e-3.  Entries stored
    as f32 subnormals (below 1e-37) are held to 2e-3 of their site's
    magnitude instead: XLA's CPU flushes them to zero and torch keeps
    them."""
    args = build(caterpillar_newick(64), 256, 3)
    assert args[3].vmem_prog.pool_size <= 4
    (clv, scal), (jclv, jscal) = run_modes(*args, jmode)
    stored = np.asarray(jclv, np.float64)
    got = clv.double().numpy() * 2.0 ** (-30.0 * scal.numpy()[:, :, :, None])
    want = stored * 2.0 ** (-30.0 * np.asarray(jscal)[:, :, :, None])
    normal = (stored >= 1e-37) & (clv.numpy() >= 1e-37)
    assert normal.mean() > 0.8
    np.testing.assert_allclose(got[normal], want[normal], rtol=2e-3, atol=0)
    mag = want.max(axis=(2, 3), keepdims=True)
    assert float(np.max(np.abs(got - want) / mag)) < 2e-3


def test_sweep_mode_matches_splitk():
    """test_splitk_matches_xla's shape at "highest": within 5e-6 of each
    site's magnitude (tiny components may differ at bf16 granularity in
    the Pallas kernel), scalers equal."""
    rng = np.random.default_rng(11)
    args = build(random_newick(24, rng), 384, 11)
    (clv, scal), (jclv, jscal) = run_modes(*args, "splitk")
    want = np.asarray(jclv, np.float64)
    mag = np.maximum(want.max(axis=(2, 3), keepdims=True), 1e-300)
    assert float(np.max(np.abs(clv.double().numpy() - want) / mag)) < 5e-6
    np.testing.assert_array_equal(scal.numpy(), np.asarray(jscal))


def test_sweep_rejects_unknown_mode():
    rng = np.random.default_rng(2)
    _, _, pcfg, pprog, tip_b, pmats = build(random_newick(10, rng), 256, 2)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        partials_tree.sweep(torch.as_tensor(tip_b), torch.as_tensor(pmats),
                            pprog.vmem_prog, pcfg, TB, mode="mxu")


def test_choose_beside_jax_choose():
    """As test_pallas_tree.test_choose_prefers_static: both packages take
    the static family (the port's "fma") on a small tree.  With the JAX op
    limits lowered the JAX package moves to the runtime-ops family
    ("splitk"); the port's rule does not follow the op count, and keeps
    "fma" wherever that form takes the case.  Where only the "mma" form's
    pools fit the shared-memory limit the port takes "mma".  Under per-rate
    scalers the JAX runtime-ops kernels refuse; the port's "fma" form keeps
    them."""
    jcfg, jprog, pcfg, pprog, _, _ = build(caterpillar_newick(16), 256, 0)
    slots = int(jprog.pmatrix_indices.max()) + 1
    prog = pprog.vmem_prog
    assert ppt.choose(jprog.vmem_prog, jcfg, slots)[1] == "static"
    assert partials_tree.choose(prog, pcfg) == (128, "fma")
    jrate = dataclasses.replace(jcfg, per_rate_scalers=True)
    prate = dataclasses.replace(pcfg, per_rate_scalers=True)
    saved = ppt.STATIC_MAX_OPS, ppt.STATIC_SEG_MAX_OPS
    try:
        ppt.STATIC_MAX_OPS = ppt.STATIC_SEG_MAX_OPS = 0
        assert ppt.choose(jprog.vmem_prog, jcfg, slots)[1] == "splitk"
        assert partials_tree.choose(prog, pcfg) == (128, "fma")
        assert ppt.choose(jprog.vmem_prog, jrate, slots) is None
        assert partials_tree.choose(prog, prate) == (128, "fma")
    finally:
        ppt.STATIC_MAX_OPS, ppt.STATIC_SEG_MAX_OPS = saved
    # a limit between the two forms' footprints at the smallest block
    smem = partials_tree.smem_bytes
    between = smem(prog, pcfg, 32, "mma") + 16
    assert smem(prog, pcfg, 32, "fma") > between
    assert partials_tree.choose(prog, pcfg, smem_limit=between) \
        == (32, "mma")
    assert partials_tree.choose(prog, prate, smem_limit=between) is None
    # no schedule, or a dtype other than f32: neither package has a kernel
    assert ppt.choose(None, jcfg, slots) is None
    assert partials_tree.choose(None, pcfg) is None
    assert partials_tree.choose(prog, dataclasses.replace(
        pcfg, dtype=torch.float64)) is None
    # a pool too large for the shared-memory limit
    assert partials_tree.choose(prog, pcfg, smem_limit=1024) is None


def test_unsupported_names_the_mode():
    _, _, pcfg, pprog, _, _ = build(caterpillar_newick(16), 256, 0)
    prog = pprog.vmem_prog
    assert partials_tree.unsupported(prog, pcfg, mode="mma") is None
    prate = dataclasses.replace(pcfg, per_rate_scalers=True)
    assert "'mma'" in partials_tree.unsupported(prog, prate, mode="mma")
    assert partials_tree.unsupported(prog, prate, mode="fma") is None
    odd = dataclasses.replace(pcfg, rate_cats=3)
    assert "rate_cats" in partials_tree.unsupported(prog, odd, mode="mma")
    assert "mode 'fma'" in partials_tree.unsupported(prog, pcfg, 1024, "fma")
    assert "unknown" in partials_tree.unsupported(prog, pcfg, mode="vpu")
    # the "mma" form keeps one scaler row whatever the config says; the
    # "fma" form the same pools as "mma" under per-site scalers, R rows
    # under per-rate ones, and one staging ring a warp
    smem = partials_tree.smem_bytes
    ring = partials_tree.fma_threads(pcfg, 64) // 32 \
        * partials_tree.ring_words(pcfg) * 4
    assert smem(prog, prate, 64, "mma") == smem(prog, pcfg, 64, "mma") \
        == smem(prog, pcfg, 64, "fma") - ring \
        < smem(prog, prate, 64, "fma") - ring


def test_split_tf32_is_compensated():
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.standard_normal(4096)
                         * np.exp(rng.uniform(-20, 3, 4096))
                         ).astype(np.float32))
    hi, lo = partials_tree.split_tf32(x)
    for part in (hi, lo):       # TF32: the low 13 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    err = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22
    assert float(lo.abs().max()) > 0


@pytest.mark.parametrize("states,rates,pairs", [(4, 4, 2), (20, 4, 22)])
def test_pmatrix_fragments_rebuild_block_diagonal(states, rates, pairs):
    """Scattering the fragment table back by its mma fragment layout gives
    the rate-block-diagonal P; all-zero tiles are left out.  Span 80: the
    A-fragment layout (row lane/4 (+8), column lane%4 (+4) of each 16 x 8
    tile).  Span 16, the small-span kernel: P^T as the B operand, registers
    b0, b1 of n-tile j = Pbd[8j + lane/4, 8j + 2 (lane%4) (+1)]."""
    rng = np.random.default_rng(states)
    span = states * rates
    pm = torch.as_tensor(rng.uniform(0, 1, (3, rates, states, states))
                         .astype(np.float32))
    cfg = PartitionConfig(tips=4, clv_buffers=2, states=states, sites=8,
                          rate_matrices=1, prob_matrices=5, rate_cats=rates,
                          scale_buffers=2, dtype=torch.float32)
    frag = partials_tree.pmatrix_fragments(pm, cfg)
    assert frag.is_contiguous()
    want = torch.zeros((3, span, span), dtype=torch.float64)
    for r in range(rates):
        blk = slice(r * states, (r + 1) * states)
        want[:, blk, blk] = pm[:, r].double()
    got = torch.zeros_like(want)
    lane = np.arange(32)
    if (states, rates) in partials_tree.MMA_CARRY_CASES:
        assert frag.shape == (3, pairs, 32, 2, 2)
        for j in range(pairs):
            rows = 8 * j + (lane // 4)[:, None] + np.array([0, 0])
            cols = 8 * j + 2 * (lane % 4)[:, None] + np.array([0, 1])
            got[:, rows, cols] = frag[:, j].double().sum(dim=2)
        # every other (k-step, n-tile) pair of the block-diagonal is zero
        for j in range(pairs):
            for k in range(pairs):
                if j != k:
                    assert not want[:, 8 * j:8 * j + 8, 8 * k:8 * k + 8].any()
    else:
        assert frag.shape == (3, pairs, 2, 32, 4)
        p = 0
        for mt in range(span // 16):
            for ks in range(span // 8):
                rows = 16 * mt + (lane // 4)[:, None] + np.array([0, 8, 0, 8])
                cols = 8 * ks + (lane % 4)[:, None] + np.array([0, 0, 4, 4])
                if not (want[0][rows, cols] != 0).any():
                    continue
                got[:, rows, cols] = frag[:, p].double().sum(dim=1)
                p += 1
        assert p == pairs
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2.0 ** -22)


CARRY_TREES = {
    "random": lambda: random_newick(60, np.random.default_rng(5)),
    "balanced": lambda: balanced_newick(64),
    "caterpillar": lambda: caterpillar_newick(48),
}


@pytest.mark.parametrize("shape", sorted(CARRY_TREES))
def test_carry_flags(shape):
    """A carried child is the previous op's parent; a parent whose store is
    dropped is read by exactly that next op and is not exported; a parent
    is either stored or handed on; every op with an inner child that the
    previous op wrote takes it from registers (on a tree each parent is
    read once).  prog.ops stays byte-equal to the JAX package's."""
    jcfg, jprog, pcfg, pprog, tip_b, pmats = build(
        CARRY_TREES[shape](), 256, 4, bl_scale=20.0)
    prog = pprog.vmem_prog
    assert prog.ops.tobytes() == np.asarray(jprog.vmem_prog.ops).tobytes()
    flags = partials_tree.carry_flags(prog)
    assert flags.shape == (prog.n_ops, 3) and flags.dtype == np.int32
    assert ((flags[:, 1] + flags[:, 2]) == 1).all()
    ops = prog.ops
    exported = {i for i, _ in prog.exports}
    carried = 0
    for w in range(prog.n_ops):
        took, store, keep = flags[w]
        if took:
            carried += 1
            assert w > 0 and flags[w - 1, 2] == 1
            slot, is_tip = (ops[w, 2], ops[w, 3]) if took == 1 \
                else (ops[w, 5], ops[w, 6])
            assert not is_tip and slot == ops[w - 1, 0]
        else:
            assert w == 0 or flags[w - 1, 2] == 0
        if not store:
            assert w not in exported
            # no op reads the slot before it is written again, but the next
            readers = []
            for v in range(w + 1, prog.n_ops):
                for slot, is_tip in ((ops[v, 2], ops[v, 3]),
                                     (ops[v, 5], ops[v, 6])):
                    if not is_tip and slot == ops[w, 0]:
                        readers.append(v)
                if ops[v, 0] == ops[w, 0]:
                    break
            assert readers == [w + 1]
    # on a tree every parent is read once, so every inner child that the
    # previous op wrote is carried unless that parent is exported
    expected = sum(
        1 for w in range(1, prog.n_ops)
        if w - 1 not in exported
        and ((not ops[w, 3] and ops[w, 2] == ops[w - 1, 0])
             or (not ops[w, 6] and ops[w, 5] == ops[w - 1, 0])))
    assert carried == expected > 0
    assert not partials_tree.carry_flags(prog, enabled=False)[:, [0, 2]].any()

    # the plain version honouring the flags: bit-equal rows and scalers,
    # and still the JAX kernel's in interpret mode
    plain = run_port(pcfg, pprog, tip_b, pmats)
    held = partials_tree.sweep_reference(
        torch.as_tensor(tip_b), torch.as_tensor(pmats), prog, pcfg, TB,
        carry=True)
    assert torch.equal(plain[0], held[0]) and torch.equal(plain[1], held[1])
    assert int(plain[1].max()) > 0
    # rtol 5e-6: the Pallas kernel rounds its six bf16 split terms
    # differently from plain f32 at every op, and these trees are up to 63
    # ops deep under heavy rescaling
    want = ppt.sweep_static(jnp.asarray(tip_b), jnp.asarray(pmats),
                            jprog.vmem_prog, jcfg, TB, interpret=True)
    assert_rows_match(held, want, rtol=5e-6)


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("shape", sorted(CARRY_TREES))
def test_mma_device_table_runs_the_schedule(shape, carry):
    """The table the "mma" kernel reads, interpreted row by row as the
    kernel does (children by kind: tip, pool slot, handed on; a parent
    stored or handed on), gives the plain version's rows bit for bit; its
    children are ordered tip before pool before carried."""
    _, _, pcfg, pprog, tip_b, pmats = build(CARRY_TREES[shape](), 128, 6,
                                            bl_scale=20.0)
    prog = pprog.vmem_prog
    table = partials_tree.mma_device_table(prog, carry)
    assert table.shape == (prog.n_ops, partials_tree.MMA_OP_COLS)
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"]
    kinds = {v: k for k, v in partials_tree.KINDS.items()}
    if not carry:
        assert not table[:, 11].any() and table[:, 10].all()
        assert set(table[:, 9].tolist()) <= {0, 1, 3}
    tips, pm = torch.as_tensor(tip_b), torch.as_tensor(pmats)
    nt, R, S = tips.shape[0], pcfg.rate_cats, pcfg.states
    pool = torch.zeros((prog.pool_size, nt, R, S, TB))
    spool = torch.zeros((prog.pool_size, nt, 1, TB), dtype=torch.int32)
    shifts = torch.arange(S, dtype=torch.int32)[:, None]
    held = None
    for row in table.tolist():
        p, t1, s1, f1, t2, s2, f2, pm1, pm2, kind, store, keep = row
        k1, k2 = kinds[kind]
        assert (k1 == "tip") == bool(f1) and (k2 == "tip") == bool(f2)
        assert store + keep == 1

        def child(kind_name, tip, slot):
            if kind_name == "tip":
                bits = ((tips[:, tip, None, :] >> shifts) & 1).float()
                return bits[:, None].expand(nt, R, S, TB), 0
            if kind_name == "carried":
                return held
            return pool[slot], spool[slot]

        c1, sc1 = child(k1, t1, s1)
        c2, sc2 = child(k2, t2, s2)
        par = torch.einsum("rij,nrjt->nrit", pm[pm1], c1) \
            * torch.einsum("rij,nrjt->nrit", pm[pm2], c2)
        mask = (par < pcfg.scale_threshold).all(dim=2).all(dim=1,
                                                           keepdim=True)
        par = torch.where(mask[:, :, None], par * pcfg.scale_factor, par)
        scal = mask.to(torch.int32) + sc1 + sc2
        held = (par, scal) if keep else None
        if store:
            pool[p], spool[p] = par, scal
    slots = [slot for _, slot in prog.exports]
    want = run_port(pcfg, pprog, tip_b, pmats)
    assert torch.equal(pool[slots], want[0])
    assert torch.equal(spool[slots], want[1])


def test_pick_site_block_fills_the_card():
    """With the SM count both forms take the largest block that gives a
    CTA to 15/16 of the SMs, else the smallest; "mma" at most 64 sites on
    its small-span kernel, "fma" at most 256 threads (two sites a thread
    at four rates: 128 sites).  A call with no SM count keeps the largest
    block that fits."""
    _, _, pcfg, pprog, _, _ = build(caterpillar_newick(16), 256, 0)
    prog = pprog.vmem_prog
    pick = partials_tree.pick_site_block

    def at(sites):
        return dataclasses.replace(pcfg, sites=sites)
    limit = partials_tree.SMEM_LIMIT
    assert pick(prog, at(8192), limit, "mma", 132) == 64      # 128 CTAs
    assert pick(prog, at(65536), limit, "mma", 132) == 64     # the cap
    assert pick(prog, at(4096), limit, "mma", 132) == 32      # 128 CTAs
    assert pick(prog, at(2048), limit, "mma", 132) == 32      # none fills
    assert pick(prog, at(8192), limit, "mma", 16) == 64
    assert pick(prog, at(16384), limit, "fma", 132) == 128    # 128 CTAs
    assert pick(prog, at(8192), limit, "fma", 132) == 64      # 128 CTAs
    assert pick(prog, at(2048), limit, "fma", 132) == 32      # none fills
    for sites in (2048, 8192, 65536):
        assert pick(prog, at(sites), limit, "fma", 132) \
            == min(128, max(32, sites // 128))
        assert pick(prog, at(sites), limit, "mma") == 256
        assert pick(prog, at(sites), limit, "fma") == 128
    assert pick(prog, at(8192), 1024, "mma", 132) == 0
    assert pick(prog, at(8192), 1024, "fma", 132) == 0
    # span 80 (the general kernel) follows the fill rule without the cap;
    # an "fma" thread holds one site at 20 states
    aa = dataclasses.replace(at(65536), states=20)
    assert pick(prog, aa, limit, "mma", 132) == 256
    assert pick(prog, dataclasses.replace(aa, sites=8192), limit, "mma",
                132) == 64
    assert pick(prog, aa, limit, "fma", 132) == 64
    assert partials_tree.fma_threads(aa, 64) == 256
    assert partials_tree.choose(prog, at(65536), limit, 132) == (64, "mma")
    assert partials_tree.choose(prog, at(32768), limit, 132) == (128, "fma")
    # one rate: a site has one lane, so a 32-site block is half a warp
    one = dataclasses.replace(at(8192), rate_cats=1)
    assert 32 not in partials_tree.fitting_blocks(prog, one, limit, "fma")


SHAPES = {  # chip_smoke.py's four sweep shapes
    "dna_256": dict(n_tips=256, sites=65536),
    "dna_1024": dict(n_tips=1024, sites=16384),
    "large_8192": dict(n_tips=8192, sites=8192, random_tree=True),
    "protein_128": dict(n_tips=128, sites=16384, states=20)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fma_site_block_fills_the_card_at_the_four_shapes(shape):
    """`pick_site_block(..., "fma", sm_count=132)` at chip_smoke.py's four
    shapes gives at least SM_FILL * 132 CTAs (the pools allow it at all
    four) and fits an H100's shared memory; `choose` takes it with the
    "fma" form at three shapes, and "mma" at 256 taxa x 65,536 DNA sites."""
    spec = SHAPES[shape]
    n = spec["n_tips"]
    newick = random_newick(n, np.random.default_rng(8192)) \
        if spec.get("random_tree") else balanced_newick(n)
    tree = T.parse_newick_string(newick)
    cfg = PartitionConfig(
        tips=n, clv_buffers=tree.inner_count, states=spec.get("states", 4),
        sites=spec["sites"], rate_matrices=1, prob_matrices=2 * n - 3,
        rate_cats=4, scale_buffers=tree.inner_count, dtype=torch.float32,
        use_kernel=True)
    prog = engine.compile_tree(tree, cfg).vmem_prog
    tb = partials_tree.pick_site_block(prog, cfg, mode="fma", sm_count=132)
    assert cfg.sites_padded // tb >= partials_tree.SM_FILL * 132
    assert partials_tree.smem_bytes(prog, cfg, tb) <= partials_tree.SMEM_LIMIT
    assert partials_tree.fma_threads(cfg, tb) <= partials_tree.FMA_THREADS
    want = (partials_tree.pick_site_block(prog, cfg, mode="mma",
                                          sm_count=132), "mma") \
        if shape == "dna_256" else (tb, "fma")
    assert partials_tree.choose(prog, cfg, sm_count=132) == want


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("shape", sorted(CARRY_TREES))
def test_fma_device_table_runs_the_schedule(shape, carry):
    """The table the "fma" kernel reads (two 16-byte halves an op: tips and
    P-matrices for the copies ahead, slots and case for the op) holds the
    kinds and the hand-on column of `carry_flags`, and interpreted row by
    row as the kernel does gives the plain version's rows bit for bit."""
    _, _, pcfg, pprog, tip_b, pmats = build(CARRY_TREES[shape](), 128, 6,
                                            bl_scale=20.0)
    prog = pprog.vmem_prog
    table = partials_tree.fma_device_table(prog, carry)
    assert table.shape == (prog.n_ops, partials_tree.FMA_TABLE_COLS)
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"]
    flags = partials_tree.carry_flags(prog, enabled=carry)
    wide = partials_tree.mma_device_table(prog, carry)
    kinds = {v: k for k, v in partials_tree.KINDS.items()}
    case, keep = table[:, 7] // 2, table[:, 7] % 2
    np.testing.assert_array_equal(case, wide[:, 9])
    np.testing.assert_array_equal(keep, flags[:, 2])
    np.testing.assert_array_equal(1 - keep, flags[:, 1])
    carried = np.array([kinds[c][1] == "carried" for c in case])
    np.testing.assert_array_equal(carried, flags[:, 0] > 0)
    tip_kids = np.array([[k == "tip" for k in kinds[c]] for c in case])
    np.testing.assert_array_equal(table[:, :2] >= 0, tip_kids)
    if not carry:
        assert not keep.any() and not carried.any()
    tips, pm = torch.as_tensor(tip_b), torch.as_tensor(pmats)
    nt, R, S = tips.shape[0], pcfg.rate_cats, pcfg.states
    pool = torch.zeros((prog.pool_size, nt, R, S, TB))
    spool = torch.zeros((prog.pool_size, nt, 1, TB), dtype=torch.int32)
    shifts = torch.arange(S, dtype=torch.int32)[:, None]
    held = None
    for tip1, tip2, pm1, pm2, p, s1, s2, code in table.tolist():
        k1, k2 = kinds[code // 2]

        def child(kind_name, tip, slot):
            if kind_name == "tip":
                bits = ((tips[:, tip, None, :] >> shifts) & 1).float()
                return bits[:, None].expand(nt, R, S, TB), 0
            if kind_name == "carried":
                return held
            return pool[slot], spool[slot]

        c1, sc1 = child(k1, tip1, s1)
        c2, sc2 = child(k2, tip2, s2)
        par = torch.einsum("rij,nrjt->nrit", pm[pm1], c1) \
            * torch.einsum("rij,nrjt->nrit", pm[pm2], c2)
        mask = (par < pcfg.scale_threshold).all(dim=2).all(dim=1,
                                                           keepdim=True)
        par = torch.where(mask[:, :, None], par * pcfg.scale_factor, par)
        scal = mask.to(torch.int32) + sc1 + sc2
        if code % 2:
            held = (par, scal)
        else:
            held = None
            pool[p], spool[p] = par, scal
    slots = [slot for _, slot in prog.exports]
    want = run_port(pcfg, pprog, tip_b, pmats)
    assert torch.equal(pool[slots], want[0])
    assert torch.equal(spool[slots], want[1])


def test_fma_constants_match_the_kernel_source():
    """The host's copies of csrc/tree_sweep.cu's layout constants (sites a
    thread, ops ahead, the largest staged state count, threads a CTA, the
    table's width, the rates with a compile-time instantiation) are the
    kernel's own, so `smem_bytes` and `fitting_blocks` size what the kernel
    asks for."""
    import re
    from libpll2_tpu_torch import _build
    text = (_build.SOURCE_DIR / "tree_sweep.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("SITES_A_THREAD") == partials_tree.FMA_SITES_A_THREAD
    assert const("AHEAD") == partials_tree.FMA_AHEAD
    assert const("STAGE_P_MAX_STATES") == partials_tree.FMA_STAGE_P_MAX_STATES
    assert const("MAX_THREADS") == partials_tree.FMA_THREADS
    assert const("MAX_THREADS_ANY_RATES") == partials_tree.FMA_THREADS_ANY
    assert 4 * const("ROW_INT4") == partials_tree.FMA_TABLE_COLS
    assert "S <= 4 ? SITES_A_THREAD : 1" in text
    assert partials_tree.FMA_SITES_STATES == 4
    cases = re.findall(r"case (\d+): return launch<S, (\d+)>", text)
    assert tuple(int(r) for _, r in cases) == partials_tree.FMA_RATE_LANES
    assert "S == 4 ? 20 : S * S" in text
