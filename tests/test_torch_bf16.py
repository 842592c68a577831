"""bf16 CLV storage in the tree sweep against the JAX package on the CPU.

At `cfg.dtype == bfloat16` the JAX package runs its static Pallas kernels
at one split part: the pool holds bf16, products are summed in f32, the
rescue is decided on the f32 parent, the stored parent is rounded to bf16
and the exported rows are the f32 parent, unrounded.  The port's plain
version (partials_tree.sweep_reference, which both CUDA kernels are held
to on the card) follows the same rules.

  * (a, b) sweep_reference at bf16 against `sweep_static`,
    `sweep_static_segmented(seg_ops=8)` and `sweep(mode="splitk")` in
    interpret mode, at S in {4, 5, 20, 32}, per-site and per-rate scalers
    (the runtime-ops kernel keeps per-site scalers only), on a
    scale-heavy caterpillar: scaler rows exactly; CLV rows within 2^-7 of
    each site's largest entry.  Two bf16 sweeps whose f32 sums differ in
    the last bit can round a stored parent to neighbouring bf16 values, a
    step of 2^-8 relative; the bound is twice that.  (Measured on these
    cases: at most 4.3e-5, at 20 states.)
  * (c) sweep_reference with the register carry honoured is bit-equal to
    the one that stores every parent: a handed-on parent is rounded as a
    stored one.
  * (d) pmatrix_fragments_reference at bf16 against the fragment layouts
    of mma.m16n8k16 written out from the block-diagonal P.
  * (e) the slice: engine.loglikelihood at bf16 with use_kernel=True on
    CPU tensors (kernel_choice takes a form; the wrapper runs the plain
    sweep) against the JAX engine.loglikelihood at bf16 with
    use_pallas=True inside pltpu.force_tpu_interpret_mode(), at 24 and 120
    tips: within 2e-5 relative of each other and each within 3e-4 of the
    f64 value (tests/test_memory.py's budget); one optimize_root_branch
    (f32 branch lengths: the JAX Newton loop carries the lengths' type
    and refuses a bf16 one) held the same way, its branch within 1e-3
    relative and its logL within 2e-5.  The model is carried across by
    convert.model_from_jax.
  * (f) the gate: for every S from 2 to 32, neither form refuses a small
    bf16 case ("mma" at MMA_CASES), `choose` returns a form, and f64 is
    still refused with a reason that names f32 and bf16.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import libpll2_tpu as pll
from libpll2_tpu import engine as jengine
from libpll2_tpu import tree as jtree
from libpll2_tpu.config import PartitionConfig as JConfig
from libpll2_tpu.ops import partials_pallas_tree as ppt
from libpll2_tpu.ops import pmatrix as jpmatrix
from libpll2_tpu_torch import convert, engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import partials_tree
from libpll2_tpu_torch.tree.generate import random_newick, random_tipchars

from .test_parity_tree import random_newick as parity_newick
from .test_parity_tree import random_seqs
from .test_torch_host import caterpillar_newick
from .test_torch_oddstates import configs, random_model

TB = 128
CPU = torch.device("cpu")
ROW_BOUND = 2.0 ** -7        # of each site's largest entry
SLICE_RTOL = 2e-5            # port against the JAX bf16 kernel path
F64_BUDGET = 3e-4            # bf16 logL against f64 (tests/test_memory.py)
BRANCH_RTOL = 1e-3
SWEEP_STATES = (4, 5, 20, 32)


def bf16_tensor(a) -> torch.Tensor:
    """A JAX bf16 array (or its numpy copy) as a torch bf16 tensor: the
    widening to f32 and back is exact."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


@functools.cache
def sweep_build(states, per_rate, n=24, sites=256, bl_scale=30.0):
    """Both packages' programs and shared inputs at bf16 on an n-taxon
    caterpillar with branch lengths x bl_scale: blocked tips [NT, tips,
    TB] and the P-matrix buffer, computed in f32 and rounded to bf16 once,
    as a JAX bf16 array."""
    seed = states
    rng = np.random.default_rng(seed)
    newick = caterpillar_newick(n)
    jt, pt = jtree.parse_newick_string(newick), T.parse_newick_string(newick)
    common = configs(pt, states, sites, per_rate_scalers=per_rate)
    jcfg = JConfig(**common, dtype=jnp.bfloat16)
    pcfg = PartitionConfig(**common, dtype=torch.bfloat16)
    jprog = jengine.compile_tree(jt, jcfg)
    pprog = engine.compile_tree(pt, pcfg)
    subst, freqs = random_model(states, seed)
    model = jengine.make_model([subst], [freqs],
                               pll.compute_gamma_cats(0.8, 4),
                               dtype=jnp.float32)
    tipchars = jengine.pad_tipchars(
        random_tipchars(n, sites, rng, states=states), jcfg)
    nt = jcfg.sites_padded // TB
    tip_b = np.ascontiguousarray(
        tipchars.reshape(n, nt, TB).transpose(1, 0, 2))
    num_slots = int(jprog.pmatrix_indices.max()) + 1
    new = jpmatrix.compute_pmatrices(
        jnp.asarray(jprog.default_branch_lengths * bl_scale, jnp.float32),
        model.eigenvals, model.eigenvecs, model.inv_eigenvecs, model.rates,
        model.prop_invar, model.params_indices, dtype=jnp.float32)
    pmats = jnp.zeros((num_slots, 4, states, states), jnp.float32).at[
        jnp.asarray(jprog.pmatrix_indices)].set(new).astype(jnp.bfloat16)
    return jcfg, jprog, pcfg, pprog, tip_b, pmats


@functools.cache
def port_rows(states, per_rate, carry=False):
    _, _, pcfg, pprog, tip_b, pmats = sweep_build(states, per_rate)
    return partials_tree.sweep_reference(
        torch.as_tensor(tip_b), bf16_tensor(pmats), pprog.vmem_prog, pcfg,
        TB, carry=carry)


def assert_rows_within(got, want):
    """Scaler rows equal; CLV rows [E, NT, R, S, TB] within ROW_BOUND of
    each site's largest entry (over its rates and states)."""
    clv, scal = got
    np.testing.assert_array_equal(scal.numpy(), np.asarray(want[1]))
    assert clv.dtype == torch.float32
    g = clv.double().numpy()
    w = np.asarray(want[0], np.float64)
    mag = np.abs(w).max(axis=(2, 3), keepdims=True)
    assert (mag > 0).all()
    assert (np.abs(g - w) / mag).max() <= ROW_BOUND


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", SWEEP_STATES)
def test_sweep_reference_matches_static_bf16(states, per_rate):
    """(a): the static kernel at one split part, in interpret mode."""
    jcfg, jprog, _, _, tip_b, pmats = sweep_build(states, per_rate)
    assert ppt._parts_for(jcfg) == 1
    want = ppt.sweep_static(jnp.asarray(tip_b), pmats, jprog.vmem_prog,
                            jcfg, TB, interpret=True)
    got = port_rows(states, per_rate)
    assert got[1].shape[2] == (4 if per_rate else 1)
    assert int(got[1].max()) > 0                 # rescues fired
    assert_rows_within(got, want)


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", SWEEP_STATES)
def test_sweep_reference_matches_segmented_bf16(states, per_rate):
    """(b): the segmented static kernel, segments of 8 ops (live slots
    carried between segments through HBM as bf16 slabs)."""
    jcfg, jprog, _, _, tip_b, pmats = sweep_build(states, per_rate)
    want = ppt.sweep_static_segmented(jnp.asarray(tip_b), pmats,
                                      jprog.vmem_prog, jcfg, TB,
                                      interpret=True, seg_ops=8)
    assert_rows_within(port_rows(states, per_rate), want)


@pytest.mark.parametrize("states", SWEEP_STATES)
def test_sweep_reference_matches_splitk_bf16(states):
    """(b): the runtime-ops kernel's "splitk" mode at one part (per-site
    scalers, the only ones it keeps)."""
    jcfg, jprog, _, _, tip_b, pmats = sweep_build(states, False)
    want = ppt.sweep(jnp.asarray(tip_b), pmats, jprog.vmem_prog, jcfg, TB,
                     mode="splitk", interpret=True)
    assert_rows_within(port_rows(states, False), want)


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", SWEEP_STATES)
def test_carry_is_bit_equal_at_bf16(states, per_rate):
    """(c): a parent handed on in registers is rounded to bf16 as a stored
    one, so the rows do not depend on the carry; the pool is bf16, the
    exported rows f32."""
    _, _, _, pprog, _, _ = sweep_build(states, per_rate)
    flags = partials_tree.carry_flags(pprog.vmem_prog)
    assert (flags[:, 0] > 0).any()              # some parents handed on
    on, off = port_rows(states, per_rate, True), port_rows(states, per_rate)
    assert on[0].dtype == torch.float32
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


def block_diagonal(pm):
    """[P, R, S, S] -> [P, R*S, R*S] f32 with the rate blocks on the
    diagonal."""
    return torch.stack([torch.block_diag(*p.float()) for p in pm])


@pytest.mark.parametrize("states, rates", partials_tree.MMA_CASES)
def test_pmatrix_fragments_bf16_layout(states, rates):
    """(d): every bf16 register of the "mma" kernel's P operand, written
    out from the PTX fragment layouts of mma.m16n8k16 (the lower index in
    the low half).  Small span: P^T is B, b0 holds k = 2q, 2q + 1 and b1
    k = 2q + 8, 2q + 9 of n-tile j's column g.  General: the 16 x 16
    tiles of the block-diagonal P that meet a rate block are A, in
    row-major order, a0 (row g, cols 2q, 2q + 1), a1 (row g + 8), a2
    (cols + 8), a3 (both)."""
    rng = np.random.default_rng(states)
    pm = torch.as_tensor(rng.random((3, rates, states, states)),
                         dtype=torch.float32).to(torch.bfloat16)
    cfg = PartitionConfig(tips=4, clv_buffers=2, states=states, sites=64,
                          rate_matrices=1, prob_matrices=5,
                          rate_cats=rates, scale_buffers=2,
                          dtype=torch.bfloat16)
    got = partials_tree.pmatrix_fragments_reference(pm, cfg)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    pbd = block_diagonal(pm)
    span = rates * states
    want = []
    for lane in range(32):
        g, q = lane // 4, lane % 4
        if (states, rates) in partials_tree.MMA_CARRY_CASES:
            want.append([[[pbd[:, 8 * j + g, 2 * q + 8 * r + h]
                           for h in range(2)] for r in range(2)]
                         for j in range(span // 8)])
    if want:
        want = torch.stack([torch.stack([torch.stack([torch.stack(h)
                                                      for h in r])
                                         for r in j]) for j in want])
        # [32, NT, 2, 2, P] -> [P, 32, NT, 2, 2]
        want = want.permute(4, 0, 1, 2, 3)
    else:
        tiles = []
        for mt in range(span // 16):
            for ks in range(span // 16):
                rows = torch.arange(16 * mt, 16 * mt + 16) // states
                cols = torch.arange(16 * ks, 16 * ks + 16) // states
                if not (rows[:, None] == cols[None, :]).any():
                    continue
                tiles.append(torch.stack([torch.stack([torch.stack([
                    pbd[:, 16 * mt + lane // 4 + 8 * (r % 2),
                        16 * ks + 2 * (lane % 4) + 8 * (r // 2) + h]
                    for h in range(2)]) for r in range(4)])
                    for lane in range(32)]))
        want = torch.stack(tiles).permute(4, 0, 1, 2, 3)  # [P, NP, 32, 4, 2]
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got.float(), want)


# --------------------------------------------------------------------------
# (e) the slice
# --------------------------------------------------------------------------

SUBST, FREQS = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0], [0.3, 0.25, 0.2, 0.25]


def port_model(jmodel):
    """The JAX Model carried across: bf16 fields widened to f32 for
    convert.model_from_jax, then narrowed back (both exact)."""
    arrays = {k: v.astype(np.float32) if v.dtype.name == "bfloat16" else v
              for k, v in convert.model_arrays(jmodel).items()}
    model = convert.model_from_jax(arrays, device="cpu")
    return engine.Model(*(
        getattr(model, f).to(torch.bfloat16)
        if np.asarray(convert.model_arrays(jmodel)[f]).dtype.name
        == "bfloat16" else getattr(model, f) for f in engine.Model.FIELDS))


@functools.cache
def slice_results(tips):
    """{dtype name: (JAX logL, port logL, JAX optimize_root_branch (logL,
    root branch), the port's)} on tests/test_memory.py's case (random tree,
    256 sites, GTR + Gamma4(0.8)); the JAX bf16 path in interpret mode."""
    rng = np.random.default_rng(tips)
    sites = 256
    newick = parity_newick(tips, rng)
    seqs = random_seqs(tips, sites, rng)
    raw = np.zeros((tips, sites), dtype=np.uint64)
    for i, s in enumerate(seqs):
        raw[i] = pll.MAP_NT[np.frombuffer(s.encode(), np.uint8)]
    out = {}
    for name, jdt, tdt in (("f64", jnp.float64, torch.float64),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        bf16 = name == "bf16"
        jt, pt = jtree.parse_newick_string(newick), \
            T.parse_newick_string(newick)
        common = dict(tips=tips, clv_buffers=pt.inner_count, states=4,
                      sites=sites, rate_matrices=1,
                      prob_matrices=2 * tips - 3, rate_cats=4,
                      scale_buffers=pt.inner_count)
        jcfg = JConfig(**common, dtype=jdt, use_pallas=bf16)
        pcfg = PartitionConfig(**common, dtype=tdt, use_kernel=bf16)
        jprog, pprog = jengine.compile_tree(jt, jcfg), \
            engine.compile_tree(pt, pcfg)
        assert convert.program_mismatches(pprog, jprog) == []
        jmodel = jengine.make_model([SUBST], [FREQS],
                                    pll.compute_gamma_cats(0.8, 4), dtype=jdt)
        pmodel = port_model(jmodel)
        if bf16:
            # the kernel path on CPU tensors: a form is chosen and the
            # wrapper runs the plain sweep
            assert engine.kernel_choice(pprog, pcfg, CPU) is not None
        tipchars = jengine.pad_tipchars(raw, jcfg)
        pw = np.zeros(jcfg.sites_padded)
        pw[:sites] = 1.0
        inv = np.full(jcfg.sites_padded, -1, np.int32)
        bl = jprog.default_branch_lengths
        jargs = (jnp.asarray(tipchars), jnp.asarray(pw, jdt),
                 jnp.asarray(inv))
        pargs = (torch.as_tensor(tipchars), torch.as_tensor(pw).to(tdt),
                 torch.as_tensor(inv))
        bl_dt = jnp.float32 if bf16 else jdt
        root = int(np.nonzero(pprog.pmatrix_indices
                              == pprog.root_pmatrix)[0][0])
        with pltpu.force_tpu_interpret_mode():
            jl = float(jengine.loglikelihood(
                jprog, jcfg, jmodel, jnp.asarray(bl, jdt), *jargs))
            jbl, jl0 = jengine.optimize_root_branch(
                jprog, jcfg, jmodel, jnp.asarray(bl, bl_dt), *jargs)
        pl = engine.loglikelihood(pprog, pcfg, pmodel,
                                  torch.as_tensor(bl).to(tdt), *pargs).item()
        pbl, pl0 = engine.optimize_root_branch(
            pprog, pcfg, pmodel,
            torch.as_tensor(bl).to(torch.float32 if bf16 else tdt), *pargs)
        out[name] = (jl, pl, (float(jl0), float(np.asarray(jbl)[root])),
                     (pl0.item(), pbl[root].item()))
    return out


@pytest.mark.parametrize("tips", [24, 120])
def test_slice_loglikelihood_bf16(tips):
    out = slice_results(tips)
    f64 = out["f64"][0]
    np.testing.assert_allclose(out["f64"][1], f64, rtol=1e-9)
    jl, pl = out["bf16"][:2]
    assert abs(pl - jl) <= SLICE_RTOL * abs(jl)
    assert abs(jl - f64) <= F64_BUDGET * abs(f64)
    assert abs(pl - f64) <= F64_BUDGET * abs(f64)


@pytest.mark.parametrize("tips", [24, 120])
def test_slice_optimize_root_branch_bf16(tips):
    (jl0, jbranch), (pl0, pbranch) = slice_results(tips)["bf16"][2:]
    assert abs(pl0 - jl0) <= SLICE_RTOL * abs(jl0)
    assert abs(pbranch - jbranch) <= BRANCH_RTOL * abs(jbranch)
    assert np.isfinite(pbranch) and pbranch > 0


# --------------------------------------------------------------------------
# (f) the gate
# --------------------------------------------------------------------------

def gate_case(states, dtype=torch.bfloat16, n=6, sites=64):
    tree = T.parse_newick_string(random_newick(n, np.random.default_rng(0)))
    cfg = PartitionConfig(**configs(tree, states, sites), dtype=dtype)
    return cfg, engine.compile_tree(tree, cfg).vmem_prog


@pytest.mark.parametrize("states", range(partials_tree.MIN_STATES,
                                         partials_tree.MAX_STATES + 1))
def test_kernels_take_bf16_at_every_state_count(states):
    cfg, prog = gate_case(states)
    assert partials_tree.unsupported(prog, cfg, mode="fma") is None
    mma = partials_tree.unsupported(prog, cfg, mode="mma")
    assert (mma is None) == ((states, 4) in partials_tree.MMA_CASES)
    assert partials_tree.choose(prog, cfg) is not None
    # the bf16 pool takes half the f32 pool's bytes; scalers stay int32
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    assert partials_tree.smem_bytes(prog, cfg, 64) \
        < partials_tree.smem_bytes(prog, f32, 64)
    f64 = dataclasses.replace(cfg, dtype=torch.float64)
    for mode in partials_tree.MODES:
        reason = partials_tree.unsupported(prog, f64, mode=mode)
        assert "f32" in reason and "bf16" in reason
    assert partials_tree.choose(prog, f64) is None


def test_bf16_pool_bytes():
    """A bf16 pool entry is 2 bytes in both forms, a scaler entry 4: the
    f32 footprint less half its CLV pool."""
    cfg, prog = gate_case(4)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    tb = 64
    lanes = partials_tree.rate_lanes(cfg.rate_cats)
    half_fma = prog.pool_size * lanes * cfg.states * tb * 2
    assert partials_tree.smem_bytes(prog, cfg, tb) \
        == partials_tree.smem_bytes(prog, f32, tb) - half_fma
    half_mma = prog.pool_size * cfg.span * tb * 2
    assert partials_tree.smem_bytes(prog, cfg, tb, "mma") \
        == partials_tree.smem_bytes(prog, f32, tb, "mma") - half_mma


def test_wrapper_on_cpu_runs_the_bf16_rules():
    """On CPU tensors the wrapper runs the plain version, whose pool takes
    the P buffer's type: a bf16 buffer gives the bf16 rules, with the
    register carry on (the wrapper's default) as off, and no launch."""
    _, _, pcfg, pprog, tip_b, pmats = sweep_build(4, False)
    before = dict(partials_tree.sweep.launches_bf16)
    got = partials_tree.sweep(torch.as_tensor(tip_b), bf16_tensor(pmats),
                              pprog.vmem_prog, pcfg, TB)
    assert partials_tree.sweep.launches_bf16 == before
    want = port_rows(4, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
