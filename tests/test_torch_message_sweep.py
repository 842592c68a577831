"""The all-directions message sweep's kernel path (ops/message_sweep.py,
csrc/message_sweep.cu, engine.message_sweep).

On the CPU: the kernel's plain version against the JAX package's
all-directions sweep (libpll2_tpu.engine._sweep_all) on the same
P-matrices, and against the dense path (ops/partials.update_partials) over
the same program, fed the program's own table and the search's padded
int64 program; the choice between kernel and dense path
(`engine.message_sweep_choice`); the counters; the host side of a launch
(table cache, plan, byte counts, the .cu's thread limits).

On the card (marked `cuda`, skipped without one): the kernel's rows and
scalers against the plain version at the benchmark's shapes, one launch a
sweep, the smoothing and an SPR round on the kernel, and the launches the
kernel refuses.  The JAX package runs on the CPU only, so the kernel meets
it through the plain version.  On a GPU machine:

    python -m pytest tests/test_torch_message_sweep.py -m cuda
"""
import dataclasses
import re
import types
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from libpll2_tpu_torch import convert, engine, multipartition, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import message_sweep as ms
from libpll2_tpu_torch.tree.generate import random_newick, random_tipchars

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
# reference against the dense path: the same batched products over the
# same rows, only the padding rows left out of each batch; a batch's shape
# may change the order of a product's sums, so f32 rows agree to a few
# ulps
RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def case(tips, states=4, rates=4, per_rate=False, dtype=torch.float64,
         bl_scale=1.0, sites=48, seed=0, use_kernel=None, device=CPU):
    newick = random_newick(tips, np.random.default_rng(seed))
    return chip_smoke.message_inputs(newick, sites, seed + 1, device,
                                     states=states, rates=rates,
                                     per_rate=per_rate, bl_scale=bl_scale,
                                     dtype=dtype, use_kernel=use_kernel)


def dense(full, pmatrix, tipchars, level_ops=None):
    """The dense path's sweep of `level_ops` (the program's own by
    default) on rows as engine.message_sweep initialises them."""
    cfg = dataclasses.replace(full.cfg_ext, use_kernel=False)
    return engine.message_sweep(
        cfg, None, full.level_ops if level_ops is None else level_ops,
        pmatrix, tipchars)


def assert_same_messages(got, got_s, want, want_s, cfg_ext, rtol):
    """Every row but the scratch rows (which the dense path's padding rows
    write and the kernel's walk leaves at zero)."""
    n, z = cfg_ext.num_clvs, cfg_ext.scaler_scratch
    torch.testing.assert_close(got[:n], want[:n], rtol=rtol, atol=0)
    torch.testing.assert_close(got_s[:z], want_s[:z], rtol=0, atol=0)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("rates", [1, 4])
@pytest.mark.parametrize("states", [4, 20])
@pytest.mark.parametrize("tips", [8, 24, 64])
def test_reference_matches_update_partials(tips, states, rates, per_rate,
                                           dtype, heavy):
    """The kernel's walk in plain torch over the program's table equals
    the dense level-batched path on every message, tip and scaler row;
    with long branches (heavy) at f32 the rescues fire."""
    cfg, full, model, bl, tipchars, pmatrix = case(
        tips, states, rates, per_rate, dtype, bl_scale=30.0 if heavy else 1,
        seed=tips + states)
    got, got_s = ms.sweep_messages_reference(full.level_ops_tensor(CPU),
                                             pmatrix, tipchars, full.cfg_ext)
    want, want_s = dense(full, pmatrix, tipchars)
    assert_same_messages(got, got_s, want, want_s, full.cfg_ext, RTOL[dtype])
    assert (got[full.cfg_ext.clv_scratch] == 0).all()
    assert (got_s[full.cfg_ext.scaler_zero:] == 0).all()
    if heavy and dtype == torch.float32:
        assert int(want_s.max()) > 0


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [4, 20])
@pytest.mark.parametrize("tips", [8, 40])
def test_reference_reads_the_padded_search_program(tips, states, per_rate):
    """The search's runtime program: [L, W, 8] int64 with padding rows in
    every level and whole padding levels (search_fast._pad_level_ops with a
    larger floor).  The walk skips them and equals both its walk of the
    program's own table and the dense path over the padded program."""
    cfg, full, model, bl, tipchars, pmatrix = case(
        tips, states, 4, per_rate, torch.float32, bl_scale=20.0,
        seed=3 * tips + states)
    L, W, _ = full.level_ops.shape
    padded = torch.as_tensor(search_fast._pad_level_ops(
        full.level_ops, full.cfg_ext, min_shape=(L + 3, W + 5))).long()
    assert padded.shape[0] > L and padded.shape[1] > W
    got, got_s = ms.sweep_messages_reference(padded, pmatrix, tipchars,
                                             full.cfg_ext)
    own, own_s = ms.sweep_messages_reference(full.level_ops, pmatrix,
                                             tipchars, full.cfg_ext)
    assert torch.equal(got, own) and torch.equal(got_s, own_s)
    want, want_s = dense(full, pmatrix, tipchars, padded)
    assert_same_messages(got, got_s, want, want_s, full.cfg_ext, RTOL[
        torch.float32])


def jax_sweep(tips, states, per_rate, dtype, bl_scale, sites=96, seed=0):
    """(port cfg_ext, port table, P-matrices, tipchars, JAX rows, JAX
    scalers): libpll2_tpu.engine._sweep_all of a random tree and model on
    the CPU, with the P-matrices it computed, as torch tensors."""
    import jax.numpy as jnp

    import libpll2_tpu as pll
    from libpll2_tpu import engine as jengine
    from libpll2_tpu import tree as jtree
    from libpll2_tpu.config import PartitionConfig as JConfig

    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    rng = np.random.default_rng(seed)
    newick = random_newick(tips, rng)
    pt = T.parse_newick_string(newick)
    common = dict(tips=tips, clv_buffers=pt.inner_count, states=states,
                  sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3,
                  rate_cats=4, scale_buffers=pt.inner_count,
                  per_rate_scalers=per_rate)
    jcfg = JConfig(**common, dtype=jdt)
    pfull = engine.compile_tree_full(pt, PartitionConfig(**common,
                                                         dtype=dtype))
    jfull = jengine.compile_tree_full(jtree.parse_newick_string(newick),
                                      jcfg)
    assert convert.full_program_mismatches(pfull, jfull) == []
    model = jengine.make_model(
        [rng.uniform(0.2, 3.0, states * (states - 1) // 2)],
        [rng.dirichlet(np.full(states, 5.0))], pll.compute_gamma_cats(0.8, 4),
        dtype=jdt)
    tipchars = jengine.pad_tipchars(
        random_tipchars(tips, sites, rng, states=states), jcfg)
    clv, scalers, pmatrix = jengine._sweep_all(
        jfull, jcfg, model, jnp.asarray(jfull.default_branch_lengths
                                        * bl_scale, jdt),
        jnp.asarray(tipchars))
    return (pfull.cfg_ext, pfull.level_ops_tensor(CPU),
            torch.as_tensor(np.array(pmatrix)), torch.as_tensor(tipchars),
            torch.as_tensor(np.array(clv)),
            torch.as_tensor(np.array(scalers)))


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("states", [4, 20])
def test_reference_matches_the_jax_sweep(states, per_rate, dtype, heavy):
    """The kernel's plain version equals the JAX package's all-directions
    sweep (libpll2_tpu.engine._sweep_all) on the P-matrices that sweep
    computed, at the DNA and LG state counts: f64 rows to 1e-12, f32 rows
    scaling-compensated to CLV_RTOL (XLA's sums run in another order; the
    bound the card tests hold the kernel to), scalers equal; with long
    branches (heavy) the f32 rescues fire."""
    cfg_ext, table, pmatrix, tipchars, want, want_s = jax_sweep(
        24 if states == 4 else 16, states, per_rate, dtype,
        30.0 if heavy else 1.0, seed=states + 2 * per_rate)
    got, got_s = ms.sweep_messages_reference(table, pmatrix, tipchars,
                                             cfg_ext)
    if dtype == torch.float64:
        assert_same_messages(got, got_s, want, want_s, cfg_ext, 1e-12)
    rel, mismatches, reserved = chip_smoke.compare_messages(
        got, want, got_s, want_s, cfg_ext)
    assert mismatches == 0 and reserved
    assert rel < (1e-12 if dtype == torch.float64 else chip_smoke.CLV_RTOL)
    if heavy and dtype == torch.float32:
        assert int(want_s.max()) > 0


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("states", [4, 20, 5, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("use_kernel", [None, False, True])
@pytest.mark.parametrize("device", [CPU, CUDA])
def test_choice_follows_the_call(device, use_kernel, dtype, states, grad):
    """The kernel runs on a CUDA device, at f32, 2-32 states and at most 32
    rates, with no input needing grad, unless use_kernel is False.  The
    CPU always runs the dense path, silently.  A refused case on the card:
    the dense path with one warning naming the reason under None, a
    ValueError under True.  (No card is needed: the choice reads the
    device's type only.)"""
    cfg = dataclasses.replace(case(8)[1].cfg_ext, dtype=dtype,
                              use_kernel=use_kernel)
    object.__setattr__(cfg, "states", states)
    takes = dtype == torch.float32 and states <= ms.MAX_STATES and not grad
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if device.type == "cuda" and use_kernel is True and not takes:
            with pytest.raises(ValueError, match="message-sweep kernel"):
                engine.message_sweep_choice(cfg, device, grad)
            return
        got = engine.message_sweep_choice(cfg, device, grad)
    kernel = device.type == "cuda" and use_kernel is not False and takes
    assert got is kernel
    warned = device.type == "cuda" and use_kernel is None and not takes
    assert len(caught) == int(warned)
    if warned:
        reason = ms.unsupported(cfg) or "requires grad"
        assert reason in str(caught[0].message)


def test_unsupported_names_each_limit():
    cfg = case(8, dtype=torch.float32)[1].cfg_ext
    assert ms.unsupported(cfg) is None
    assert "f32" in ms.unsupported(dataclasses.replace(
        cfg, dtype=torch.float64))
    many = dataclasses.replace(cfg)
    object.__setattr__(many, "rate_cats", 33)
    assert "33 rate categories" in ms.unsupported(many)


def test_cpu_calls_count_as_dense_sweeps():
    """engine.message_sweep on CPU tensors takes the dense path, under
    every use_kernel, and counts it; the kernel's counters stay."""
    for use_kernel in (None, True, False):
        cfg, full, model, bl, tipchars, _ = case(
            12, dtype=torch.float32, use_kernel=use_kernel)
        before = (engine.message_sweep.dense_sweeps,
                  engine.message_sweep.kernel_sweeps,
                  ms.sweep_messages.launches)
        engine.branch_derivatives(full, cfg, model, bl, tipchars,
                                  torch.ones(cfg.sites_padded),
                                  torch.full((cfg.sites_padded,), -1,
                                             dtype=torch.int32))
        assert (engine.message_sweep.dense_sweeps,
                engine.message_sweep.kernel_sweeps,
                ms.sweep_messages.launches) == (before[0] + 1, before[1],
                                                before[2])


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_sweeps_follow_the_calls_use_kernel(monkeypatch, use_kernel):
    """_sweep_all decides on the call's use_kernel, not on the one its
    program was compiled with (the smoothing's use_kernel=False on a
    program of the default config takes the dense path on the card)."""
    cfg, full, model, bl, tipchars, _ = case(12, dtype=torch.float32)
    assert full.cfg_ext.use_kernel is None
    seen = []
    choice = engine.message_sweep_choice
    monkeypatch.setattr(engine, "message_sweep_choice",
                        lambda c, *a: seen.append(c.use_kernel)
                        or choice(c, *a))
    engine._sweep_all(full, dataclasses.replace(cfg, use_kernel=use_kernel),
                      model, bl, tipchars)
    assert seen == [use_kernel]


def test_level_ops_tensor_and_its_cache():
    """The program caches its table as int64 per device; the JAX
    comparison leaves the cache out; the per-partition programs of a
    multi-partition set each have a cache of their own."""
    full = case(30)[1]
    got = full.level_ops_tensor(CPU)
    assert got is full.level_ops_tensor(CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), full.level_ops)
    # a JAX program has no cache: the comparison reads every other field
    fields = {f.name: getattr(full, f.name)
              for f in dataclasses.fields(full) if f.name != "_device"}
    c = full.cfg_ext
    fields["cfg_ext"] = types.SimpleNamespace(
        **{f.name: getattr(c, f.name) for f in dataclasses.fields(c)})
    fields["cfg_ext"].dtype = np.dtype(str(c.dtype).removeprefix("torch."))
    assert convert.full_program_mismatches(
        full, types.SimpleNamespace(**fields)) == []
    tree = T.parse_newick_string(random_newick(10,
                                               np.random.default_rng(2)))
    cfgs = [dataclasses.replace(case(10)[0], sites=s) for s in (40, 56)]
    mp = multipartition.compile_multipartition(tree, cfgs)
    assert mp.fulls[0]._device is not mp.fulls[1]._device


def test_sweep_messages_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises: CPU tensors raise, and
    no launch is counted."""
    cfg, full, model, bl, tipchars, pmatrix = case(16, dtype=torch.float32)
    before = ms.sweep_messages.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.sweep_messages(full.level_ops_tensor(CPU), pmatrix, tipchars,
                          full.cfg_ext)
    assert ms.sweep_messages.launches == before


def test_thread_limits_match_the_kernel_source():
    """max_threads' constants are copies of csrc/message_sweep.cu's."""
    text = (ms.__file__.rsplit("/ops/", 1)[0]
            + "/csrc/message_sweep.cu")
    src = open(text).read()
    for name in ("THREADS_SMALL", "THREADS_20", "THREADS_LARGE"):
        value = re.search(rf"constexpr int {name} = (\d+);", src)
        assert value and int(value.group(1)) == getattr(ms, name), name


@pytest.mark.parametrize("sites", [1, 100, 4096, 16384, 413459])
@pytest.mark.parametrize("states", [2, 4, 5, 8, 9, 20, 32])
def test_plan_fits_the_kernel(states, sites):
    """Every rate count: a group is whole warps of whole sites, the CTA
    within the state count's thread limit, the blocks cover the sites."""
    for rates in range(1, 33):
        tb, groups = ms.plan(rates, states, sites)
        per_group = tb * ms.rate_lanes(rates)
        assert per_group % 32 == 0
        assert 1 <= groups <= ms.MAX_GROUPS
        assert groups * per_group <= ms.max_threads(states)
        assert -(-sites // tb) * tb >= sites


def test_plan_fills_the_card_at_the_benchmark_shapes():
    """At 4,096 DNA sites and at 16,384 protein sites the blocks number at
    least the SM count; a block's sites double only while they still do."""
    for rates, states, sites in ((4, 4, 4096), (4, 20, 16384)):
        tb, groups = ms.plan(rates, states, sites)
        assert -(-sites // tb) >= ms.SM_COUNT
        assert -(-sites // (2 * tb)) < ms.SM_COUNT or \
            2 * tb * ms.rate_lanes(rates) > ms.max_threads(states)
    assert ms.plan(4, 4, 4096) == (16, 8)


def test_sweep_bytes_counts_each_operand_once():
    """Against a row-by-row count of a small program: least, each input
    read and each output written once; traffic, least plus every op's
    reads of its children."""
    cfg, full, *_ = case(10, dtype=torch.float32, sites=64)
    c = full.cfg_ext
    row, mask, scaler = 4 * 4 * 64 * 4, 64 * 4, 64 * 4
    least, reads, named = c.tips * (row + mask) + row + 2 * scaler, 0, set()
    for op in full.level_ops.reshape(-1, 8):
        if op[0] == c.clv_scratch:
            continue
        least += row + scaler
        reads += sum(mask if child < c.tips else row for child in op[1:3])
        named |= {int(op[3]), int(op[4])}
    # every branch's P-matrix is named by some message
    assert len(named) == 2 * c.tips - 3
    least += len(named) * 4 * 16 * 4
    assert ms.sweep_bytes(full.level_ops, c, 64) == (least, least + reads)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CUDA


CARD_CASES = {
    # name: (newick, sites, states, rates, per_rate, bl_scale, padded)
    "dna_256x4096": ("random256", 4096, 4, 4, False, 1.0, False),
    "dna_256x4096_padded": ("random256", 4096, 4, 4, False, 1.0, True),
    "dna_per_rate_heavy": ("random90", 2000, 4, 4, True, 30.0, False),
    "dna_heavy_ragged": ("random90", 1001, 4, 4, False, 30.0, True),
    "lg_128x16384": ("balanced128", 16384, 20, 4, False, 1.0, False),
    "lg_per_rate_heavy": ("random60", 3000, 20, 4, True, 20.0, True),
    "one_rate": ("random60", 2048, 4, 1, False, 10.0, False),
    "three_rates": ("random60", 2048, 4, 3, False, 10.0, True),
    "states_2": ("random60", 2048, 2, 4, False, 10.0, False),
    "states_5": ("random60", 2048, 5, 4, True, 10.0, False),
    "states_10": ("random60", 1024, 10, 8, False, 10.0, False),
    "states_32": ("random60", 1024, 32, 4, False, 10.0, True),
}


def card_newick(name):
    if name.startswith("balanced"):
        from libpll2_tpu_torch.tree.generate import balanced_newick
        return balanced_newick(int(name[len("balanced"):]))
    return random_newick(int(name[len("random"):]),
                         np.random.default_rng(1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_plain(cuda_device, name):
    """Rows within CLV_RTOL of the plain version (f32 sums in another
    order; scaling-compensated as chip_smoke.compare_rows), scalers exact,
    tip and reserved rows equal; one launch a sweep through
    engine.message_sweep, counted as a kernel sweep."""
    newick, sites, states, rates, per_rate, bl_scale, padded = \
        CARD_CASES[name]
    cfg, full, model, bl, tipchars, pmatrix = chip_smoke.message_inputs(
        card_newick(newick), sites, 5, cuda_device, states=states,
        rates=rates, per_rate=per_rate, bl_scale=bl_scale)
    cfg_ext = full.cfg_ext
    if padded:
        L, W, _ = full.level_ops.shape
        table = torch.as_tensor(search_fast._pad_level_ops(
            full.level_ops, cfg_ext, min_shape=(L + 2, W + 3)),
            device=cuda_device).long()
    else:
        table = full.level_ops_tensor(cuda_device)
    launches = ms.sweep_messages.launches
    sweeps = engine.message_sweep.kernel_sweeps
    got, got_s = engine.message_sweep(cfg_ext, model, table, pmatrix,
                                      tipchars)
    torch.cuda.synchronize()
    assert ms.sweep_messages.launches == launches + 1
    assert engine.message_sweep.kernel_sweeps == sweeps + 1
    want, want_s = ms.sweep_messages_reference(table, pmatrix, tipchars,
                                               cfg_ext)
    rel, mismatches, reserved = chip_smoke.compare_messages(
        got, want, got_s, want_s, cfg_ext)
    assert mismatches == 0 and reserved
    assert rel < chip_smoke.CLV_RTOL
    if bl_scale > 1:
        assert int(want_s.max()) > 0


@pytest.mark.cuda
def test_smoothing_on_the_kernel_matches_dense(cuda_device):
    """optimize_branch_lengths on the kernel and with use_kernel=False:
    one kernel sweep a colour class and round plus the final one, none on
    the dense path; lengths and logL agree to f32 rounding."""
    cfg, full, model, bl, tipchars, _ = chip_smoke.message_inputs(
        card_newick("random90"), 2048, 5, cuda_device)
    pw = torch.ones(cfg.sites_padded, device=cuda_device)
    inv = torch.full((cfg.sites_padded,), -1, dtype=torch.int32,
                     device=cuda_device)
    out = {}
    for use_kernel in (None, False):
        c = dataclasses.replace(cfg, use_kernel=use_kernel)
        k0 = engine.message_sweep.kernel_sweeps
        d0 = engine.message_sweep.dense_sweeps
        n0 = ms.sweep_messages.launches
        new_bl, logl = engine.optimize_branch_lengths(full, c, model, bl,
                                                      tipchars, pw, inv)
        out[use_kernel] = (new_bl, logl.item(),
                           engine.message_sweep.kernel_sweeps - k0,
                           engine.message_sweep.dense_sweeps - d0,
                           ms.sweep_messages.launches - n0)
    sweeps = 3 * full.n_colors + 1
    assert out[None][2:] == (sweeps, 0, sweeps)
    assert out[False][2:] == (0, sweeps, 0)
    gap = abs(out[None][1] - out[False][1]) / abs(out[False][1])
    assert gap < chip_smoke.LOGL_RTOL
    torch.testing.assert_close(out[None][0], out[False][0], rtol=1e-3,
                               atol=1e-6)


@pytest.mark.cuda
def test_spr_round_on_the_kernel(cuda_device):
    """One spr_round on the search inputs sweeps its messages on the
    kernel (none dense); the logL it reports is the dense f64 path's on
    the tree it returns."""
    _truth, start, chars, cfg, model = chip_smoke.search_inputs(
        cuda_device, tips=64, sites=1024)
    prog = search_fast.compile_spr(start, cfg, radius=3)
    k0 = engine.message_sweep.kernel_sweeps
    d0 = engine.message_sweep.dense_sweeps
    new, logl, applied = search_fast.spr_round(prog, model, chars)
    assert engine.message_sweep.kernel_sweeps > k0
    assert engine.message_sweep.dense_sweeps == d0
    want = chip_smoke.dense_f64_logl(new.tree, chars, cfg.sites, cuda_device,
                                     alpha=0.9)
    assert abs(float(logl) - want) / abs(want) < chip_smoke.LOGL_RTOL


@pytest.mark.cuda
def test_refused_launches_raise(cuda_device):
    """A case the kernel does not take raises under use_kernel=True, and
    the wrapper raises on inputs it does not take; under None a bf16 sweep
    runs the dense path with a warning."""
    cfg, full, model, bl, tipchars, pmatrix = chip_smoke.message_inputs(
        card_newick("random60"), 256, 5, cuda_device)
    cfg_ext = full.cfg_ext
    ops = full.level_ops_tensor(cuda_device)
    f64 = dataclasses.replace(cfg_ext, dtype=torch.float64, use_kernel=True)
    with pytest.raises(ValueError, match="message-sweep kernel"):
        engine.message_sweep(f64, model, ops, pmatrix.double(), tipchars)
    with pytest.raises(ValueError, match="f32"):
        ms.sweep_messages(ops, pmatrix.double(), tipchars, f64)
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.sweep_messages(ops, pmatrix.cpu(), tipchars, cfg_ext)
    with pytest.raises(ValueError, match="int64"):
        ms.sweep_messages(ops.int(), pmatrix, tipchars, cfg_ext)
    with pytest.raises(ValueError, match="int64"):
        ms.sweep_messages(ops.reshape(-1, 8), pmatrix, tipchars, cfg_ext)
    bf16 = dataclasses.replace(cfg_ext, dtype=torch.bfloat16)
    before = ms.sweep_messages.launches
    with pytest.warns(UserWarning, match="message sweep"):
        engine.message_sweep(bf16, model, ops, pmatrix.bfloat16(), tipchars)
    assert ms.sweep_messages.launches == before
