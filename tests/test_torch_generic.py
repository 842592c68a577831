"""The host side of the generic-state forms (the state counts without an
instantiation of their own): the tree sweep's row-group form
(csrc/tree_sweep_generic.cu) and the edge scorer's generic form
(csrc/edge_score.cu).  The host sizes what each kernel asks for from
copies of the .cu's constants and formulas; these tests hold the copies to
the sources' text and the geometry to its rules, on the CPU.  (The kernels
themselves are held to their plain versions on the card:
tests/test_torch_cuda.py.)  The rows the form computes are those of
partials_tree.sweep_reference, which tests/test_torch_oddstates.py and
tests/test_torch_bf16.py hold to the JAX package's Pallas kernels."""
import re

import pytest
import torch

from libpll2_tpu_torch import _build, engine
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.ops import edge_score, partials_tree as pt
from libpll2_tpu_torch.tree.generate import balanced_newick

SWEEP = (_build.SOURCE_DIR / "tree_sweep_generic.cu").read_text()
SCORER = (_build.SOURCE_DIR / "edge_score.cu").read_text()
# the scorer's resident passes and THREADS, shared with newton_edges.cu
PASSES = (_build.SOURCE_DIR / "newton_passes.cuh").read_text()


def const(text, name, kind="int"):
    return re.search(rf"constexpr {kind} {name} = (\w+);", text)[1]


def squash(text):
    return re.sub(r"\s+", " ", text)


def test_row_group_constants_match_the_kernel_source():
    """GROUP_ROWS, GENERIC_STAGE_BYTES and GROUP_THREADS, and the layout
    formulas (rows padded, block, matrix, staging; the launch's checks and
    shared memory) are the kernel's own."""
    assert int(const(SWEEP, "GROUP_ROWS")) == pt.GENERIC_ROWS
    assert int(const(SWEEP, "GENERIC_STAGE_BYTES")) == pt.GENERIC_STAGE_BYTES
    assert int(const(SWEEP, "GROUP_THREADS")) == pt.FMA_THREADS_ANY
    assert int(const(SWEEP, "GROUP_SITES")) == pt.GENERIC_SITES_A_THREAD
    assert int(const(SWEEP, "GROUP_SITES_THREADS")) == \
        pt.GENERIC_SITES_THREADS
    assert f"return SMAX <= {pt.GENERIC_SITES_STATES} ? GROUP_SITES : 1;" \
        in SWEEP
    text = squash(SWEEP)
    for formula in (
            "return ((S + G - 1) / G + 3) & ~3;",
            "return ((S * group_rows_padded(S, G) / 4) | 1) * 4;",
            "return R * G * group_block_floats(S, G);",
            "return 2 * 2 * group_matrix_floats(R, S, G) * 4 <= "
            "GENERIC_STAGE_BYTES;",
            "if ((1 << group_bits) != groups || (states + groups - 1) / "
            "groups > GROUP_ROWS || tb % H || nth > threads_of<SMAX>() || "
            "nth % 32",
            "const bool spans = !per_rate && (groups << lane_bits) > 32;",
            "const int cols = tb << lane_bits, nth = cols * groups / H;",
            "(size_t)pool_size * ((size_t)states * cols * sizeof(T) + "
            "(size_t)sr * 4) + (staged ? (size_t)4 * "
            "group_matrix_floats(rates, states, groups) * 4 : 0) + (spans ? "
            "(size_t)nth / 32 * 4 : 0);",
            "const int g = t & (G - 1), col = t >> group_bits;",
            "const int cols = (nth >> group_bits) * H, hcol = cols / H;"):
        assert formula in text, formula


def test_scorer_generic_constants_match_the_kernel_source():
    """Pass 0 holds the columns in registers (so neither side counts
    staging words), the later passes of the generic resident form run four
    sites a thread, and its register bound lets at least the CTAs an SM
    share it that `plan` budgets shared memory for."""
    assert SCORER.count("site_lk_regs<SMAX, ") == 2 and "scratch" not in \
        SCORER.split("// The \"reread\" form.")[1]
    assert "edge_score_resident_kernel<0, 4, 0, SMAX>" in SCORER
    assert int(const(SCORER, "RESIDENT_CTAS_GENERIC")) >= \
        edge_score.RESIDENT_CTAS_PER_SM
    assert '#include "newton_passes.cuh"' in SCORER
    assert int(const(PASSES, "THREADS")) == edge_score.THREADS
    assert all(edge_score.reread_smem_bytes(4, s) == 4 * (
        16 + 4 * 4 * s + 3 * 4 * s * s + 2 * 4 * s) for s in range(2, 33))



def config(states, rates, dtype, per_rate, tips=64, sites=65536):
    tree = T.parse_newick_string(balanced_newick(tips))
    cfg = PartitionConfig(
        tips=tips, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=rates,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        dtype=dtype)
    return cfg, engine.compile_tree(tree, cfg).vmem_prog


def expected_groups(states):
    groups = 1
    while -(-states // groups) > 8:
        groups *= 2
    return groups


@pytest.mark.parametrize("per_rate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rates", [1, 4, 32])
@pytest.mark.parametrize("states", [3, 5, 9, 17, 32])
def test_generic_geometry(states, rates, dtype, per_rate):
    """Groups, threads, P layout, staging and shared memory of the generic
    form, computed here from the rules, against partials_tree's; the site
    block pick_site_block gives fits every limit and fills the card."""
    cfg, prog = config(states, rates, dtype, per_rate)
    lanes = pt.rate_lanes(rates)
    groups = expected_groups(states)
    assert pt.generic(cfg) and pt.generic_groups(cfg) == groups
    sites = 2 if states <= 8 else 1
    assert pt.sites_a_thread(cfg) == sites and pt.ring_words(cfg) == 0
    assert pt.max_threads(cfg) == (256 if sites == 2 else 1024)
    rows = (-(-states // groups) + 3) // 4 * 4
    block = (states * rows // 4 | 1) * 4
    assert block % 8 == 4                     # an odd count of 16-byte pieces
    mat = rates * groups * block
    assert pt.generic_matrix_floats(cfg) == mat
    spans = not per_rate and groups * lanes > 32
    assert pt.generic_spans_warps(cfg) == spans
    staged = 0 < 16 * mat <= pt.GENERIC_STAGE_BYTES
    assert pt.generic_staged(cfg) == staged
    item = 2 if dtype == torch.bfloat16 else 4
    sr = lanes if per_rate else 1
    for tb in pt.GENERIC_SITE_BLOCKS:
        threads = tb * lanes * groups // sites
        assert pt.fma_threads(cfg, tb) == threads
        assert pt.smem_bytes(prog, cfg, tb) == (
            prog.pool_size * (lanes * states * item + sr * 4) * tb
            + (2 * 2 * mat * 4 if staged else 0)
            + (threads // 32 * 4 if spans else 0))
    if not pt.fitting_blocks(prog, cfg):
        # 32 rates at 32 states with per-rate scalers: no pool fits; the
        # gate says so
        assert "bytes of shared memory" in pt.unsupported(prog, cfg)
        return
    tb = pt.pick_site_block(prog, cfg, sm_count=132)
    assert tb in pt.fitting_blocks(prog, cfg)
    threads = pt.fma_threads(cfg, tb)
    assert threads % 32 == 0 and threads <= pt.max_threads(cfg)
    assert pt.smem_bytes(prog, cfg, tb) <= pt.SMEM_LIMIT
    bigger = [b for b in pt.fitting_blocks(prog, cfg) if b > tb]
    assert all(cfg.sites_padded // b < pt.SM_FILL * 132 for b in bigger)
    assert pt.choose(prog, cfg, sm_count=132) == (tb, "fma")


def test_generic_geometry_at_the_timed_shapes():
    """The two full-width shapes of chip_smoke.py's phases 26 and 27, by
    hand: 5 states (one group, two sites a thread, 128-site blocks of 256
    threads, a pool of nine slots) and 32 states (four groups, 32-site blocks of 512
    threads, eight slots), both staging P."""
    cfg, prog = config(5, 4, torch.float32, False, tips=256)
    assert prog.pool_size == 9
    assert pt.generic_groups(cfg) == 1 and pt.generic_matrix_floats(cfg) == \
        4 * 44
    assert pt.pick_site_block(prog, cfg, sm_count=132) == 128
    assert pt.fma_threads(cfg, 128) == 256
    assert pt.smem_bytes(prog, cfg, 128) == 9 * 84 * 128 + 4 * 176 * 4
    cfg, prog = config(32, 4, torch.float32, False, tips=128, sites=16384)
    assert prog.pool_size == 8
    assert pt.generic_groups(cfg) == 4 and pt.generic_matrix_floats(cfg) == \
        4 * 4 * 260
    assert pt.generic_staged(cfg)
    assert pt.pick_site_block(prog, cfg, sm_count=132) == 32
    assert pt.fma_threads(cfg, 32) == 512
    assert pt.smem_bytes(prog, cfg, 32) == 8 * 516 * 32 + 4 * 4160 * 4


@pytest.mark.parametrize("states", [3, 5, 9, 17, 32])
def test_scorer_generic_shared_memory(states):
    """Without staging words the generic form's CTA is its head and its
    stripe, as at the specialised counts; `plan` takes the smallest
    cluster whose CTA fits a third of the limit."""
    R, T_ = 4, 4096
    span = R * states
    head = -(-(256 + 32 * span + 3 * span * states + 2 * span) // 4) * 4
    for k in edge_score.CLUSTER_SIZES:
        assert edge_score.resident_smem_bytes(R, states, T_, k) == \
            4 * (head + span * -(-T_ // k))
    assert edge_score.reread_smem_bytes(R, states) == 4 * (
        16 + 4 * span + 3 * span * states + 2 * span)
    form, k = edge_score.plan(R, states, T_)
    if form == "resident":
        assert edge_score.resident_smem_bytes(R, states, T_, k) <= \
            pt.SMEM_LIMIT
        smaller = [c for c in edge_score.CLUSTER_SIZES if c < k]
        assert all(edge_score.resident_smem_bytes(R, states, T_, c) >
                   pt.SMEM_LIMIT // edge_score.RESIDENT_CTAS_PER_SM
                   for c in smaller)
