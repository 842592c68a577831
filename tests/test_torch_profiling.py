"""The profiler script (libpll2_tpu_torch.profiling) on the CPU: every
target at a toy size with device="cpu" gives its JSON object with the
host seconds of each phase and null kernel fields with their reason; the
repeats target's class structure equals libpll2_tpu.repeats run on the
same alignment (integers: exact); the union of device intervals behind
the idle share; the command line prints one JSON line."""
import json

import numpy as np
import pytest
import torch

from libpll2_tpu.repeats import Repeats as JRepeats
from libpll2_tpu_torch import profiling
from libpll2_tpu_torch.tree import create_operations, traverse

TOY = {"engine": dict(tips=12, sites=256, reps=1),
       "sweep": dict(tips=12, sites=256, reps=1),
       "round": dict(tips=12, sites=256, radius=2, reps=1),
       "search": dict(tips=12, sites=256, radius=2, rounds=2),
       "repeats": dict(tips=12, sites=512, reps=1)}
PHASES = {"engine": {"pmatrices", "sweep[fma]", "sweep[mma]",
                     "root_reduction", "sumtable", "newton[10]",
                     "loglikelihood", "optimize_root_branch"},
          "sweep": {"fma@128", "mma@128"},
          "round": {"compile_spr", "base_sweep", "score[plain]",
                    "spr_round"},
          "search": {"hill_climb"},
          "repeats": {"update_partials[dense]", "update_partials[repeats]",
                      "levelize_operations_repeats",
                      "update_partials_repeats[prebuilt]",
                      "gather[one child]", "forward[dense sites]",
                      "forward[class sites]"}}
KERNEL_FIELDS = ("kernel_ms", "kernel_sum_ms", "idle_share", "top_kernels",
                 "profiled_wall_ms")


@pytest.mark.parametrize("target", sorted(TOY))
def test_target_on_the_cpu(target):
    out = profiling.run(target, "cpu", **TOY[target])
    json.dumps(out)
    assert out["target"] == target and out["device"] == "cpu"
    assert out["card"] is None
    assert out["kernel_null_reason"] == profiling.KERNEL_NULL
    for key in KERNEL_FIELDS:
        assert out[key] is None, key
    assert out["wall_ms"] > 0
    assert PHASES[target] <= set(out["phases"])
    assert out["headline"] in out["phases"]
    for name, phase in out["phases"].items():
        assert phase["host_s"] > 0, name
        assert phase.get("kernel_ms") is None, name


def test_round_target_reports_round_phases():
    out = profiling.run("round", "cpu", **TOY["round"])
    assert out["scorer"] == "plain" and out["ball_groups"] >= 1
    timings = out["phases"]["spr_round"]["timings"]
    assert {"setup", "score", "select"} <= set(timings)
    score = out["phases"]["score[plain]"]
    assert score["gather_ms"] is None and score["scatter_ms"] is None
    assert score["matched_ms"] is None and score["recurse_ms"] is None


def test_search_target_trace_is_monotone():
    out = profiling.run("search", "cpu", **TOY["search"])
    trace = out["logl_trace"]
    assert len(out["round_secs"]) == len(trace) - 1 <= 2
    assert all(np.isfinite(trace))
    assert all(b >= a for a, b in zip(trace, trace[1:]))
    assert out["logl"] == trace[-1]


def test_sweep_target_reports_blocks_and_choice():
    out = profiling.run("sweep", "cpu", **TOY["sweep"])
    assert out["choose"]["mode"] in ("fma", "mma")
    assert f"{out['choose']['mode']}@{out['choose']['site_block']}" \
        == out["headline"]
    for mode, tb in out["picked_blocks"].items():
        assert f"{mode}@{tb}" in out["phases"]
    assert out["build"]["seconds"] is None and out["build"]["reason"]


@pytest.mark.parametrize("tips,sites,seed", [(12, 512, 11), (24, 1024, 3)])
def test_class_share_equals_the_jax_repeats(tips, sites, seed):
    """tools/repeats_quantify.py's class count, by libpll2_tpu.repeats, on
    the alignment the repeats target builds."""
    tree, chars = profiling.gappy_alignment(tips, sites, seed)
    got = profiling.class_share(tree, chars, sites)
    ops, _, _ = create_operations(traverse(tree.vroot))
    rep = JRepeats(2 * tips, 2 * tips, sites, additional_sites=0)
    for n in tree.nodes[:tips]:
        rep.update_tip(n.clv_index, np.asarray(chars[n.label], np.uint32))
    total = classes = 0
    for op in ops:
        nc = sites
        if rep.enable(op.child1_clv_index, op.child2_clv_index):
            rep.update(op.parent_clv_index, op.child1_clv_index,
                       op.child2_clv_index, parent_scaler=-1)
            n = rep.sites_number(op.parent_clv_index)
            nc = n if n else sites
        total += sites
        classes += nc
    assert got["ops"] == len(ops)
    assert (got["dense_columns"], got["class_columns"]) == (total, classes)
    assert got["compute_fraction"] == classes / total
    assert 0 < got["skipped_share"] < 1


def test_union_of_device_intervals():
    """The idle share's kernel time: overlapping rows (ns) count once."""
    assert profiling._union_ms([]) == 0.0
    assert profiling._union_ms([(0, 10**6), (5 * 10**5, 15 * 10**5)]) == 1.5
    assert profiling._union_ms([(2 * 10**6, 3 * 10**6), (0, 10**6),
                                (10**5, 2 * 10**5)]) == 2.0
    prof = profiling.KernelProfile(10.0, 12.0, 2.5, 3.0,
                                   [("k" * 200, 3.0, 2)], {})
    assert prof.idle_share == 0.75
    assert prof.top(1) == [("k" * profiling.NAME_CHARS, 3.0, 2)]


def _profile(rows, ops=None):
    return profiling.KernelProfile(10.0, 12.0, 4.0, 4.0, rows, ops or {})


def test_card_fields_of_a_complete_trace():
    """Every launch of this package's kernels has its row: the kernel
    fields are those of the trace, per call."""
    rows = [("void tree_sweep_kernel<4, 4>", 3.0, 2),
            ("void edge_score_kernel", 0.5, 2), ("elementwise", 0.5, 4)]
    got = profiling.card_fields(
        _profile(rows, {"aten::index": 0.2, "aten::index_put_": 0.1,
                        "aten::mul": 0.2}), 4, 2, match="edge_score")
    assert got["kernel_null_reason"] is None
    assert (got["own_rows"], got["own_launches"]) == (2.0, 2.0)
    assert got["kernel_ms"] == 2.0 and got["idle_share"] == 0.6
    assert got["matched_ms"] == 0.25
    assert (got["gather_ms"], got["scatter_ms"]) == (0.1, 0.05)
    assert got["top"][0] == ("void tree_sweep_kernel<4, 4>", 1.5, 1.0)


@pytest.mark.parametrize("rows,launches", [
    ([("void tree_sweep_kernel<4, 4>", 3.0, 6)], 10),
    ([("void tree_sweep_mma_small_kernel<4, 4>", 3.0, 7),
      ("pmatrix_fragments_kernel", 0.1, 10)], 10),
    (None, 10)])
def test_card_fields_of_a_trace_that_lost_rows(rows, launches):
    """Fewer rows of this package's kernels than launches, or no row: no
    kernel time, idle share or matched time, and the reason."""
    got = profiling.card_fields(None if rows is None else _profile(rows),
                                launches, 10, match="tree_sweep")
    for key in ("kernel_ms", "kernel_sum_ms", "idle_share", "matched_ms"):
        assert got[key] is None, key
    assert got["own_launches"] == 1.0
    assert got["kernel_null_reason"].startswith(
        "the trace holds no device row" if rows is None
        else "the trace lost device rows")
    if rows is not None:
        assert got["own_rows"] == rows[0][2] / 10 and got["top"]


SMI = ("GPU-1111aaaa-0000-0000-0000-000000000000, NVIDIA H100 80GB HBM3, "
       "700.00 W\n"
       "GPU-2222bbbb-0000-0000-0000-000000000000, NVIDIA H100 80GB HBM3, "
       "500.00 W\n")


def test_card_row_finds_the_card_by_uuid():
    """nvidia-smi lists every card of the host; the row is the card's by
    its UUID, with or without the GPU- prefix, not by its position."""
    assert profiling.card_row(SMI, "2222bbbb-0000-0000-0000-000000000000") \
        == "NVIDIA H100 80GB HBM3, 500.00 W"
    assert profiling.card_row(SMI, "GPU-1111AAAA-0000-0000-0000-"
                                   "000000000000") \
        == "NVIDIA H100 80GB HBM3, 700.00 W"
    with pytest.raises(RuntimeError, match="no card"):
        profiling.card_row(SMI, "3333cccc-0000-0000-0000-000000000000")


def test_command_line_prints_one_json_line(capsys):
    profiling.main(["engine", "--tips", "8", "--sites", "128", "--reps",
                    "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["shape"] == {"tips": 8, "sites": 128}
    assert out["kernel_null_reason"]


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        profiling.run("engine", tips=8, sites=128)
    with pytest.raises(RuntimeError, match="--device cpu"):
        profiling.main(["engine", "--tips", "8", "--sites", "128"])
