"""Production-scale ML tree inference pipeline, end to end on one card.

The workflow the reference library exists to power (RAxML-NG style):

  1. simulate / load an alignment                 (tree/generate.py, io/)
  2. parsimony stepwise-addition starting tree    (parsimony/stepwise.py,
                                                   stepwise.c semantics)
  3. ML SPR hill-climb with radius-limited exact scoring, batched Newton
     branch smoothing between rounds              (search_fast.py)

On the card step 3 runs f32 through the tree-sweep and edge-scorer
kernels; step 2 runs on the host CPU, where stepwise addition's many tiny
launches cost less.  With --device cpu everything runs on the host at
f64.

Usage:
  python -m libpll2_tpu_torch.examples.large_search [tips] [sites]
      [radius] [max_rounds] [--device cpu]

Defaults: 256 tips x 4096 sites, radius 5, 12 rounds.  Each round's line
prints the search's own phase timings (search_fast.spr_round).
"""
import time

import numpy as np

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import engine, search_fast
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.parsimony import fastparsimony_stepwise
from libpll2_tpu_torch.tree.generate import random_newick, simulate_alignment

from . import _common

SUBST = [1.2, 2.7, 0.8, 1.1, 3.0, 1.0]
FREQS = [0.28, 0.24, 0.22, 0.26]
ALPHA = 0.9


def main(argv=None) -> dict:
    """Runs the demo; returns {"tree", "logl", "stats", "chars", "truth"}
    of the climb (the tree carries its branch lengths)."""
    ap = _common.parser(__doc__)
    ap.add_argument("tips", nargs="?", type=int, default=256)
    ap.add_argument("sites", nargs="?", type=int, default=4096)
    ap.add_argument("radius", nargs="?", type=int, default=5)
    ap.add_argument("max_rounds", nargs="?", type=int, default=12)
    args, device, dtype = _common.setup(ap, argv, kernels=True)
    TIPS, SITES, RADIUS, ROUNDS = (args.tips, args.sites, args.radius,
                                   args.max_rounds)

    rng = np.random.default_rng(20260820)
    rates = pll.compute_gamma_cats(ALPHA, 4)

    t0 = time.time()
    true_tree = T.parse_newick_string(
        random_newick(TIPS, rng, min_bl=0.02, max_bl=0.35))
    chars = simulate_alignment(true_tree, SITES, rng, SUBST, FREQS, rates)
    labels = sorted(chars)
    print(f"simulated {TIPS} taxa x {SITES} sites  "
          f"({time.time()-t0:.1f}s)")

    # ---- parsimony starting tree (stepwise.c:585-729 semantics) ---------
    # On the host CPU: stepwise addition launches many tiny programs, and
    # on the card their launch costs outweigh the work.
    t0 = time.time()
    partition = pll.Partition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3, 1,
                              TIPS - 2, device="cpu")
    code_of = {1: "A", 2: "C", 4: "G", 8: "T"}
    for i, lab in enumerate(labels):
        partition.set_tip_states(
            i, pll.MAP_NT, "".join(code_of[int(c)] for c in chars[lab]))
    fp = pll.FastParsimony(partition, device="cpu")
    start, pars_cost = fastparsimony_stepwise([fp], labels, seed=42)
    for n in start.nodes:
        if n.next is None:
            n.length = n.back.length = 0.1
        else:
            for h in n.roundabout():
                h.length = h.back.length = 0.1
    # normalize to template indexing (search_fast expects parser layout)
    start = T.parse_newick_string(
        T.export_newick(start.vroot, precision=6))
    print(f"stepwise parsimony start: cost {pars_cost}  "
          f"({time.time()-t0:.1f}s)")

    # ---- ML hill-climb ---------------------------------------------------
    cfg = PartitionConfig(
        tips=TIPS, clv_buffers=start.inner_count, states=4, sites=SITES,
        rate_matrices=1, prob_matrices=2 * TIPS - 3, rate_cats=4,
        scale_buffers=start.inner_count, dtype=dtype)
    model = engine.make_model([SUBST], [FREQS], rates, dtype=dtype,
                              device=device)

    t0 = time.time()
    tree, logl, stats = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=ROUNDS, radius=RADIUS,
        smooth_every=2)
    wall = time.time() - t0
    trace = stats["logl_trace"]
    rs = stats["round_secs"]
    steady = f", steady-state {np.median(rs[1:]):.1f}s/round" \
        if len(rs) > 1 else ""
    print(f"hill-climb: {stats['rounds']} rounds, {stats['moves']} moves, "
          f"{wall:.1f}s total (first round incl. compile {rs[0]:.1f}s"
          f"{steady})")
    for i, tm in enumerate(stats["phase_timings"]):
        ph = {k: round(v, 2) for k, v in tm.items()
              if isinstance(v, float)}
        print(f"  round {i}: {ph} scorer={tm.get('scorer')} "
              f"edge_score_launches={tm.get('edge_score_launches')}")
    print("logL trace:", " ".join(f"{x:.1f}" for x in trace))
    assert all(b >= a - 1e-3 for a, b in zip(trace, trace[1:])), \
        "not monotone"
    assert np.isfinite(logl)
    print(f"final logL: {logl:.3f}")
    print(T.export_newick(tree.vroot, precision=6)[:120], "...")
    return {"tree": tree, "logl": logl, "stats": stats, "chars": chars,
            "truth": true_tree}


if __name__ == "__main__":
    main()
