"""One-call ML tree inference: raw sequences in, fitted tree out.

The complete client workflow the reference leaves to RAxML-NG — site
compression, parsimony starting tree, gradient model fit, SPR search —
as a single framework call (libpll2_tpu_torch.infer_ml_tree).  On the
card it runs f32 through the tree-sweep and edge-scorer kernels; on the
host CPU f64.

Usage: python -m libpll2_tpu_torch.examples.infer_demo [tips] [sites]
       [--device cpu]
"""
import numpy as np

from libpll2_tpu_torch import infer_ml_tree
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.models.gamma import compute_gamma_cats
from libpll2_tpu_torch.tree.compare import rf_distance_normalized
from libpll2_tpu_torch.tree.generate import random_newick, simulate_alignment

from . import _common

NT = {1: "A", 2: "C", 4: "G", 8: "T"}


def main(argv=None) -> dict:
    """Runs the demo; returns {"result": the InferenceResult, "truth":
    the simulation's tree, "rf": the normalised RF distance between
    them}."""
    ap = _common.parser(__doc__)
    ap.add_argument("tips", nargs="?", type=int, default=16)
    ap.add_argument("sites", nargs="?", type=int, default=500)
    args, device, dtype = _common.setup(ap, argv, kernels=True)
    TIPS, SITES = args.tips, args.sites

    rng = np.random.default_rng(11)
    truth = T.parse_newick_string(
        random_newick(TIPS, rng, min_bl=0.05, max_bl=0.4))
    codes = simulate_alignment(truth, SITES, rng,
                               [1.5, 3.0, 0.8, 1.2, 2.5, 1.0],
                               [0.32, 0.18, 0.24, 0.26],
                               compute_gamma_cats(0.7, 4))
    seqs = {lab: "".join(NT[int(c)] for c in cs)
            for lab, cs in codes.items()}

    res = infer_ml_tree(seqs, max_rounds=12, warmup_rounds=3, fit_steps=120,
                        dtype=dtype, device=device)

    s = res.stats
    rf = rf_distance_normalized(res.tree, truth)
    print(f"{TIPS} taxa x {SITES} sites -> {s['sites_patterns']} patterns")
    print(f"parsimony start: cost {s['parsimony_cost']} "
          f"({s['parsimony_secs']:.1f}s)")
    print(f"model fit: alpha={res.alpha:.3f} "
          f"freqs={np.round(res.frequencies, 3)}")
    print(f"           rates={np.round(res.subst_params, 2)}")
    print(f"search: {s['search']['rounds']} rounds, {s['search']['moves']} "
          f"moves ({s['search_secs']:.1f}s)")
    print(f"final logL: {res.logl:.3f}")
    print(f"RF distance to simulation truth: {rf:.3f}")
    return {"result": res, "truth": truth, "rf": rf}


if __name__ == "__main__":
    main()
