"""End-to-end ML workflow demo — capabilities BEYOND the reference:

  1. batched all-branch Newton smoothing (engine.optimize_branch_lengths)
  2. autodiff model fitting: GTR rates + frequencies + branch lengths +
     gamma shape in one Adam loop (fit.fit_model)
  3. a greedy ML SPR round on the batched placement scorer
     (legacy_search.ml_spr_round)

The reference library provides single-branch Newton machinery and SPR
mechanics; the optimization loops live in its clients (RAxML-NG).  Here
they are first-class and batched.  f64 on either device, on the dense
plain-PyTorch path (the tree-sweep kernels are f32).

Run:  python -m libpll2_tpu_torch.examples.optimize_demo [--device cpu]
"""
import numpy as np
import torch

import libpll2_tpu_torch as pll
from libpll2_tpu_torch import engine, fit
from libpll2_tpu_torch import legacy_search as search
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig

from . import _common

NEWICK = ("((A:0.12,B:0.20):0.05,(C:0.09,(D:0.15,E:0.11):0.07):0.04,"
          "(F:0.18,G:0.25):0.06);")
SEQS = {
    "A": "CTAGCGCAGTTCAAGACAGCTTACGGTCCTGACGTGCTAAGCAT",
    "B": "CTAGCGAAGTTCAAGACAGCTTACGGTACTGACGTGCTAAGCGT",
    "C": "CTTGCGCAGGTCAAGACTGCTTACGGACCTGACGTGCTTAGCAT",
    "D": "CTTGCACAGGTCGAGACTGCATACGGACCTGATGTGCTTAGCAT",
    "E": "CTTGCACAGGTCGAGACTGCATACGGACCTAATGTGCTTAGCAT",
    "F": "TTAGCGCAGTTCAAGCCAGCTTACGGTCCTGACGAGCTAAGTAT",
    "G": "TTAGCGCAGTACAAGCCAGCTTATGGTCCTGACGAGCTAAGTAT",
}


def main(argv=None) -> None:
    _, device, dtype = _common.setup(_common.parser(__doc__), argv)
    tree = T.parse_newick_string(NEWICK)
    sites = len(SEQS["A"])
    cfg = PartitionConfig(
        tips=7, clv_buffers=tree.inner_count, states=4, sites=sites,
        rate_matrices=1, prob_matrices=11, rate_cats=4,
        scale_buffers=tree.inner_count, dtype=dtype)
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)

    rates = pll.compute_gamma_cats(1.0, 4)
    model = engine.make_model([[1.0] * 6], [[0.25] * 4], rates,
                              dtype=dtype, device=device)
    raw = np.zeros((7, cfg.sites_alloc), dtype=np.uint64)
    for n in tree.nodes[:7]:
        raw[n.clv_index] = pll.MAP_NT[np.frombuffer(
            SEQS[n.label].encode(), np.uint8)]
    tipchars = torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = 1.0
    pw = torch.as_tensor(pw, dtype=dtype, device=device)
    inv = torch.as_tensor(np.full(cfg.sites_padded, -1, np.int32),
                          device=device)
    bl = torch.as_tensor(program.default_branch_lengths, dtype=dtype,
                         device=device)

    logl0 = float(engine.loglikelihood(program, cfg, model, bl, tipchars,
                                       pw, inv))
    print(f"start                  logL = {logl0:.6f}")

    # 1. all-branch Newton smoothing
    bl_opt, logl1 = engine.optimize_branch_lengths(
        full, cfg, model, bl, tipchars, pw, inv, rounds=16)
    print(f"branch smoothing       logL = {float(logl1):.6f}")

    # 2. joint model fit (rates, freqs, branches, alpha)
    params0 = fit.pack([[1.0] * 6], [[0.25] * 4], bl_opt, alpha=1.0,
                       dtype=dtype, device=device)
    res = fit.fit_model(program, cfg, params0, rates, tipchars, pw, inv,
                        steps=200, lr=0.05, fit_alpha=True)
    subst, freqs, bl_fit = (x.detach() for x in fit.unpack(res.params))
    alpha = float(torch.exp(res.params.log_alpha))
    print(f"model fit (Adam)       logL = {float(res.logl[-1]):.6f}")
    print(f"  fitted alpha = {alpha:.3f}")
    print(f"  fitted freqs = {np.round(freqs[0].cpu().numpy(), 3)}")
    print(f"  fitted rates = {np.round(subst[0].cpu().numpy(), 3)}")

    # 3. one ML SPR round from the fitted model + fitted branch lengths
    model_fit = fit.make_model_traced(
        subst, freqs, pll.compute_gamma_cats(alpha, 4), dtype=dtype)
    pos_of = {int(pm): i for i, pm in enumerate(program.pmatrix_indices)}
    bl_fit = bl_fit.cpu().numpy()
    for n in tree.nodes:
        for h in ([n] if n.next is None else list(n.roundabout())):
            h.length = float(bl_fit[pos_of[h.pmatrix_index]])
    chars = {n.label: raw[n.clv_index] for n in tree.nodes[:7]}
    tree2, logl2, improved = search.ml_spr_round(tree, cfg, model_fit,
                                                 chars)
    print(f"SPR round              logL = {logl2:.6f} "
          f"({'move applied' if improved else 'local optimum'})")


if __name__ == "__main__":
    main()
