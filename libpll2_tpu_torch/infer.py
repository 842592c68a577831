"""One-call maximum-likelihood tree inference — the full user journey.

Counterpart of libpll2_tpu/infer.py.  The reference library is a toolkit;
its clients (RAxML-NG, ModelTest-NG) assemble the actual workflow: read an
alignment, compress site patterns, build a randomized stepwise-addition
parsimony starting tree, then alternate SPR topology search with
model-parameter optimization (stepwise.c:883-1082 for the start; search +
Brent/L-BFGS model fitting client-side).  Here the whole journey is one
call:

    result = infer_ml_tree(sequences)            # dict label -> str
    result.tree, result.logl, result.alpha, ...

Pipeline, on `device` (the card unless the caller asks for the CPU):
  1. encode + compress site patterns on the host (io/compress.py, the
     native binding where it builds; exact weighted logL)
  2. stepwise-addition parsimony start (parsimony/stepwise.py; the Fitch
     vectors on `device`)
  3. a few SPR rounds on the starting model (empirical frequencies,
     unit GTR rates, gamma alpha0)
  4. gradient model fit (fit.py — Adam through the differentiable
     likelihood, incl. the gamma shape; the forward pass through the tree
     sweep with the analytic reverse pass of a FullTreeProgram)
  5. SPR hill-climb to convergence under the fitted model, batched
     Newton branch smoothing between rounds (search_fast.py)

Two choices differ from the JAX package on purpose: `dtype=None` follows
`device` (f64 on the CPU, f32 on the card), and the parsimony start runs on
`device` where the JAX package pins it to the host.  Like the JAX package,
the start tree scores each compressed pattern once (unit weights), so start
trees match it seed for seed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import engine, fit, search_fast
from .config import PartitionConfig
from .constants import MAPS
from .io import MSA, compress_site_patterns
from .models.gamma import compute_gamma_cats
from .parsimony import FastParsimony, fastparsimony_stepwise
from .tree import parse_newick_string
from .tree.utree import UTree, export_newick


@dataclasses.dataclass
class InferenceResult:
    tree: UTree                  # final topology with branch lengths
    logl: float                  # exact logL at the fitted model
    subst_params: np.ndarray     # fitted GTR exchangeabilities
    frequencies: np.ndarray      # fitted base frequencies
    alpha: float                 # fitted gamma shape
    newick: str
    stats: dict                  # phase timings, logl traces, parsimony cost


def _encode(sequences, states: int):
    if isinstance(sequences, MSA):
        labels, seqs = list(sequences.labels), list(sequences.sequences)
    else:
        labels = sorted(sequences)
        seqs = [sequences[lab] for lab in labels]
    charmap = {4: MAPS["nt"], 20: MAPS["aa"], 2: MAPS["bin"],
               10: MAPS["gt10"], 16: MAPS["gt16"]}.get(states)
    if charmap is None:
        raise ValueError(f"no built-in character map for {states} states")
    return labels, seqs, charmap


def _empirical_frequencies(chars: Dict[str, np.ndarray], weights,
                           states: int) -> np.ndarray:
    """Weighted single-state counts (ambiguity codes skipped), uniform
    prior of one pseudo-count per state."""
    counts = np.ones(states, dtype=np.float64)
    for codes in chars.values():
        single = (codes & (codes - 1)) == 0       # one bit set
        state = np.where(single, np.round(np.log2(
            np.maximum(codes, 1)).astype(np.float64)), -1).astype(np.int64)
        for s in range(states):
            counts[s] += float(np.sum(weights[: len(codes)]
                                      * (state == s)))
    return counts / counts.sum()


def site_patterns(sequences: Union[Dict[str, str], MSA], states: int = 4,
                  compress: bool = True):
    """Step 1 of infer_ml_tree: (labels, chars, weights, raw site count),
    where chars maps a label to the state codes of its site patterns (of
    its sites, with compress=False) and weights counts each pattern."""
    labels, seqs, charmap = _encode(sequences, states)
    if compress:
        patterns, weights = compress_site_patterns(seqs, charmap)
    else:
        patterns, weights = seqs, np.ones(len(seqs[0]), np.float64)
    chars = {lab: charmap[np.frombuffer(p.encode(), np.uint8)]
             for lab, p in zip(labels, patterns)}
    return labels, chars, weights, len(seqs[0])


def parsimony_start(labels, chars: Dict[str, np.ndarray], states: int = 4,
                    seed: int = 42, device="cuda"):
    """Step 2 of infer_ml_tree: the stepwise-addition parsimony start tree
    of the encoded patterns `chars` (label -> codes), its Fitch vectors on
    `device`.  Each pattern counts once, as in the JAX package: (tree,
    cost)."""
    sites = len(chars[labels[0]])
    fp = FastParsimony(
        tipchars=np.stack([chars[lab] for lab in labels]).astype(np.uint64),
        weights=np.ones(sites, np.int64), tips=len(labels), states=states,
        sites=sites, device=device)
    return fastparsimony_stepwise([fp], labels, seed=seed)


def likelihood_config(tree: UTree, states: int, sites: int, rate_cats: int,
                      dtype) -> PartitionConfig:
    """The one-partition config that steps 3-5 of infer_ml_tree run on."""
    tips = tree.tip_count
    return PartitionConfig(
        tips=tips, clv_buffers=tree.inner_count, states=states,
        sites=sites, rate_matrices=1, prob_matrices=2 * tips - 3,
        rate_cats=rate_cats, scale_buffers=tree.inner_count, dtype=dtype)


def fit_inputs(tree: UTree, cfg: PartitionConfig,
               chars: Dict[str, np.ndarray], device="cuda"):
    """(program, full_program, tipchars) of `tree` as step 4 of
    infer_ml_tree hands them to fit.fit_model."""
    program = engine.compile_tree(tree, cfg)
    full = engine.compile_tree_full(tree, cfg)
    raw = np.full((cfg.tips, cfg.sites_alloc), 0, dtype=np.uint64)
    for n in tree.nodes[:cfg.tips]:
        seq = chars[n.label]
        raw[n.clv_index, :len(seq)] = seq[:cfg.sites_alloc]
    tipchars = torch.as_tensor(engine.pad_tipchars(raw, cfg), device=device)
    return program, full, tipchars


def infer_ml_tree(sequences: Union[Dict[str, str], MSA], *,
                  states: int = 4, rate_cats: int = 4, alpha0: float = 1.0,
                  radius: int = 5, max_rounds: int = 30,
                  warmup_rounds: int = 4, fit_steps: int = 150,
                  fit_lr: float = 0.05, fit_alpha: bool = True,
                  seed: int = 42, dtype=None, compress: bool = True,
                  smooth_every: int = 2,
                  checkpoint_dir: Optional[str] = None,
                  device="cuda") -> InferenceResult:
    """Infer an ML tree from raw sequences (see module docstring).

    sequences: {label: sequence string} or an io.MSA.
    dtype: None picks f64 on the CPU and f32 on the card.
    """
    device = torch.device(device)
    torch.empty(0, device=device)             # no card: raise here
    stats: dict = {}
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32

    # 1. site-pattern compression (exact: weighted logL == uncompressed)
    labels, chars, weights, sites_raw = site_patterns(sequences, states,
                                                      compress)
    if len(labels) < 4:
        raise ValueError("need at least four taxa")
    sites = len(weights)
    stats["sites_raw"] = sites_raw
    stats["sites_patterns"] = sites

    # 2. stepwise-addition parsimony starting tree
    t0 = time.perf_counter()
    start, pars_cost = parsimony_start(labels, chars, states, seed, device)
    for n in start.nodes:
        group = [n] if n.next is None else list(n.roundabout())
        for h in group:
            h.length = h.back.length = 0.1
    start = parse_newick_string(export_newick(start.vroot, precision=6))
    stats["parsimony_cost"] = int(pars_cost)
    stats["parsimony_secs"] = time.perf_counter() - t0

    cfg = likelihood_config(start, states, sites, rate_cats, dtype)
    pw = np.zeros(cfg.sites_padded)
    pw[:sites] = weights
    inv = np.full(cfg.sites_padded, -1, np.int32)

    n_ex = states * (states - 1) // 2
    freqs0 = _empirical_frequencies(chars, np.asarray(weights), states)
    subst0 = np.ones(n_ex)
    rates0 = compute_gamma_cats(alpha0, rate_cats)
    model = engine.make_model([subst0], [freqs0], rates0, dtype=dtype,
                              device=device)

    # 3. warm-up SPR rounds under the starting model
    t0 = time.perf_counter()
    tree, logl_a, stats_a = search_fast.hill_climb(
        start, cfg, model, chars, max_rounds=warmup_rounds, radius=radius,
        smooth_every=smooth_every, pattern_weights=pw, invariant=inv,
        checkpoint_dir=checkpoint_dir)
    stats["warmup_secs"] = time.perf_counter() - t0
    stats["warmup_logl"] = logl_a
    stats["warmup"] = {k: stats_a[k] for k in ("rounds", "moves")}

    # 4. gradient model fit on the warmed topology: the forward pass
    # through the tree sweep, the gradient by the analytic reverse pass
    t0 = time.perf_counter()
    alpha = alpha0
    subst_fit, freqs_fit = subst0, freqs0
    if fit_steps > 0:
        program, full, tipchars = fit_inputs(tree, cfg, chars, device)
        params0 = fit.pack([subst0], [freqs0],
                           np.asarray(program.default_branch_lengths),
                           alpha=alpha0, dtype=dtype, device=device)
        res = fit.fit_model(program, cfg, params0, rates0, tipchars,
                            torch.as_tensor(pw, dtype=dtype, device=device),
                            torch.as_tensor(inv, device=device),
                            steps=fit_steps, lr=fit_lr, fit_alpha=fit_alpha,
                            full_program=full)
        subst_l, freqs_l, _bl = fit.unpack(res.params)
        subst_fit = subst_l[0].double().cpu().numpy()
        freqs_fit = freqs_l[0].double().cpu().numpy()
        if fit_alpha:
            alpha = float(torch.exp(res.params.log_alpha.double()))
        rates0 = compute_gamma_cats(alpha, rate_cats)
        model = engine.make_model([subst_fit], [freqs_fit], rates0,
                                  dtype=dtype, device=device)
        stats["fit_logl_trace"] = res.logl.double().cpu().numpy()[
            :: max(1, fit_steps // 10)].tolist()
    stats["fit_secs"] = time.perf_counter() - t0
    stats["alpha"] = alpha

    # 5. hill-climb to convergence under the fitted model
    t0 = time.perf_counter()
    tree, logl, stats_b = search_fast.hill_climb(
        tree, cfg, model, chars,
        max_rounds=max(1, max_rounds - warmup_rounds), radius=radius,
        smooth_every=smooth_every, pattern_weights=pw, invariant=inv,
        checkpoint_dir=checkpoint_dir)
    stats["search_secs"] = time.perf_counter() - t0
    stats["search"] = {k: stats_b[k] for k in ("rounds", "moves")}
    stats["logl_trace"] = stats_b["logl_trace"]
    stats["round_secs"] = stats_b["round_secs"]

    return InferenceResult(
        tree=tree, logl=logl, subst_params=subst_fit,
        frequencies=freqs_fit, alpha=alpha,
        newick=export_newick(tree.vroot, precision=9), stats=stats)
