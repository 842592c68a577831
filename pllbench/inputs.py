"""The benchmark's input generators: trees, tip codes and simulated
alignments, all drawn from a seed on the host.

Frozen copies of the program's tree/generate.py (`random_newick`,
`balanced_newick`, `random_tipchars`, `simulate_alignment`), so that a
change to the program cannot change the inputs it is measured on; the
simulation takes its P-matrices from the reference's model.
"""
from __future__ import annotations

import numpy as np

from .reference import model as ref_model


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed."""
    return np.random.default_rng([stream, seed])


def random_newick(n_tips: int, gen: np.random.Generator,
                  min_bl: float = 0.01, max_bl: float = 0.5) -> str:
    """Random binary unrooted newick over n_tips labelled t0..t{n-1}."""
    items = [f"t{i}:{gen.uniform(min_bl, max_bl):.6f}" for i in range(n_tips)]
    while len(items) > 3:
        i, j = sorted(gen.choice(len(items), 2, replace=False))
        merged = f"({items[i]},{items[j]}):{gen.uniform(min_bl, max_bl):.6f}"
        items = [x for k, x in enumerate(items) if k not in (i, j)]
        items.append(merged)
    return f"({items[0]},{items[1]},{items[2]});"


def balanced_newick(n_tips: int, bl: float = 0.1) -> str:
    """Perfectly balanced unrooted topology, every branch of length bl."""
    def build(lo: int, hi: int) -> str:
        if hi - lo == 1:
            return f"t{lo}:{bl}"
        mid = (lo + hi) // 2
        return f"({build(lo, mid)},{build(mid, hi)}):{bl}"

    third = max(1, n_tips // 3)
    return (f"({build(0, third)},{build(third, 2 * third)},"
            f"{build(2 * third, n_tips)});")


def random_tipchars(n_tips: int, sites: int, gen: np.random.Generator,
                    states: int = 4) -> np.ndarray:
    """One-hot bitmask codes [n_tips, sites] uint64, states uniform."""
    return np.uint64(1) << gen.integers(0, states, (n_tips, sites),
                                        dtype=np.uint64)


def simulate_alignment(tree, sites: int, gen: np.random.Generator,
                       subst, freqs, rates) -> dict:
    """Tip states simulated down `tree` (reference.newick.Tree) under GTR
    with the site rates `rates`, a category drawn uniformly per site:
    {tip label: [sites] uint64 bitmask codes}."""
    freqs = np.asarray(freqs, float)
    freqs = freqs / freqs.sum()
    s = len(freqs)
    values, left, right = ref_model.eigensystem(subst, freqs)
    rates = np.asarray(rates, float)

    def pmat(t):
        p = ref_model.pmatrices(values, left, right, [t], [1.0])[0, 0]
        p = np.clip(p, 0.0, None)
        return p / p.sum(axis=1, keepdims=True)

    cats = gen.integers(0, len(rates), sites)
    state0 = gen.choice(s, size=sites, p=freqs)
    out = {}
    stack = [(child, state0) for child in tree.root.children]
    while stack:
        node, parent_state = stack.pop()
        new = np.empty_like(parent_state)
        for r_idx, r in enumerate(rates):
            idx = np.flatnonzero(cats == r_idx)
            if not idx.size:
                continue
            cum = np.cumsum(pmat(tree.lengths[node.edge] * r), axis=1)
            u = gen.random(idx.size)
            new[idx] = np.minimum(
                (u[:, None] > cum[parent_state[idx]]).sum(axis=1), s - 1)
        if not node.children:
            out[node.label] = np.uint64(1) << new.astype(np.uint64)
        else:
            stack.extend((child, new) for child in node.children)
    return out
