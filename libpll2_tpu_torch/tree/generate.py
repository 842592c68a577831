"""Synthetic tree / alignment generators (benchmarks, tests, dry runs)."""
from __future__ import annotations

import numpy as np

BASES = "ACGT"


def random_newick(n_tips: int, rng: np.random.Generator,
                  caterpillar: bool = False,
                  min_bl: float = 0.01, max_bl: float = 0.5) -> str:
    """Random binary unrooted newick over n_tips labelled t0..t{n-1}."""
    labels = [f"t{i}" for i in range(n_tips)]
    if caterpillar:
        s = labels[0] + ":0.05"
        for lab in labels[1:-2]:
            s = f"({lab}:0.05,{s}):0.05"
        return f"({labels[-2]}:0.05,{labels[-1]}:0.05,{s});"
    items = [f"{lab}:{rng.uniform(min_bl, max_bl):.6f}" for lab in labels]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        merged = f"({items[i]},{items[j]}):{rng.uniform(min_bl, max_bl):.6f}"
        items = [x for k, x in enumerate(items) if k not in (i, j)]
        items.append(merged)
    return f"({items[0]},{items[1]},{items[2]});"


def balanced_newick(n_tips: int, bl: float = 0.1) -> str:
    """Perfectly balanced topology (minimal level count for the engine)."""
    def build(lo: int, hi: int) -> str:
        if hi - lo == 1:
            return f"t{lo}:{bl}"
        mid = (lo + hi) // 2
        return f"({build(lo, mid)},{build(mid, hi)}):{bl}"

    third = max(1, n_tips // 3)
    a = build(0, third)
    b = build(third, 2 * third)
    c = build(2 * third, n_tips)
    return f"({a},{b},{c});"


def random_sequences(n_tips: int, sites: int, rng: np.random.Generator
                     ) -> list[str]:
    return ["".join(BASES[b] for b in rng.integers(0, 4, sites))
            for _ in range(n_tips)]


def random_tipchars(n_tips: int, sites: int, rng: np.random.Generator,
                    states: int = 4) -> np.ndarray:
    """Encoded tip states (one-hot bitmask codes) [n_tips, sites]."""
    return (np.uint64(1) << rng.integers(0, states, (n_tips, sites),
                                         dtype=np.uint64))


def simulate_alignment(tree, sites: int, rng: np.random.Generator,
                       subst, freqs, rates) -> dict:
    """Simulate tip states down `tree` under GTR(+Γ sites-rates).

    Host-side, vectorized over sites (inverse-CDF sampling per rate
    category).  Returns {tip label: uint64 bitmask codes [sites]} ready
    for the engine / search layers.  Demo & benchmark signal generator —
    the reference ships no simulator; semantics follow its P(t) kernel
    (core_pmatrix.c:24-258)."""
    from ..models.ratematrix import update_eigen
    freqs = np.asarray(freqs, float)
    freqs = freqs / freqs.sum()
    S = len(freqs)
    evals, evecs, ivecs = update_eigen(np.asarray(subst, float), freqs)
    rates = np.asarray(rates, float)

    def pmat(t):
        p = np.eye(S) + (ivecs * np.expm1(evals * t)[None, :]) @ evecs
        p = np.clip(p, 0.0, None)
        return p / p.sum(axis=1, keepdims=True)

    cats = rng.integers(0, len(rates), sites)
    state0 = rng.choice(S, size=sites, p=freqs)
    out = {}
    stack = [(h, state0) for h in tree.vroot.roundabout()]
    while stack:
        half, state = stack.pop()
        child = half.back
        new = np.empty_like(state)
        for r_idx, r in enumerate(rates):
            idx = np.flatnonzero(cats == r_idx)
            if not idx.size:
                continue
            cum = np.cumsum(pmat(half.length * r), axis=1)
            u = rng.random(idx.size)
            new[idx] = np.minimum(
                (u[:, None] > cum[state[idx]]).sum(axis=1), S - 1)
        if child.next is None:
            out[child.label] = np.uint64(1) << new.astype(np.uint64)
        else:
            stack.extend((h, new) for h in child.roundabout()
                         if h is not child)
    return out
