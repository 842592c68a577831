"""Codon substitution models: GY94 with F3x4 frequencies (numpy and torch).

Goldman & Yang 1994 (MBE 11:725-736) over the 61 sense codons of the
standard genetic code.  A state is a sense codon; the states are the 64
triplets of ACGT in lexicographic order (AAA, AAC, ..., TTT) without the
stop codons TAA, TAG and TGA, and a state's index is its position in that
list (`SENSE_CODONS`).  The exchangeability of two sense codons is 0 where
they differ at more than one position; else 1, times kappa where the
difference is a transition (A<->G, C<->T), times omega where the two code
for different amino acids.  F3x4: a codon's frequency is the product of
its three positions' nucleotide frequencies, renormalised over the sense
codons.

Usage with the engine (PAML codeml's M0, IQ-TREE's GY+F3X4+G4):

    subst = gy94_exchangeabilities(kappa, omega)    # [1830]
    freqs = f3x4_frequencies(table)                 # [61], table [3, 4]
    model = engine.make_model([subst], [freqs], gamma_rates)

The torch forms (`gy94_exchangeabilities_torch`, `f3x4_frequencies_torch`)
compute the same from tensors, differentiable in kappa, omega and the
table, for models fitted by autograd as ratematrix.py's torch forms are.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

NUCLEOTIDES = "ACGT"
# the standard genetic code (NCBI table 1), amino acids of the 64 codons
# in TCAG order, as the table is published; "*" marks a stop codon
_STANDARD_TCAG = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVV"
                  "AAAADDEEGGGG")


@functools.cache
def _code() -> dict:
    """codon -> amino acid (one letter, "*" for a stop) of the standard
    code."""
    return {"".join(c): aa for c, aa in zip(itertools.product("TCAG",
                                                              repeat=3),
                                            _STANDARD_TCAG)}


def standard_code() -> dict:
    """The standard genetic code: codon (ACGT letters) -> amino acid."""
    return dict(_code())


@functools.cache
def _sense() -> tuple:
    return tuple("".join(c) for c in itertools.product(NUCLEOTIDES,
                                                       repeat=3)
                 if _code()["".join(c)] != "*")


SENSE_CODONS = _sense()
CODON_STATES = len(SENSE_CODONS)            # 61


@functools.cache
def _pair_classes() -> tuple:
    """Over the upper triangle of the sense codons, row by row (the order
    engine.make_model reads exchangeabilities in): whether a pair differs
    at one position only, whether that difference is a transition, and
    whether the two code for different amino acids; three [1830] bool
    arrays."""
    code = _code()
    transitions = {frozenset("AG"), frozenset("CT")}
    single, ts, nonsyn = [], [], []
    for i, a in enumerate(SENSE_CODONS):
        for b in SENSE_CODONS[i + 1:]:
            diff = [(x, y) for x, y in zip(a, b) if x != y]
            single.append(len(diff) == 1)
            ts.append(len(diff) == 1 and frozenset(diff[0]) in transitions)
            nonsyn.append(code[a] != code[b])
    return tuple(np.asarray(x, dtype=bool) for x in (single, ts, nonsyn))


def gy94_exchangeabilities(kappa: float, omega: float) -> np.ndarray:
    """The GY94 exchangeabilities [1830] float64: the upper triangle of the
    61 sense codons, row by row; 0, 1, kappa, omega or kappa * omega."""
    single, ts, nonsyn = _pair_classes()
    out = np.where(single, 1.0, 0.0)
    out = np.where(ts, out * kappa, out)
    return np.where(nonsyn, out * omega, out)


def _positions() -> np.ndarray:
    """[61, 3] int: the nucleotide index at each position of each sense
    codon."""
    return np.asarray([[NUCLEOTIDES.index(n) for n in c]
                       for c in SENSE_CODONS])


def f3x4_frequencies(table) -> np.ndarray:
    """F3x4 codon frequencies [61] float64 from a [3, 4] table of
    nucleotide frequencies (A, C, G, T) at codon positions 1, 2, 3: each
    codon's the product of its positions', renormalised over the sense
    codons.  Each row is normalised to sum to 1 first."""
    table = np.asarray(table, dtype=np.float64)
    if table.shape != (3, 4) or (table <= 0).any():
        raise ValueError(f"an F3x4 table is [3, 4] of positive numbers, got "
                         f"{table.shape}")
    table = table / table.sum(axis=1, keepdims=True)
    pos = _positions()
    freqs = table[0, pos[:, 0]] * table[1, pos[:, 1]] * table[2, pos[:, 2]]
    return freqs / freqs.sum()


def gy94_exchangeabilities_torch(kappa, omega) -> torch.Tensor:
    """gy94_exchangeabilities from tensors kappa and omega (scalars),
    differentiable in both; the result takes kappa's type and device."""
    kappa = torch.as_tensor(kappa)
    omega = torch.as_tensor(omega, dtype=kappa.dtype, device=kappa.device)
    single, ts, nonsyn = (torch.as_tensor(x, device=kappa.device)
                          for x in _pair_classes())
    one = torch.ones((), dtype=kappa.dtype, device=kappa.device)
    out = single.to(kappa.dtype)
    out = out * torch.where(ts, kappa, one)
    return out * torch.where(nonsyn, omega, one)


def f3x4_frequencies_torch(table) -> torch.Tensor:
    """f3x4_frequencies from a [3, 4] tensor, differentiable in it."""
    table = torch.as_tensor(table)
    table = table / table.sum(dim=1, keepdim=True)
    pos = torch.as_tensor(_positions(), device=table.device)
    freqs = table[0, pos[:, 0]] * table[1, pos[:, 1]] * table[2, pos[:, 2]]
    return freqs / freqs.sum()
