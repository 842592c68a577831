"""The reference's codon model: GY94 exchangeabilities and F3x4
frequencies over the 61 sense codons of the standard genetic code, in
float64 NumPy, written from the definitions (Goldman & Yang 1994, MBE
11:725-736) and not from the program.

States are the 64 triplets of ACGT in lexicographic order without the
stop codons TAA, TAG and TGA.  Two sense codons exchange at 0 where they
differ at more than one position, else at 1, times kappa for a transition
(A<->G or C<->T), times omega where their amino acids differ.  F3x4: the
product of the three positions' nucleotide frequencies, renormalised over
the sense codons.  The likelihood itself is likelihood.py's, which takes
any state count that a uint64 tip mask holds.
"""
from __future__ import annotations

import numpy as np

# the standard code's amino acids of AAA, AAC, ..., TTT (ACGT order)
CODE_ACGT = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"


def sense_codons() -> list:
    """The 61 sense codons, as strings, in state order."""
    out = []
    for index in range(64):
        codon = "".join("ACGT"[(index >> shift) & 3] for shift in (4, 2, 0))
        if CODE_ACGT[index] != "*":
            out.append(codon)
    return out


def gy94(kappa: float, omega: float) -> np.ndarray:
    """The [1830] exchangeabilities, the upper triangle row by row."""
    codons = sense_codons()
    amino = {c: CODE_ACGT[int("".join(str("ACGT".index(n)) for n in c), 4)]
             for c in codons}
    purine = {"A": True, "G": True, "C": False, "T": False}
    n = len(codons)
    rates = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            a, b = codons[i], codons[j]
            where = [k for k in range(3) if a[k] != b[k]]
            if len(where) != 1:
                continue
            x, y = a[where[0]], b[where[0]]
            rate = kappa if purine[x] == purine[y] else 1.0
            if amino[a] != amino[b]:
                rate *= omega
            rates[i, j] = rate
    return rates[np.triu_indices(n, 1)]


def f3x4(table) -> np.ndarray:
    """The [61] frequencies from a [3, 4] table (A, C, G, T at positions
    1-3), each row normalised to 1 first."""
    table = np.asarray(table, dtype=np.float64)
    table = table / table.sum(axis=1)[:, None]
    freqs = np.array([np.prod([table[k, "ACGT".index(c[k])]
                               for k in range(3)])
                      for c in sense_codons()])
    return freqs / freqs.sum()
