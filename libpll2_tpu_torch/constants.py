"""Framework-wide constants and character-state maps.

Constants mirror the numerical semantics of the reference C library
(libpll-2 src/pll.h:96-204 and maps.c); the encodings are built
programmatically rather than as 256-entry tables.  Same values as
libpll2_tpu/constants.py.

A "state" is a bitmask over the alphabet: bit k set means the observed
character is compatible with state k (IUPAC ambiguity codes are ORs of bits,
gaps are all-ones).
"""
from __future__ import annotations

import numpy as np

# --- numerical scaling (pll.h:96-104) ---------------------------------------
SCALE_FACTOR = 2.0 ** 256          # multiply applied when a site CLV underflows
SCALE_THRESHOLD = 2.0 ** -256      # trigger: all entries below this
SCALE_FACTOR_SQRT = 2.0 ** 128
SCALE_THRESHOLD_SQRT = 2.0 ** -128
SCALE_RATE_MAXDIFF = 4             # per-rate scaling: cap on relative scalers
SCALE_BUFFER_NONE = -1

MISC_EPSILON = 1e-8
ONE_EPSILON = 1e-15
EIGEN_MINFREQ = 1e-6               # zero-frequency state elimination threshold

# --- gamma rates modes (pll.h:203-204) --------------------------------------
GAMMA_RATES_MEAN = 0
GAMMA_RATES_MEDIAN = 1

# --- ascertainment bias types (pll.h:125-128) -------------------------------
AB_NONE = 0
AB_LEWIS = 1
AB_FELSENSTEIN = 2
AB_STAMATAKIS = 3

# --- traversal (pll.h:151-157) ----------------------------------------------
TRAVERSE_POSTORDER = 1
TRAVERSE_PREORDER = 2

# ASCII tree render options (pll.h:194-199, PLL_UTREE_SHOW_*)
SHOW_LABEL = 1 << 0
SHOW_BRANCH_LENGTH = 1 << 1
SHOW_CLV_INDEX = 1 << 2
SHOW_SCALER_INDEX = 1 << 3
SHOW_PMATRIX_INDEX = 1 << 4

# --- character-state maps ---------------------------------------------------
# Built programmatically; semantics equal to the reference tables
# (maps.c:26-265): value is a bitmask over states, 0 = illegal char.


def _build_map(single: dict[str, int], ambig: dict[str, str], nstates: int,
               gaps: str = "-?.") -> np.ndarray:
    """Build a 256-entry char -> state-bitmask map (case-insensitive)."""
    out = np.zeros(256, dtype=np.uint64)
    gap_state = (1 << nstates) - 1

    def setchar(c: str, v: int) -> None:
        out[ord(c.lower())] = v
        out[ord(c.upper())] = v

    for c, k in single.items():
        setchar(c, 1 << k)
    for c, expansion in ambig.items():
        v = 0
        for e in expansion:
            v |= 1 << single[e]
        setchar(c, v)
    for c in gaps:
        out[ord(c)] = gap_state
    return out


# Binary data: 0 -> state 0, 1 -> state 1 (maps.c pll_map_bin).
MAP_BIN = _build_map({"0": 0, "1": 1}, {}, 2)

# DNA: A,C,G,T(U); IUPAC ambiguities; N/X/O treated per reference table.
_DNA_SINGLE = {"A": 0, "C": 1, "G": 2, "T": 3}
_DNA_AMBIG = {
    "U": "T", "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT",
    "M": "AC", "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
    "N": "ACGT", "O": "ACGT", "X": "ACGT",
}
MAP_NT = _build_map(_DNA_SINGLE, _DNA_AMBIG, 4)

# Amino acids: ARNDCQEGHILKMFPSTWYV order (state index = position in this
# string), with B = N|D, Z = Q|E, J = I|L, X/?/*/-/. = all 20 bits
# (maps.c pll_map_aa).
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
_AA_SINGLE = {c: i for i, c in enumerate(AA_ORDER)}
_AA_AMBIG = {"B": "ND", "Z": "QE", "J": "IL", "X": AA_ORDER}
MAP_AA = _build_map(_AA_SINGLE, _AA_AMBIG, 20, gaps="-?.*")

# Unphased genotypes, 10 states: A C G T M R W S Y K (maps.c pll_map_gt10).
_GT10_SINGLE = {"A": 0, "C": 1, "G": 2, "T": 3, "M": 4, "R": 5, "W": 6,
                "S": 7, "Y": 8, "K": 9}
MAP_GT10 = _build_map(_GT10_SINGLE, {"U": "T"}, 10, gaps="-?NOX")

# Phased genotypes, 16 states (maps.c pll_map_gt16).  Bit layout:
# 0..3 = homozygotes A C G T; 4..9 = AC AG AT CG CT GT; 10..15 = the reverse
# phases CA GA TA GC TC TG.  IUPAC heterozygote codes set both phase bits.
MAP_GT16 = np.zeros(256, dtype=np.uint64)
_GT16_CODES = {
    "A": 0x0001, "C": 0x0002, "G": 0x0004, "T": 0x0008, "U": 0x0008,
    "M": 0x0410,  # A/C + C/A
    "R": 0x0820,  # A/G + G/A
    "W": 0x1040,  # A/T + T/A
    "S": 0x2080,  # C/G + G/C
    "Y": 0x4100,  # C/T + T/C
    "K": 0x8200,  # G/T + T/G
}
for _c, _v in _GT16_CODES.items():
    MAP_GT16[ord(_c.lower())] = _v
    MAP_GT16[ord(_c.upper())] = _v
for _c in "-?NOX":
    MAP_GT16[ord(_c.lower())] = 0xFFFF
    MAP_GT16[ord(_c.upper())] = 0xFFFF
del _c, _v

MAPS = {"bin": MAP_BIN, "nt": MAP_NT, "aa": MAP_AA, "gt10": MAP_GT10,
        "gt16": MAP_GT16}


def gap_state(states: int) -> int:
    return (1 << states) - 1


def gap_state_int32(states: int) -> int:
    """gap_state as an int32 tip mask holds it: all ones, -1, at 32
    states (numpy and torch refuse to cast 2^32 - 1 to int32)."""
    gap = gap_state(states)
    return gap - (1 << 32) if gap >= 1 << 31 else gap


# Tip masks: int32 up to INT32_MASK_STATES states (every path of the port),
# int64 from there up to MAX_MASK_STATES (libpll-2's 64-bit pll_state_t:
# codon models at 61 states); an entry that reads int32 masks refuses more
# states than INT32_MASK_STATES.
INT32_MASK_STATES = 32
MAX_MASK_STATES = 64


def tip_mask_dtype(states: int):
    """The numpy type of a tip mask at `states`: int32 up to
    INT32_MASK_STATES, int64 up to MAX_MASK_STATES."""
    if not 1 <= states <= MAX_MASK_STATES:
        raise ValueError(f"a tip mask holds 1 to {MAX_MASK_STATES} states, "
                         f"got {states}")
    return np.int32 if states <= INT32_MASK_STATES else np.int64


def tip_mask_torch_dtype(states: int):
    """tip_mask_dtype as a torch type: torch.int32 or torch.int64."""
    import torch
    return torch.int32 if tip_mask_dtype(states) == np.int32 else torch.int64


def gap_state_mask(states: int) -> int:
    """gap_state as the tip mask of `tip_mask_dtype(states)` holds it: all
    ones, -1, at 32 and at 64 states."""
    if tip_mask_dtype(states) == np.int32:
        return gap_state_int32(states)
    gap = gap_state(states)
    return gap - (1 << 64) if gap >= 1 << 63 else gap
