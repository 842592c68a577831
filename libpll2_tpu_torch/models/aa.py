"""Empirical amino-acid substitution models (numpy only).

Counterpart of libpll2_tpu/models/aa.py, with its own copy of the tables:
the 28 fixed-parameter 20-state models plus the LG4M/LG4X four-matrix
mixtures that libpll-2 exports as global tables (reference:
src/maps.c:265-1755, declarations src/pll.h:566-630).  The numeric tables
(published model constants, Dayhoff 1978 ... Q.* 2021) are stored in
data/aa_tables.npz.

Usage with the engine:

    rates, freqs = aa_model("lg")          # [190], [20]
    model = engine.make_model([rates], [freqs], gamma_rates)

    rates4, freqs4 = aa_model("lg4x")      # [4, 190], [4, 20]
    model = engine.make_model(rates4, freqs4, gamma_rates,
                              params_indices=[0, 1, 2, 3])

LG4M/LG4X use one rate matrix per Gamma category (maps.c:1222,1356): that
is what per-category params_indices exists for.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent / "data" / "aa_tables.npz"

# names as libpll-2 exports them (pll.h:566-630), lowercase
AA_MODEL_NAMES = (
    "dayhoff", "lg", "dcmut", "jtt", "mtrev", "wag", "rtrev", "cprev", "vt",
    "blosum62", "mtmam", "mtart", "mtzoa", "pmb", "hivb", "hivw", "jttdcmut",
    "flu", "stmtrev", "den", "q_pfam", "q_pfam_gb", "q_lg", "q_bird",
    "q_insect", "q_mammal", "q_plant", "q_yeast",
)
AA_MIXTURE_NAMES = ("lg4m", "lg4x")


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(_DATA) as z:
        return dict(z)


def aa_model(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (exchangeability rates, frequencies) for a named model.

    Plain models return ([190], [20]); LG4M/LG4X return ([4,190], [4,20]).
    """
    key = name.lower().replace(".", "_").replace("-", "_")
    t = _tables()
    if f"rates_{key}" not in t:
        raise KeyError(
            f"unknown AA model {name!r}; available: "
            f"{', '.join(AA_MODEL_NAMES + AA_MIXTURE_NAMES)}")
    return t[f"rates_{key}"].copy(), t[f"freqs_{key}"].copy()


def available_models() -> tuple[str, ...]:
    return AA_MODEL_NAMES + AA_MIXTURE_NAMES
