"""Multiple-sequence-alignment container (mirrors pll_msa_t, pll.h:348-354).

A copy of libpll2_tpu/io/msa.py.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class MSA:
    labels: List[str]
    sequences: List[str]

    @property
    def count(self) -> int:
        return len(self.sequences)

    @property
    def length(self) -> int:
        return len(self.sequences[0]) if self.sequences else 0

    def __post_init__(self):
        if len(self.labels) != len(self.sequences):
            raise ValueError("labels/sequences count mismatch")
