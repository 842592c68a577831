"""Parsimony subsystem: weighted (Sankoff) DP and bit-parallel (Fitch)
scoring, plus randomized stepwise-addition tree building
(reference: libpll-2 src/parsimony.c, src/fast_parsimony.c,
src/stepwise.c)."""
from .sankoff import Parsimony, ParsBuildOp, ParsRecOp
from .fitch import FastParsimony
from .stepwise import (fastparsimony_stepwise,
                       fastparsimony_stepwise_extend,
                       fastparsimony_stepwise_spr_round)

__all__ = ["Parsimony", "ParsBuildOp", "ParsRecOp", "FastParsimony",
           "fastparsimony_stepwise", "fastparsimony_stepwise_spr_round",
           "fastparsimony_stepwise_extend"]
