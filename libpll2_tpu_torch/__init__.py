"""PyTorch + CUDA port of libpll2_tpu (the phylogenetic likelihood engine).

The one-call inference journey (infer.infer_ml_tree: FASTA or PHYLIP in,
pattern compression, a stepwise-addition parsimony start, SPR search and a
gradient model fit), the forward likelihood step (engine.compile_tree ->
engine.make_model -> engine.loglikelihood), the training step
(engine.optimize_root_branch) and the SPR tree search
(search_fast.hill_climb) run here.  Two hand-written CUDA kernels carry
their hot paths on CUDA tensors: the CLV tree sweep (csrc/tree_sweep.cu)
and the SPR edge scorer (csrc/edge_score.cu); on CPU tensors their plain
PyTorch versions run.  Module names follow libpll2_tpu so that each
function's counterpart is easy to find.  This package imports torch and
never jax.
"""
from .config import PartitionConfig
from .constants import MAP_AA, MAP_BIN, MAP_GT10, MAP_GT16, MAP_NT, MAPS
from .infer import InferenceResult, infer_ml_tree
from .parsimony import FastParsimony, ParsBuildOp, Parsimony, ParsRecOp

__all__ = ["infer_ml_tree", "InferenceResult", "PartitionConfig",
           "Parsimony", "FastParsimony", "ParsBuildOp", "ParsRecOp",
           "MAP_NT", "MAP_AA", "MAP_BIN", "MAP_GT10", "MAP_GT16", "MAPS"]
