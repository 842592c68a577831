"""PyTorch + CUDA port of libpll2_tpu (the phylogenetic likelihood engine).

libpll-2's partition API (`Partition`: tip states, P-matrices, CLV
updates with site repeats, root/edge likelihoods, derivatives, marginal
ancestral states) runs in plain PyTorch on one device.  The one-call
inference journey (infer.infer_ml_tree: FASTA or PHYLIP in,
pattern compression, a stepwise-addition parsimony start, SPR search and a
gradient model fit), the forward likelihood step (engine.compile_tree ->
engine.make_model -> engine.loglikelihood), the training step
(engine.optimize_root_branch) and the SPR tree search
(search_fast.hill_climb) run here.  Hand-written CUDA kernels carry
their hot paths on CUDA tensors: the CLV tree sweep (csrc/tree_sweep.cu),
the SPR edge scorer (csrc/edge_score.cu) and the all-directions message
sweep of the smoothing, the search and the fit's backward
(csrc/message_sweep.cu); on CPU tensors their plain PyTorch versions
run.  The sites of a partition shard over the ranks of
a torch.distributed process group (parallel/), each rank running this
engine on its slice.  Module names follow libpll2_tpu so that each
function's counterpart is easy to find.  This package imports torch and
never jax.
"""
from . import constants
from .config import PartitionConfig
from .constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE, AB_STAMATAKIS,
                        GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN, MAP_AA,
                        MAP_BIN, MAP_GT10, MAP_GT16, MAP_NT, MAPS,
                        SCALE_BUFFER_NONE, SHOW_BRANCH_LENGTH,
                        SHOW_CLV_INDEX, SHOW_LABEL, SHOW_PMATRIX_INDEX,
                        SHOW_SCALER_INDEX)
from .infer import InferenceResult, infer_ml_tree
from .models.gamma import compute_gamma_cats
from .models.ratematrix import update_eigen
from .parsimony import FastParsimony, ParsBuildOp, Parsimony, ParsRecOp
from .partition import Operation, Partition, levelize_operations

__all__ = [
    "infer_ml_tree", "InferenceResult",
    "Partition", "Operation", "PartitionConfig", "levelize_operations",
    "compute_gamma_cats", "update_eigen", "constants",
    "Parsimony", "FastParsimony", "ParsBuildOp", "ParsRecOp",
    "MAP_NT", "MAP_AA", "MAP_BIN", "MAP_GT10", "MAP_GT16", "MAPS",
    "GAMMA_RATES_MEAN", "GAMMA_RATES_MEDIAN", "SCALE_BUFFER_NONE",
    "AB_NONE", "AB_LEWIS", "AB_FELSENSTEIN", "AB_STAMATAKIS",
    "SHOW_LABEL", "SHOW_BRANCH_LENGTH", "SHOW_CLV_INDEX",
    "SHOW_SCALER_INDEX", "SHOW_PMATRIX_INDEX",
]
