"""PyTorch + CUDA port of libpll2_tpu (the phylogenetic likelihood engine).

The forward likelihood step runs here: tree -> compiled program
(engine.compile_tree) -> model (engine.make_model) -> full-tree
log-likelihood (engine.loglikelihood), whose CLV sweep runs in a
hand-written CUDA kernel (csrc/tree_sweep.cu) on CUDA tensors and in its
plain PyTorch version on CPU tensors.  Module names follow libpll2_tpu so
that each function's counterpart is easy to find.  This package imports
torch and never jax.
"""
from .config import PartitionConfig
from .constants import MAP_AA, MAP_NT

__all__ = ["PartitionConfig", "MAP_AA", "MAP_NT"]
