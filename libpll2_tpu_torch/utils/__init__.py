"""Host utilities: the glibc-exact RNG of stepwise addition and
checkpointing of fit parameters."""
from .random import RAND_MAX, GlibcRandom, create_shuffled

__all__ = ["GlibcRandom", "create_shuffled", "RAND_MAX"]
