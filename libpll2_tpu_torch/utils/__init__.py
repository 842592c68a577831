"""Host utilities: the glibc-exact RNG of stepwise addition, checkpointing
of fit parameters, the debug printers and hardware probe (output.py) and
memory accounting (memory.py)."""
from .output import (format_clv, format_pmatrix, hardware_dump,
                     hardware_probe, show_clv, show_pmatrix)
from .random import RAND_MAX, GlibcRandom, create_shuffled

__all__ = ["GlibcRandom", "create_shuffled", "RAND_MAX",
           "format_pmatrix", "format_clv", "show_pmatrix", "show_clv",
           "hardware_probe", "hardware_dump"]
