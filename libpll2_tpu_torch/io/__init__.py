"""Alignment I/O: FASTA/PHYLIP readers, MSA container, pattern compression
(reference: libpll-2 src/fasta.c, src/phylip.c, src/compress.c)."""
from .compress import compress_site_patterns
from .fasta import FastaFile, iter_fasta, load_fasta_msa, load_fasta_string
from .msa import MSA
from .phylip import (load_phylip, load_phylip_interleaved,
                     load_phylip_sequential, load_phylip_string)

__all__ = [
    "MSA", "FastaFile", "compress_site_patterns", "iter_fasta",
    "load_fasta_msa",
    "load_fasta_string", "load_phylip", "load_phylip_interleaved",
    "load_phylip_sequential", "load_phylip_string",
]
