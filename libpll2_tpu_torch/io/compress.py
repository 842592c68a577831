"""Site-pattern compression (a copy of libpll2_tpu/io/compress.py).

Reference semantics (libpll-2 src/compress.c): encode alignment columns
through the state map, sort columns lexicographically (the reference's
multikey quicksort, compress.c:40-97, yields exactly lexicographic order —
pivot choice only affects tie order, which dedup erases), deduplicate into
unique patterns with weights, optionally produce the original-site ->
pattern index map, and decode back to characters using the lowest-ASCII
representative per state ('-' canonical for gaps, compress.c:228-235).

Vectorized with numpy, or the port's native binding (native.py) where it
builds, instead of the reference's per-column pointer sort; both give the
patterns in the same (lexicographic) order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _charmaps(map_arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(charmap, inv_charmap) byte maps. Mirrors compress.c:214-235,
    including the remap when state values exceed the byte range
    (compress.c:99-135: distinct map values sorted ascending -> 1..n)."""
    if map_arr[0] != 0:
        raise ValueError("'0' cannot be used as a state")
    if map_arr.max() >= 256:
        vals = np.unique(map_arr[map_arr != 0])
        lut = {int(v): i + 1 for i, v in enumerate(vals)}
        charmap = np.array([lut.get(int(v), 0) for v in map_arr],
                           dtype=np.uint8)
    else:
        charmap = map_arr.astype(np.uint8)
    inv = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        c = charmap[i]
        if map_arr[i] and (inv[c] == 0 or i == ord("-")):
            inv[c] = i
    return charmap, inv


def compress_site_patterns(sequences: Sequence[str], map_arr: np.ndarray,
                           return_map: bool = False):
    """Compress identical alignment columns into weighted patterns.

    Returns (compressed_sequences, weights[, site_pattern_map]).
    Mirrors pll_compress_site_patterns[_msa] (compress.c:395-410).
    """
    count = len(sequences)
    if count == 0:
        raise ValueError("number of sequences must be greater than 0")
    length = len(sequences[0])
    if any(len(s) != length for s in sequences):
        raise ValueError("sequences differ in length")

    charmap, inv_charmap = _charmaps(np.asarray(map_arr))
    raw = np.frombuffer("".join(sequences).encode("ascii"),
                        np.uint8).reshape(count, length)
    enc = charmap[raw]
    if np.any(enc == 0):
        i, j = np.argwhere(enc == 0)[0]
        raise ValueError(f"cannot encode character {chr(raw[i, j])!r} at "
                         f"sequence {i + 1} position {j + 1}")

    from .. import native
    if native.available():
        inverse, weights, reps = native.compress_patterns(enc)
        dec = inv_charmap[enc[:, reps]]            # [count, n_patterns]
    else:
        cols = enc.T                               # [length, count]
        patterns, inverse, weights = np.unique(
            cols, axis=0, return_inverse=True, return_counts=True)
        dec = inv_charmap[patterns.T]              # [count, n_patterns]
    out = ["".join(map(chr, row)) for row in dec]
    if return_map:
        return out, weights.astype(np.uint32), inverse.astype(np.uint32)
    return out, weights.astype(np.uint32)
