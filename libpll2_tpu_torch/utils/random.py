"""Reentrant glibc-compatible RNG (reference: libpll-2 src/random.c).

A copy of libpll2_tpu/utils/random.py (numpy only).

The reference vendors glibc's TYPE_3 ``random_r`` family so that pattern
compression and stepwise-addition shuffles are deterministic seed-for-seed
across platforms (SURVEY.md C26).  Stepwise trees are defined by these
shuffles, so parity requires bit-exact reimplementation:

  * seeding (pll_srandom_r, random.c:155-207): LCG
    ``state[i] = 16807 * state[i-1] mod 2^31-1`` via Schrage's trick,
    then 10*31 discarded outputs;
  * output (pll_random_r, random.c:345-392): additive trinomial
    ``state[f] += state[r]`` (int32 wraparound), result = top 31 bits,
    front/rear pointers advance cyclically with separation 3, degree 31
    (TYPE_3, 128-byte state).
"""
from __future__ import annotations

from typing import List

import numpy as np

RAND_MAX = 2147483647


class GlibcRandom:
    """glibc TYPE_3 random_r: degree 31, separation 3."""

    DEG = 31
    SEP = 3

    def __init__(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        if seed >= 0x80000000:          # (int32_t) seed
            seed -= 0x100000000
        state = [0] * self.DEG
        state[0] = seed & 0xFFFFFFFF
        word = seed
        for i in range(1, self.DEG):
            # state[i] = (16807 * state[i-1]) % 2147483647, Schrage
            hi = int(word / 127773)     # C division truncates toward zero
            lo = word - 127773 * hi
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            state[i] = word
        self._state: List[int] = state  # uint32 words
        self._f = self.SEP
        self._r = 0
        for _ in range(self.DEG * 10):
            self.next()

    def next(self) -> int:
        """One 31-bit output (pll_random_r trinomial path)."""
        s = self._state
        val = (s[self._f] + s[self._r]) & 0xFFFFFFFF
        s[self._f] = val
        self._f += 1
        if self._f >= self.DEG:
            self._f = 0
        self._r += 1
        if self._r >= self.DEG:
            self._r = 0
        return val >> 1


def create_shuffled(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates shuffle of 0..n-1, glibc-exact (stepwise.c:56-106).

    seed == 0 means identity (no shuffle)."""
    x = np.arange(n, dtype=np.uint32)
    if seed == 0:
        return x
    rng = GlibcRandom(seed)
    i = n - 1
    if n > 1:
        while True:
            r = rng.next() / RAND_MAX
            j = int(r * (i + 1))
            x[i], x[j] = x[j], x[i]
            if i == 0:
                break
            i -= 1
    return x
