"""PHYLIP reader — interleaved and sequential formats (a copy of
libpll2_tpu/io/phylip.py).

Reference semantics (libpll-2 src/phylip.c): header line `count length`
(phylip.c:192-240); labels are whitespace-delimited tokens; sequence data
characters are validated against a char-status map where cr/lf/tab/space
are stripped and graphic chars kept (dfa_parse, phylip.c:27-90);
interleaved blocks must advance all sequences by the same amount
(parse_oneline_sequence, phylip.c:242-280); CRLF tolerated.
"""
from __future__ import annotations

import io
from typing import List, TextIO, Union

from .msa import MSA

_STRIP = set(" \t\r\n\x00\v\f")


class PhylipError(ValueError):
    pass


def _clean(chunk: str, lineno: int) -> str:
    out = []
    for c in chunk:
        if c in _STRIP:
            continue
        if not c.isprintable():
            raise PhylipError(f"illegal character {c!r} on line {lineno}")
        out.append(c)
    return "".join(out)


def _read_header(lines: List[str]) -> tuple[int, int, int]:
    for i, line in enumerate(lines):
        if line.strip():
            parts = line.split()
            if len(parts) < 2:
                raise PhylipError("invalid PHYLIP header")
            try:
                count, length = int(parts[0]), int(parts[1])
            except ValueError as e:
                raise PhylipError("invalid PHYLIP header") from e
            if count <= 0 or length <= 0:
                raise PhylipError("invalid PHYLIP header")
            return count, length, i + 1
    raise PhylipError("missing PHYLIP header")


def _source_lines(source: Union[str, TextIO]) -> List[str]:
    if isinstance(source, str):
        with open(source) as fh:
            return fh.readlines()
    return source.readlines()


def load_phylip_sequential(source: Union[str, TextIO]) -> MSA:
    """Mirrors pll_phylip_parse_sequential (phylip.c:570-650)."""
    lines = _source_lines(source)
    count, length, start = _read_header(lines)
    labels: List[str] = []
    seqs: List[str] = []
    i = start
    for s in range(count):
        # skip blank lines, read label token then data until `length` chars
        while i < len(lines) and not lines[i].strip():
            i += 1
        if i >= len(lines):
            raise PhylipError(f"missing sequence {s + 1}")
        parts = lines[i].split(None, 1)
        label = parts[0]
        data = _clean(parts[1] if len(parts) > 1 else "", i + 1)
        i += 1
        while len(data) < length:
            if i >= len(lines):
                raise PhylipError(
                    f"sequence {s + 1} ({label}) shorter than expected")
            data += _clean(lines[i], i + 1)
            i += 1
        if len(data) > length:
            raise PhylipError(
                f"sequence {s + 1} ({label}) longer than expected")
        labels.append(label)
        seqs.append(data)
    return MSA(labels, seqs)


def load_phylip_interleaved(source: Union[str, TextIO]) -> MSA:
    """Mirrors pll_phylip_parse_interleaved (phylip.c:382-470)."""
    lines = _source_lines(source)
    count, length, start = _read_header(lines)
    labels: List[str] = []
    chunks: List[List[str]] = [[] for _ in range(count)]
    lens = [0] * count
    i = start
    # first block: labels + data
    s = 0
    while s < count:
        if i >= len(lines):
            raise PhylipError(f"missing sequence {s + 1}")
        if not lines[i].strip():
            i += 1
            continue
        parts = lines[i].split(None, 1)
        labels.append(parts[0])
        data = _clean(parts[1] if len(parts) > 1 else "", i + 1)
        chunks[s].append(data)
        lens[s] += len(data)
        i += 1
        s += 1
    # subsequent blocks: data only, aligned advancement
    s = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        if min(lens) >= length:
            break
        data = _clean(lines[i], i + 1)
        chunks[s].append(data)
        lens[s] += len(data)
        if lens[s] > length:
            raise PhylipError(
                f"sequence {s + 1} ({labels[s]}) longer than expected")
        i += 1
        s = (s + 1) % count
    if any(n != length for n in lens):
        bad = next(k for k, n in enumerate(lens) if n != length)
        raise PhylipError(
            f"sequence {bad + 1} ({labels[bad]}) out of alignment")
    return MSA(labels, ["".join(c) for c in chunks])


def load_phylip(source: Union[str, TextIO], interleaved: bool) -> MSA:
    """Mirrors pll_phylip_load (phylip.c:700-751)."""
    if interleaved:
        return load_phylip_interleaved(source)
    return load_phylip_sequential(source)


def load_phylip_string(text: str, interleaved: bool) -> MSA:
    return load_phylip(io.StringIO(text), interleaved)
