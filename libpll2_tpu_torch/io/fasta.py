"""FASTA reader (a copy of libpll2_tpu/io/fasta.py).

Reference semantics (libpll-2 src/fasta.c): streaming record iterator with
a char-status filter — legal data characters are kept, cr/lf/tab/space/nul
silently stripped (with counts), anything else is fatal (fasta.c:27-60
chrstatus tables); headers start with '>' and everything after it up to
newline is the label.  pll_fasta_load (fasta.c:328-417) additionally
requires all sequences to have equal length when building an MSA — we keep
that check in load_fasta_msa but not in the iterator.
"""
from __future__ import annotations

import io
from typing import Iterator, Optional, TextIO, Tuple, Union

from .msa import MSA

_STRIP = set(" \t\r\n\x00\v\f")


class FastaError(ValueError):
    pass


def iter_fasta(source: Union[str, TextIO]) -> Iterator[Tuple[str, str]]:
    """Yield (header, sequence) records. `source` is a path or file object."""
    close = False
    if isinstance(source, str):
        fh: TextIO = open(source)
        close = True
    else:
        fh = source
    try:
        header: Optional[str] = None
        chunks: list[str] = []
        lineno = 0
        for line in fh:
            lineno += 1
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].strip()
                chunks = []
            else:
                if header is None:
                    if line.strip() == "":
                        continue
                    raise FastaError(
                        f"Illegal data before first header (line {lineno})")
                kept = [c for c in line if c not in _STRIP]
                for c in kept:
                    if not (c.isalnum() or c in "-?*.!"):
                        raise FastaError(
                            f"Illegal character {c!r} on line {lineno}")
                chunks.append("".join(kept))
        if header is not None:
            yield header, "".join(chunks)
    finally:
        if close:
            fh.close()


class FastaFile:
    """Streaming record-at-a-time FASTA reader with rewind/position.

    The pll_fasta_t handle API (fasta.c:40-326): pll_fasta_open ->
    FastaFile(path); pll_fasta_getnext -> getnext() returning
    (header, sequence, seqno) or None at EOF; pll_fasta_rewind /
    pll_fasta_getfilepos / pll_fasta_getfilesize / pll_fasta_close have
    direct analogs.  Reads line-at-a-time — genuinely streaming for
    huge inputs; `stripped` counts silently-removed whitespace by char
    code, as the reference's fd->stripped table does.  Usable as a
    context manager and as an iterator over (header, sequence) pairs.
    """

    def __init__(self, filename: str):
        self._fh = open(filename)
        self._fh.seek(0, io.SEEK_END)
        self.filesize = self._fh.tell()
        self._fh.seek(0)
        self.lineno = 0
        self.seqno = 0
        self.stripped_count = 0
        self.stripped: dict[str, int] = {}
        self._pending: Optional[str] = None   # lookahead header line

    def rewind(self) -> None:
        self._fh.seek(0)
        self.lineno = 0
        self.seqno = 0
        self.stripped_count = 0
        self.stripped = {}
        self._pending = None

    def getfilepos(self) -> int:
        return self._fh.tell()

    def getnext(self) -> Optional[Tuple[str, str, int]]:
        """Next (header, sequence, seqno) record, or None at EOF."""
        # readline() (not file iteration) so tell() stays usable for
        # getfilepos — CPython disables tell during `for line in fh`
        line = self._pending
        self._pending = None
        while line is None or line.strip() == "":
            line = self._fh.readline()
            if not line:
                return None
            self.lineno += 1
        if not line.startswith(">"):
            raise FastaError(
                f"Expected '>' header on line {self.lineno}")
        header = line[1:].strip()
        chunks: list[str] = []
        while True:
            line = self._fh.readline()
            if not line:
                break
            self.lineno += 1
            if line.startswith(">"):
                self._pending = line
                break
            for c in line:
                if c in _STRIP:
                    self.stripped_count += 1
                    self.stripped[c] = self.stripped.get(c, 0) + 1
                elif c.isalnum() or c in "-?*.!":
                    chunks.append(c)
                else:
                    raise FastaError(
                        f"Illegal character {c!r} on line {self.lineno}")
        self.seqno += 1
        return header, "".join(chunks), self.seqno

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        while (rec := self.getnext()) is not None:
            yield rec[0], rec[1]

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "FastaFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_fasta_msa(source: Union[str, TextIO]) -> MSA:
    """Whole-file load into an MSA; mirrors pll_fasta_load (fasta.c:328)."""
    labels: list[str] = []
    seqs: list[str] = []
    if isinstance(source, str):
        from .. import native
        if native.available():
            try:
                labels, seqs = native.fasta_load(source)
            except ValueError as e:
                raise FastaError(str(e)) from None
    if not labels:
        for head, seq in iter_fasta(source):
            labels.append(head)
            seqs.append(seq)
    if not seqs:
        raise FastaError("empty FASTA file")
    if any(len(s) != len(seqs[0]) for s in seqs):
        raise FastaError("FASTA sequences differ in length (not an MSA)")
    return MSA(labels, seqs)


def load_fasta_string(text: str) -> MSA:
    return load_fasta_msa(io.StringIO(text))
