"""In-memory FASTA database.

Replicates HbnDatabase semantics (src/corelib/hbn_seqdb.cpp:36-95 of the
reference):
- plain or gzip input, '-' for stdin
- comment lines starting with '!', '#', ';' are skipped
- a header is any '>' line, or a bare line whose first 33 bytes contain a
  digit or '|' (the reference's s_IsSeqID heuristic, hbn_seqdb.cpp:7-16)
- sequence names are the first whitespace-delimited token of the header
- all bases are uppercased
"""
from __future__ import annotations

import gzip
import re
import sys

import numpy as np

from ..utils.logging import bytes_to_datasize, log

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32
_SEQID_RE = re.compile(rb"[0-9|]")


class FastaDatabase:
    def __init__(self, path: str, quiet: bool = False):
        self.names: list[str] = []
        self.seqs: list[np.ndarray] = []  # uint8 ASCII, uppercase
        self._name2id: dict[str, int] = {}

        if path == "-":
            fh = sys.stdin.buffer
        elif path.endswith(".gz"):
            fh = gzip.open(path, "rb")
        else:
            fh = open(path, "rb")

        cur_name: str | None = None
        cur_parts: list[bytes] = []
        try:
            for raw in fh:
                line = raw.strip()
                if not line or line[0] in b"!#;":
                    continue
                if line[0] == 62 or _SEQID_RE.search(line, 0, 33):   # '>'
                    if cur_name is not None:
                        self._add(cur_name, cur_parts)
                    cur_name = (line[1:] if line[0] == 62
                                else line).split()[0].decode()
                    cur_parts = []
                else:
                    cur_parts.append(line)
            if cur_name is not None:
                self._add(cur_name, cur_parts)
        finally:
            if fh is not sys.stdin.buffer:
                fh.close()

        if not quiet:
            log("Load %d sequences (%s) from %s", self.num_seqs,
                bytes_to_datasize(self.num_bases), path)

    def _add(self, name: str, parts: list[bytes]) -> None:
        if name in self._name2id:
            raise ValueError(f"Duplicate sequence name {name}")
        self._name2id[name] = len(self.names)
        self.names.append(name)
        self.seqs.append(_UPPER[np.frombuffer(b"".join(parts), np.uint8)])

    @property
    def num_seqs(self) -> int:
        return len(self.names)

    @property
    def num_bases(self) -> int:
        return int(sum(len(s) for s in self.seqs))

    def seq_name2id(self, name: str) -> int:
        try:
            return self._name2id[name]
        except KeyError:
            raise KeyError(f"sequence name {name!r} not found in database") from None

    def seq_name(self, sid: int) -> str:
        return self.names[sid]

    def seq_length(self, sid: int) -> int:
        return len(self.seqs[sid])

    def seq_bases(self, sid: int) -> np.ndarray:
        """Uppercased ASCII uint8 array."""
        return self.seqs[sid]

    def seq_str(self, sid: int) -> str:
        return self.seqs[sid].tobytes().decode()
