"""Text-input opener: plain files, .gz, and stdin via `-`.

Mirrors the reference's buffered line reader semantics
(line_reader.cpp: gz-capable, `-` reads stdin) for every line-oriented
input (BED, Bismark .cov, eval label files).
"""
from __future__ import annotations

import gzip
import io
import sys
from contextlib import contextmanager


@contextmanager
def open_text(path: str):
    """Yield a text-mode line iterator for `path`.

    `-` -> stdin (never closed); `*.gz` -> transparent gunzip; otherwise a
    plain text file.  Gzipped stdin is detected by magic bytes.
    """
    if path == "-":
        raw = sys.stdin.buffer
        head = raw.peek(2)[:2] if hasattr(raw, "peek") else b""
        if head == b"\x1f\x8b":
            with gzip.open(raw, "rt") as f:
                yield f
        else:
            yield io.TextIOWrapper(raw, write_through=True)
        return
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        yield f


def read_bytes(path: str) -> bytes:
    """Whole-input bytes with the same `-`/gz conventions as open_text
    (for native text scanners that parse a full buffer)."""
    if path == "-":
        data = sys.stdin.buffer.read()
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        return data
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()
