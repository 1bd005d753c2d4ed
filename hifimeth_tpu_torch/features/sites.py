"""Candidate 5mC site discovery on the native-forward read.

Vectorized numpy replication of the reference scans, including their
asymmetries (eval_kmer_features.cpp:67-126):
 - CpG: forward-strand 'CG' positions only
 - CHG: forward-strand CCG/CAG/CTG positions only (NO reverse-strand CHG at
   read level)
 - CHH: forward motif hits (C[ACT][ACT]) at i, plus reverse motif hits
   ([TGA][TGA]G) recorded at the G (i+2), in scan order
"""
from __future__ import annotations

import numpy as np

from ..constants import FWD, REV

_A, _C, _G, _T = (ord(c) for c in "ACGT")

_IS_H = np.zeros(256, dtype=bool)       # H = A/C/T
for _c in (_A, _C, _T):
    _IS_H[_c] = True
_IS_D = np.zeros(256, dtype=bool)       # D = A/G/T (complement of H)
for _c in (_A, _G, _T):
    _IS_D[_c] = True


def cpg_sites(seq: np.ndarray) -> np.ndarray:
    """Forward-strand CpG offsets (eval_kmer_features.cpp:89-102)."""
    if len(seq) < 2:
        return np.empty(0, np.int64)
    return np.flatnonzero((seq[:-1] == _C) & (seq[1:] == _G))


def chg_sites(seq: np.ndarray) -> np.ndarray:
    """Forward-strand CHG (CCG/CAG/CTG) offsets (eval_kmer_features.cpp:104-126)."""
    if len(seq) < 3:
        return np.empty(0, np.int64)
    return np.flatnonzero(
        (seq[:-2] == _C) & _IS_H[seq[1:-1]] & (seq[2:] == _G))


def chh_sites(seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """CHH offsets and strands, position-sorted (eval_kmer_features.cpp:67-87).

    Returns (offsets, strands): forward-motif hits (C[ACT][ACT]) contribute
    offset i with FWD; reverse-motif hits ([TGA][TGA]G) contribute offset
    i+2 with REV.  An offset cannot be both (fwd sites sit on 'C', rev
    sites on 'G').  The reference emits in scan order of i (fwd/rev
    interleaved, so offsets are NOT monotone); every consumer sorts calls
    by qoff before building MM/ML (mod_main.cpp:228-253), so position
    order is an equivalent contract - and pre-sorted per-read lists let
    the call engine concatenate flush-level site arrays already sorted,
    skipping the per-flush argsort on its hot path.
    """
    L = len(seq)
    if L < 3:
        z = np.empty(0, np.int64)
        return z, z.astype(np.uint8)
    fwd = (seq[:-2] == _C) & _IS_H[seq[1:-1]] & _IS_H[seq[2:]]
    rev = _IS_D[seq[:-2]] & _IS_D[seq[1:-1]] & (seq[2:] == _G)
    hit = np.zeros(L, dtype=bool)
    hit[:L - 2] = fwd
    hit[2:] |= rev
    offs = np.flatnonzero(hit)
    strands = np.where(seq[offs] == _G, REV, FWD).astype(np.uint8)
    return offs, strands


def scan_all(seq: np.ndarray):
    """All three context scans in one pass: returns
    {"CpG": (offs, strands), "CHG": (offs, strands), "CHH": (offs, strands)}.

    Uses the native single-pass scanner (bamcore hm_scan_sites) when built -
    ~10x the three vectorized numpy scans, which re-read the sequence and
    materialize boolean temporaries per context - with a bit-identical numpy
    fallback."""
    from ..io import native
    r = native.scan_sites(seq)
    if r is not None:
        cpg, chg, chh, chs = r
        z = np.zeros
        return {"CpG": (cpg.astype(np.int64), z(len(cpg), np.uint8)),
                "CHG": (chg.astype(np.int64), z(len(chg), np.uint8)),
                "CHH": (chh.astype(np.int64), chs)}
    cpg = cpg_sites(seq)
    chg = chg_sites(seq)
    chh, chs = chh_sites(seq)
    return {"CpG": (cpg, np.zeros(len(cpg), np.uint8)),
            "CHG": (chg, np.zeros(len(chg), np.uint8)),
            "CHH": (chh, chs)}


def site_strands_for_c_or_g(seq: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """Strand by modified-base identity ('C' -> FWD, anything else -> REV;
    eval_kmer_features.cpp:25-35)."""
    return np.where(seq[offs] == _C, FWD, REV).astype(np.uint8)
