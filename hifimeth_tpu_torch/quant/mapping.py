"""Alignment-exact motif-site mapping: read-local calls -> genome coordinates.

Vectorized replication of the reference's per-column scans:
 - CpG: pileup.cpp:292-304 / 5mc_motif_finder.cpp:146-167
 - CHG: pileup.cpp:306-335 (fwd CCG/CAG/CTG at the C; rev CGG/CAG/CTG with
   the *column-i* subject position -- note the CGG quirk documented in
   SURVEY.md section "Hard parts")
 - CHH: 5mc_motif_finder.cpp:104-144 (fwd motif pairs at the C, rev motif
   pairs at the G = column i+2, requiring equal motif identity between query
   and subject)

All require exact query==subject motif match over gap-free alignment columns
(gap chars never equal bases, so gapped columns drop out naturally).
"""
from __future__ import annotations

import numpy as np

from .alignment import ExpandedAlignment

_A, _C, _G, _T = (ord(c) for c in "ACGT")
_IS_H = np.zeros(256, dtype=bool)
for _c in (_A, _C, _T):
    _IS_H[_c] = True
_IS_D = np.zeros(256, dtype=bool)
for _c in (_A, _G, _T):
    _IS_D[_c] = True


def _q_fwd_off(aln: ExpandedAlignment, cols: np.ndarray, shift: int) -> np.ndarray:
    """Aligned-orientation query offset (+shift) -> native-forward offset."""
    qp = aln.qpos[cols] + shift
    if aln.qdir == 0:
        return qp
    return aln.qsize - 1 - qp


def map_cpg_sites(aln: ExpandedAlignment) -> tuple[np.ndarray, np.ndarray]:
    """(native-fwd qoffs, genome soffs) of alignment-exact CpG columns."""
    qas, sas = aln.qas, aln.sas
    if len(qas) < 2:
        z = np.empty(0, np.int64)
        return z, z
    m = (qas[:-1] == _C) & (qas[1:] == _G) & (sas[:-1] == _C) & (sas[1:] == _G)
    cols = np.flatnonzero(m)
    if aln.qdir == 0:
        qoffs = aln.qpos[cols]
    else:
        qoffs = aln.qsize - 1 - (aln.qpos[cols] + 1)
    return qoffs, aln.spos[cols]


def _match3(qas, sas, b0, b1, b2) -> np.ndarray:
    return ((qas[:-2] == b0) & (qas[1:-1] == b1) & (qas[2:] == b2) &
            (sas[:-2] == b0) & (sas[1:-1] == b1) & (sas[2:] == b2))


def map_chg_sites(aln: ExpandedAlignment) -> tuple[np.ndarray, np.ndarray]:
    """(native-fwd qoffs, genome soffs) for CHG (pileup.cpp:306-335).

    Forward alignments match CCG/CAG/CTG with the call at the C (column i);
    reverse alignments match CGG/CAG/CTG with the native-forward call at
    qsize-1-(qpos+2) but the genome position still at column i (even for the
    CGG dyad - a deliberate reference quirk we preserve)."""
    qas, sas = aln.qas, aln.sas
    if len(qas) < 3:
        z = np.empty(0, np.int64)
        return z, z
    if aln.qdir == 0:
        m = (_match3(qas, sas, _C, _C, _G) | _match3(qas, sas, _C, _A, _G) |
             _match3(qas, sas, _C, _T, _G))
        cols = np.flatnonzero(m)
        qoffs = aln.qpos[cols]
    else:
        m = (_match3(qas, sas, _C, _G, _G) | _match3(qas, sas, _C, _A, _G) |
             _match3(qas, sas, _C, _T, _G))
        cols = np.flatnonzero(m)
        qoffs = aln.qsize - 1 - (aln.qpos[cols] + 2)
    return qoffs, aln.spos[cols]


def map_chh_sites(aln: ExpandedAlignment) -> tuple[np.ndarray, np.ndarray]:
    """(native-fwd qoffs, genome soffs) for CHH, fwd pass then rev pass in
    reference emission order (5mc_motif_finder.cpp:104-144)."""
    qas, sas = aln.qas, aln.sas
    if len(qas) < 3:
        z = np.empty(0, np.int64)
        return z, z
    # fwd motif C[ACT][ACT]: query 3-mer == subject 3-mer, both in motif set
    eq3 = (qas[:-2] == sas[:-2]) & (qas[1:-1] == sas[1:-1]) & (qas[2:] == sas[2:])
    fwd = eq3 & (qas[:-2] == _C) & _IS_H[qas[1:-1]] & _IS_H[qas[2:]]
    rev = eq3 & _IS_D[qas[:-2]] & _IS_D[qas[1:-1]] & (qas[2:] == _G)
    fcols = np.flatnonzero(fwd)
    rcols = np.flatnonzero(rev)
    if aln.qdir == 0:
        fq = aln.qpos[fcols]
        rq = aln.qpos[rcols] + 2
    else:
        fq = aln.qsize - 1 - aln.qpos[fcols]
        rq = aln.qsize - 1 - (aln.qpos[rcols] + 2)
    qoffs = np.concatenate([fq, rq])
    soffs = np.concatenate([aln.spos[fcols], aln.spos[rcols] + 2])
    return qoffs, soffs
