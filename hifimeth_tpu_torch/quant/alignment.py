"""CIGAR -> column-expanded alignment, vectorized.

Replicates cigar_to_alignment / BamMapInfo (bam_info.cpp:262-439): per-column
query/subject characters (GAP '-' for I/D/N) and absolute position arrays,
plus identity%% and "effective" identity%% (gap runs >= 8 ignored).

The query string is in *aligned* orientation (the stored SEQ), and subject
positions are absolute genome coordinates (bam_info.cpp:383-393).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import BamRecord
from ..io.fasta import FastaDatabase

GAP = ord("-")

_M, _I, _D, _N, _S, _H, _P, _EQ, _X = range(9)
_CONSUME_Q = np.array([1, 1, 0, 0, 0, 0, 0, 1, 1], np.int8)
_CONSUME_S = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], np.int8)
_EMIT = np.array([1, 1, 1, 1, 0, 0, 0, 1, 1], bool)


@dataclass
class ExpandedAlignment:
    qdir: int                 # 0 fwd, 1 rev (alignment orientation)
    qb: int
    qe: int                   # exclusive
    qsize: int
    sid: int
    sb: int
    se: int                   # exclusive, absolute genome coords
    mapq: int
    pi: float
    epi: float
    qas: np.ndarray           # (n_cols,) u8, aligned-orientation query chars
    sas: np.ndarray           # (n_cols,) u8, subject chars
    qpos: np.ndarray          # (n_cols,) i64 aligned-orientation query offsets
    spos: np.ndarray          # (n_cols,) i64 absolute subject offsets

    @property
    def n_cols(self) -> int:
        return len(self.qas)


def effective_identity(qas: np.ndarray, sas: np.ndarray, max_gap: int = 8) -> float:
    """Identity ignoring long (>= max_gap) gap runs (bam_info.cpp:25-98)."""
    n = len(qas)
    if n == 0:
        return 0.0
    qgap = qas == GAP
    sgap = sas == GAP
    anygap = qgap | sgap
    bothgap = qgap & sgap
    # run-length over gap stretches: a stretch is maximal run where one side
    # is gapped (both-gap columns inside a stretch are absorbed)
    eff_len = 0
    eff_mat = 0
    i = 0
    # vectorize the common all-match path
    if not anygap.any():
        eff_len = n
        eff_mat = int((qas == sas).sum())
        return 100.0 * eff_mat / eff_len if eff_len else 0.0
    while i < n:
        if not anygap[i]:
            j = i
            while j < n and not anygap[j]:
                j += 1
            eff_mat += int((qas[i:j] == sas[i:j]).sum())
            eff_len += j - i
            i = j
            continue
        if bothgap[i]:
            i += 1
            continue
        qside = qgap[i]
        j = i + 1
        while j < n:
            if bothgap[j]:
                j += 1
                continue
            if (qgap[j] if qside else sgap[j]):
                j += 1
                continue
            break
        if j - i < max_gap:
            for k in range(i, j):
                if bothgap[k]:
                    continue
                if qas[k] == sas[k]:
                    eff_mat += 1
                eff_len += 1
        i = j
    if eff_len == 0:
        return 0.0
    return 100.0 * eff_mat / eff_len


def expand_alignment(rec: BamRecord, db: FastaDatabase,
                     ref_name: str) -> ExpandedAlignment | None:
    """Expand one mapped record; None for unmapped (bam_info.cpp:373-377)."""
    if rec.is_unmapped:
        return None
    sid = db.seq_name2id(ref_name)
    chr_seq = db.seq_bases(sid)
    query = rec.seq_ascii()       # aligned orientation
    qsize = rec.l_seq

    ops, lens = rec.cigar_ops()
    qb = 0
    start_op = 0
    if len(ops) and ops[0] == _S:
        qb = int(lens[0])
        start_op = 1
    elif len(ops) and ops[0] == _H:
        start_op = 1
    ops = ops[start_op:]
    lens = lens[start_op:]

    emit = _EMIT[ops]
    ops_e = ops[emit]
    lens_e = lens[emit]
    col_ops = np.repeat(ops_e, lens_e)
    q_step = _CONSUME_Q[col_ops].astype(np.int64)
    s_step = _CONSUME_S[col_ops].astype(np.int64)
    qpos = (qb - 1) + np.cumsum(q_step)
    spos_local = -1 + np.cumsum(s_step)

    qmask = q_step.astype(bool)
    smask = s_step.astype(bool)
    qas = np.full(len(col_ops), GAP, np.uint8)
    sas = np.full(len(col_ops), GAP, np.uint8)
    qas[qmask] = query[qpos[qmask]]
    spos = spos_local + rec.pos
    sub = chr_seq[rec.pos:rec.pos + (int(spos_local[-1]) + 1 if len(spos_local) else 0)]
    sas[smask] = sub[spos_local[smask]]

    pi = 100.0 * float((qas == sas).sum()) / len(qas) if len(qas) else 0.0
    epi = effective_identity(qas, sas)

    qe = int(qpos[-1]) + 1 if len(qpos) else qb
    se = int(spos[-1]) + 1 if len(spos) else rec.pos
    return ExpandedAlignment(
        qdir=1 if rec.is_reverse else 0,
        qb=qb, qe=qe, qsize=qsize,
        sid=sid, sb=rec.pos, se=se,
        mapq=rec.mapq, pi=pi, epi=epi,
        qas=qas, sas=sas, qpos=qpos, spos=spos,
    )
