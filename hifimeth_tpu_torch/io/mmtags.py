"""SAM base-modification (MM/ML/MN) tag writer.

Replicates the reference's src/corelib/build_mod_bam.cpp:125-248:
 - strips kinetics tags (fi/ri/fp/rp) unless keep_kinetics, always strips any
   pre-existing MM/ML
 - MM:Z:C+m,<deltas>;G-m,<deltas>; where each delta counts *skipped*
   same-base positions on the native forward strand
 - ML:B:C with forward-call probs followed by reverse-call probs
 - MN:i:<l_seq> with htslib's smallest-int-type encoding
"""
from __future__ import annotations

import numpy as np

from .bam import BamRecord, choose_int_type

KINETICS_TAGS = ("fi", "ri", "fp", "rp")


def _delta_string(qoffs: np.ndarray, base_positions_cum: np.ndarray) -> str:
    """Build ',d0,d1,...' for calls at qoffs given cumsum of same-base mask.

    base_positions_cum[i] = number of same-base chars in fwd_seq[0:i].
    delta_0 = #base in [0, qoff_0); delta_i = #base in [prev_qoff+1, qoff_i).
    Since each qoff sits on the base itself this equals consecutive-rank
    differences minus one.
    """
    if len(qoffs) == 0:
        return ""
    ranks = base_positions_cum[qoffs]  # rank of each call among same-base chars
    deltas = np.empty(len(qoffs), dtype=np.int64)
    deltas[0] = ranks[0]
    deltas[1:] = np.diff(ranks) - 1
    # printf-style tuple formatting is ~4x faster than a join of str() calls
    return (",%d" * len(deltas)) % tuple(deltas.tolist())


def build_mod_tags(rec: BamRecord, fwd_seq: np.ndarray,
                   fwd_qoffs: np.ndarray, fwd_probs: np.ndarray,
                   rev_qoffs: np.ndarray, rev_probs: np.ndarray,
                   keep_kinetics: bool = False) -> None:
    """Attach MM/ML/MN to a record (reference: build_mod_bam.cpp:125-248).

    fwd_seq is the read's native-forward ASCII sequence; fwd_qoffs must sit on
    'C' and rev_qoffs on 'G' (native-forward coordinates), both sorted
    ascending.  Probabilities are u8 scaled probs.
    """
    if not keep_kinetics:
        for t in KINETICS_TAGS:
            rec.del_tag(t)
    rec.del_tag("ML")
    rec.del_tag("MM")
    if len(fwd_qoffs) == 0 and len(rev_qoffs) == 0:
        return

    from . import native
    if native.available():
        # native single-pass delta builder (~10x the cumsum + printf path)
        fwd_d = native.mm_deltas(fwd_seq, ord("C"), fwd_qoffs).decode()
        rev_d = native.mm_deltas(fwd_seq, ord("G"), rev_qoffs).decode()
        mm = "C+m" + fwd_d + ";G-m" + rev_d + ";"
    else:
        cum_c = np.zeros(len(fwd_seq) + 1, dtype=np.int64)
        np.cumsum(fwd_seq == ord("C"), out=cum_c[1:])
        cum_g = np.zeros(len(fwd_seq) + 1, dtype=np.int64)
        np.cumsum(fwd_seq == ord("G"), out=cum_g[1:])
        mm = ("C+m" + _delta_string(np.asarray(fwd_qoffs, np.int64), cum_c) + ";"
              + "G-m" + _delta_string(np.asarray(rev_qoffs, np.int64), cum_g)
              + ";")
    ml = np.concatenate([
        np.asarray(fwd_probs, np.uint8), np.asarray(rev_probs, np.uint8)
    ])
    rec.set_tag("MM", "Z", mm)
    rec.set_tag("ML", "B", ("C", ml))
    rec.set_tag("MN", choose_int_type(rec.l_seq), rec.l_seq)
