"""SAM base-modification (MM/ML/MN) tag writer and tolerant parser.

The writer replicates the reference's src/corelib/build_mod_bam.cpp:125-248:
 - strips kinetics tags (fi/ri/fp/rp) unless keep_kinetics, always strips any
   pre-existing MM/ML
 - MM:Z:C+m,<deltas>;G-m,<deltas>; where each delta counts *skipped*
   same-base positions on the native forward strand
 - ML:B:C with forward-call probs followed by reverse-call probs
 - MN:i:<l_seq> with htslib's smallest-int-type encoding

The parser replicates src/corelib/bam_mod_parser.cpp: tolerant of general
SAM basemod syntax (ChEBI codes, '.'/'?' flags, multi-code series),
validating base/code combinations, and converting skip-deltas back to
native-forward offsets.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..constants import FWD, REV
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


def strip_mod_tags(rec: BamRecord, keep_kinetics: bool = False) -> None:
    """Drop the kinetics tags (unless keep_kinetics) and any MM/ML from a
    record about to be called (build_mod_bam.cpp:125-143)."""
    if not keep_kinetics:
        for t in KINETICS_TAGS:
            rec.del_tag(t)
    rec.del_tag("ML")
    rec.del_tag("MM")


def set_mod_tags(rec: BamRecord, mm: str, ml: np.ndarray) -> None:
    """Set MM, ML and MN, in that order, on a record strip_mod_tags has
    stripped; `ml` holds the u8 probabilities."""
    rec.set_tag("MM", "Z", mm)
    rec.set_tag("ML", "B", ("C", ml))
    rec.set_tag("MN", choose_int_type(rec.l_seq), rec.l_seq)


def build_mod_tags(rec: BamRecord, fwd_seq: np.ndarray,
                   fwd_qoffs: np.ndarray, fwd_probs: np.ndarray,
                   rev_qoffs: np.ndarray, rev_probs: np.ndarray,
                   keep_kinetics: bool = False) -> None:
    """Attach MM/ML/MN to a record (reference: build_mod_bam.cpp:125-248).

    fwd_seq is the read's native-forward ASCII sequence; fwd_qoffs must sit on
    'C' and rev_qoffs on 'G' (native-forward coordinates), both sorted
    ascending.  Probabilities are u8 scaled probs.
    """
    strip_mod_tags(rec, keep_kinetics)
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
    set_mod_tags(rec, mm, np.concatenate([
        np.asarray(fwd_probs, np.uint8), np.asarray(rev_probs, np.uint8)
    ]))


_DELTA_BODY_RE = re.compile(r"\d+(?:,\d+)*")

_CHEBI_TO_CODE = {
    27551: "m", 76792: "h", 76794: "f", 76793: "c", 16964: "g",
    80961: "e", 17477: "b", 28871: "a", 44605: "o", 18107: "n",
}

# code -> allowed unmodified bases (bam_mod_parser.cpp:98-134)
_CODE_BASES = {c: {"C", "G"} for c in "mhfcC"}
_CODE_BASES.update({c: {"T", "A"} for c in "gebT"})
_CODE_BASES.update(U={"U"}, a={"A", "T"}, A={"A", "T"}, o={"G", "C"},
                   G={"G", "C"}, n={"N"}, N={"N"})


class ModTagError(ValueError):
    pass


@dataclass
class BaseModSeries:
    """One MM series: its unmodified base, observed strand, codes, and per
    delta the native-forward offset and one u8 probability per code."""
    unmod_base: str
    strand: int          # observed strand: FWD for '+', REV for '-'
    codes: str
    qoffs: np.ndarray    # native-forward offsets, one per delta
    probs: np.ndarray    # (n_deltas, n_codes) u8


def parse_mod_tags(rec: BamRecord, fwd_seq: np.ndarray) -> list[BaseModSeries]:
    """MM/ML -> one BaseModSeries per MM series, in MM order
    (bam_mod_parser.cpp:136-286).  [] when ML is missing or empty or MM is
    absent; raises ModTagError on malformed input."""
    ml = rec.get_tag("ML")
    if ml is None:
        return []
    probs = np.asarray(ml[1][1])
    if probs.size and (probs.min() < 0 or probs.max() > 255):
        raise ModTagError(
            f"read {rec.qname}: illegal scaled probability outside [0,255]")
    probs = probs.astype(np.uint8)
    mm = rec.get_tag("MM")
    if probs.size == 0 or mm is None:
        return []
    mms = mm[1]
    if not mms.endswith(";"):
        raise ModTagError(f"read {rec.qname}: MM tag must end with ';'")

    # each unmodified base's native-forward positions, found once
    base_pos: dict[str, np.ndarray] = {}

    def base_positions(b: str) -> np.ndarray:
        if b not in base_pos:
            base_pos[b] = np.flatnonzero(fwd_seq == ord(b))
        return base_pos[b]

    out: list[BaseModSeries] = []
    prob_idx = 0
    i = 0
    while i < len(mms):
        j = mms.index(";", i + 1)
        series = mms[i:j + 1]
        i = j + 1
        unmod_base, strand, codes, deltas = _parse_one_series(
            rec.qname, series)
        n = len(deltas)
        if n == 0:
            out.append(BaseModSeries(unmod_base, strand, codes,
                                     np.empty(0, np.int64),
                                     np.empty((0, len(codes)), np.uint8)))
            continue
        pos = base_positions(unmod_base)
        # skip-delta walk: rank_i = cumulative(deltas + 1) - 1
        ranks = np.cumsum(deltas + 1) - 1
        if len(pos) == 0 or ranks[-1] >= len(pos):
            raise ModTagError(
                f"read {rec.qname}: MM series {unmod_base}{'+-'[strand]}"
                f"{codes} walks past the end of the read")
        need = n * len(codes)
        if prob_idx + need > len(probs):
            raise ModTagError(
                f"read {rec.qname}: ML array shorter than MM calls")
        p = probs[prob_idx:prob_idx + need].reshape(n, len(codes))
        prob_idx += need
        out.append(BaseModSeries(unmod_base, strand, codes, pos[ranks], p))
    return out


def parse_mod_tags_flat(rec: BamRecord, fwd_seq: np.ndarray):
    """MM/ML -> flattened (qoffs, strands, codes, probs) over every series
    and code, in MM order: the reference's BaseModInfo stream
    (bam_mod_parser.hpp)."""
    qoffs, strands, codes, probs = [], [], [], []
    for s in parse_mod_tags(rec, fwd_seq):
        n = len(s.qoffs)
        for k, code in enumerate(s.codes):
            qoffs.append(s.qoffs)
            strands.append(np.full(n, s.strand, np.uint8))
            codes.append(np.full(n, ord(code), np.uint8))
            probs.append(s.probs[:, k])
    if not qoffs:
        z = np.empty(0, np.int64)
        return z, *(z.astype(np.uint8),) * 3
    return (np.concatenate(qoffs), np.concatenate(strands),
            np.concatenate(codes), np.concatenate(probs))


def _parse_one_series(qname: str, s: str):
    """One `B+codes,d0,d1,...;` series -> (base, strand, codes, deltas)."""
    if len(s) < 4 or not s.endswith(";"):
        raise ModTagError(f"read {qname}: corrupted MM edit series {s!r}")
    unmod_base = s[0]
    if unmod_base not in "CGTAUN":
        raise ModTagError(
            f"read {qname}: unrecognised unmodified base {unmod_base!r} in {s!r}")
    if s[1] not in "+-":
        raise ModTagError(f"read {qname}: unrecognised strand {s[1]!r} in {s!r}")
    strand = FWD if s[1] == "+" else REV

    codes = ""
    i = 2
    if s[i].isdigit():
        c = 0
        while i < len(s) and s[i].isdigit():
            c = c * 10 + int(s[i])
            i += 1
        if i >= len(s) or s[i] != ",":
            raise ModTagError(f"read {qname}: illegal ChEBI edit series {s!r}")
        if c not in _CHEBI_TO_CODE:
            raise ModTagError(f"read {qname}: unrecognised ChEBI code {c} in {s!r}")
        codes = _CHEBI_TO_CODE[c]
    else:
        while i < len(s) and s[i] not in ",;":
            if s[i] not in ".?":
                codes += s[i]
            i += 1

    for c in codes:
        if c in _CODE_BASES and unmod_base not in _CODE_BASES[c]:
            raise ModTagError(
                f"read {qname}: inconsistent unmod base {unmod_base!r} and "
                f"modification code {c!r} in {s!r}")

    body = s[i:-1]
    if body.startswith(",") or body.startswith(";"):
        body = body[1:]
    if not body:
        return unmod_base, strand, codes, np.empty(0, np.int64)
    from . import native
    try:
        deltas = native.parse_deltas(body.encode())
    except ValueError:
        raise ModTagError(f"read {qname}: illegal character in {s!r}") from None
    if deltas is not None:
        return unmod_base, strand, codes, deltas.astype(np.int64)
    if not _DELTA_BODY_RE.fullmatch(body):
        raise ModTagError(f"read {qname}: illegal character in {s!r}")
    return unmod_base, strand, codes, np.array(body.split(","), np.int64)
