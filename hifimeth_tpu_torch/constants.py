"""Constants: base codes, codeV1 kinetics codec, contexts, CHH motifs.

Semantics replicated from the reference implementation (cited per item,
paths relative to its source tree):
- IUPAC->2bit base codes: src/corelib/hbn_aux.cpp:46-54
- codeV1 <-> frame tables:  src/corelib/bam_info.cpp:455-478,562-570
- contexts:                 src/corelib/5mc_context.cpp:3-10
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Strand constants (reference: hbn_aux.hpp:60-63)
FWD = 0
REV = 1

# ---------------------------------------------------------------------------
# Base coding.  A=0, C=1, G=2, T=3; every other byte (incl. 'N') maps to 15.
# Full 128-entry table mirrors IUPACNA_TO_BLASTNA (hbn_aux.cpp:46-54); we only
# rely on entries for A/C/G/T/a/c/g/t/N being {0,1,2,3,...,15}.
IUPACNA_TO_CODE = np.full(256, 15, dtype=np.uint8)
# Reference table rows for '@'..'_' (BLASTNA codes: A=0,C=1,G=2,T=3, ambiguity
# codes 4..13, N=14, everything else 15).
_ref_row = [15, 0, 10, 1, 11, 15, 15, 2, 12, 15, 15, 7, 15, 6, 14, 15,
            15, 15, 4, 9, 3, 15, 13, 8, 15, 5, 15, 15, 15, 15, 15, 15]
for _i, _v in enumerate(_ref_row):
    IUPACNA_TO_CODE[0x40 + _i] = _v        # '@'..'_' covers A-Z
    IUPACNA_TO_CODE[0x60 + _i] = _v        # '`'..DEL covers a-z
del _ref_row

BASE_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    BASE_COMPLEMENT[_a] = _b

# BAM 4-bit SEQ nibble -> ASCII (sam spec "=ACMGRSVTWYHKDBN").
BAM_NIBBLE_TO_BASE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8).copy()

# ---------------------------------------------------------------------------
# codeV1 kinetics codec (PacBio lossy frame encoding).
MAX_KINETIC_VALUE = 952


def _build_codev1_to_frame() -> np.ndarray:
    t = np.empty(256, dtype=np.int32)
    t[0:64] = np.arange(64)
    t[64:128] = (np.arange(64, 128) - 64) * 2 + 64
    t[128:192] = (np.arange(128, 192) - 128) * 4 + 192
    t[192:256] = (np.arange(192, 256) - 192) * 8 + 448
    return t


CODEV1_TO_FRAME = _build_codev1_to_frame()
# Normalized (frame/952) float32 variant used by the feature extractor
# (reference: eval_kmer_features.cpp:46-60, sample_dataset.py:49).
CODEV1_TO_FRAME_NORM = (CODEV1_TO_FRAME.astype(np.float32) / MAX_KINETIC_VALUE)


def encode_frames_codev1(frames: np.ndarray) -> np.ndarray:
    """Raw frame counts -> codeV1 bytes (reference: bam_info.cpp:455-478)."""
    s = np.minimum(frames.astype(np.int64), MAX_KINETIC_VALUE)
    out = np.empty(s.shape, dtype=np.uint8)
    lo = s < 64
    m1 = (s >= 64) & (s < 192)
    m2 = (s >= 192) & (s < 448)
    m3 = s >= 448
    out[lo] = s[lo]
    out[m1] = (s[m1] - 64) // 2 + 64
    out[m2] = (s[m2] - 192) // 4 + 128
    out[m3] = (s[m3] - 448) // 8 + 192
    return out


CONTEXTS = ("CpG", "CHG", "CHH")

# Model input geometry (reference: models/kmer.txt, sample_dataset.py:14-17).
KMER_SIZE = 401

# CHH motifs and their index tables (reference: 5mc_context.cpp:3-54), for
# cov2bed's motif column.
FWD_CHH_MOTIFS = ("CAA", "CCA", "CTA", "CAC", "CCC", "CTC", "CAT", "CCT", "CTT")
REV_CHH_MOTIFS = ("TTG", "TGG", "TAG", "GTG", "GGG", "GAG", "ATG", "AGG", "AAG")


def motif_hash(motif: str) -> int:
    """2-bit hash of an ACGT motif (reference: 5mc_context.hpp:118-126)."""
    h = 0
    for ch in motif:
        c = int(IUPACNA_TO_CODE[ord(ch)])
        if c > 3:
            raise ValueError(f"non-ACGT motif base {ch!r}")
        h = (h << 2) | c
    return h


def _motif_idx_table(motifs) -> np.ndarray:
    """motif hash -> index within the motif table (255 = invalid),
    matching MethylationContext::get_*_motif_idx (5mc_context.cpp:29-54)."""
    t = np.full(64, 255, dtype=np.uint8)
    for i, m in enumerate(motifs):
        t[motif_hash(m)] = i
    return t


FWD_CHH_IDX = _motif_idx_table(FWD_CHH_MOTIFS)
REV_CHH_IDX = _motif_idx_table(REV_CHH_MOTIFS)
