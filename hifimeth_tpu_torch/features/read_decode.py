"""Decode a BAM record into native-forward per-base planes.

Replicates the semantics of BamQuerySequence (bam_info.cpp:169-222: restore
native orientation for flag-0x10 reads) and BamKinetics (bam_info.cpp:572-603:
fi/ri/fp/rp aux arrays; raw 'S' frame arrays are codeV1-encoded first,
bam_info.cpp:443-478).

The output planes are all in native-forward coordinates:
  seq   : ASCII bases of the native-forward read
  codes : 2-bit codes (A0 C1 G2 T3, others >3)
  fi/fp : forward-strand IPD/PW codeV1 bytes, index = fwd offset
  ri/rp : reverse-strand IPD/PW codeV1 bytes *re-indexed to fwd coords*
          (ri_fwd[i] == ri_rev[size-1-i]), so the device kernel needs a single
          coordinate system.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import BASE_COMPLEMENT, IUPACNA_TO_CODE, encode_frames_codev1
from ..io.bam import BamRecord


@dataclass
class DecodedRead:
    seq: np.ndarray          # (L,) u8 ASCII, native forward
    codes: np.ndarray        # (L,) u8 2-bit codes
    fi: np.ndarray           # (L,) u8 codeV1
    fp: np.ndarray
    ri: np.ndarray           # fwd-coord-indexed (reversed rev-strand array)
    rp: np.ndarray
    fn: int = -1
    rn: int = -1

    @property
    def size(self) -> int:
        return len(self.seq)


def native_fwd_seq(rec: BamRecord) -> np.ndarray:
    """ASCII native-forward sequence (reverse-complemented for flag 0x10)."""
    s = rec.seq_ascii()
    if rec.is_reverse:
        s = BASE_COMPLEMENT[s[::-1]]
    return s


def _kinetics_array(rec: BamRecord, tag: str, l_seq: int) -> np.ndarray | None:
    t = rec.get_tag(tag)
    if t is None or t[0] != "B":
        return None
    sub, arr = t[1]
    if len(arr) != l_seq:
        return None
    if sub == "C":
        return np.asarray(arr, np.uint8)
    if sub == "S":
        # raw frame counts -> codeV1 (bam_info.cpp:455-478,527)
        return encode_frames_codev1(np.asarray(arr))
    return None


def decode_read(rec: BamRecord) -> DecodedRead | None:
    """Full decode; returns None when any kinetics array is missing/invalid
    (such reads pass through uncalled, mod_main.cpp:193-196)."""
    l = rec.l_seq
    fi = _kinetics_array(rec, "fi", l)
    ri = _kinetics_array(rec, "ri", l)
    fp = _kinetics_array(rec, "fp", l)
    rp = _kinetics_array(rec, "rp", l)
    if fi is None or ri is None or fp is None or rp is None:
        return None
    seq = native_fwd_seq(rec)
    codes = IUPACNA_TO_CODE[seq]
    fn = rec.get_tag("fn")
    rn = rec.get_tag("rn")
    return DecodedRead(
        seq=seq, codes=codes, fi=fi, fp=fp,
        ri=ri[::-1].copy(), rp=rp[::-1].copy(),
        fn=int(fn[1]) if fn else -1, rn=int(rn[1]) if rn else -1,
    )
