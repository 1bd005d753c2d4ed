"""What decides `correct`: the records the timed run wrote, held to the
plain reference (reference/hifimeth.py) over the same pool.

Output record k must be pool read k % n, in order, with the reference's
MM tag byte for byte (which sites, strands and positions: the site scan
and MM emission), and each ML byte inside the reference's u8 bin (the
windows, the CNN, the u8 conversion).  Three numbers are compared, each
against its limit:

- ``missing``: records served that did not come back, or came back out
  of order (limit 0);
- ``site_mismatch``: records whose MM tag, or whose count of ML bytes,
  differs from the reference's (limit 0);
- ``ml_gap_u8``: the widest distance, in u8 units, from the reference's
  float64 probability 255 * p1 to the bin [v, v + 1) of the ML byte v the
  program wrote (limit: the configuration file's ``check``; how it was
  set is in PERF.md).

Nothing here imports the program.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


#: bytes of one value of each BAM tag type
_TAG_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
             ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def bgzf_payload(data: bytes) -> bytes:
    """The uncompressed bytes of a whole BGZF file."""
    out = []
    o = 0
    while o < len(data):
        if data[o:o + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF block at byte {o}")
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        bsize = None
        sub = o + 12
        while sub < o + 12 + xlen:
            slen = struct.unpack_from("<H", data, sub + 2)[0]
            if data[sub:sub + 2] == b"BC":
                bsize = struct.unpack_from("<H", data, sub + 4)[0] + 1
            sub += 4 + slen
        if bsize is None:
            raise ValueError(f"BGZF block at byte {o} has no BC field")
        out.append(zlib.decompress(data[o + 12 + xlen:o + bsize - 8], -15))
        o += bsize
    return b"".join(out)


def read_records(path: str):
    """(qname, MM string or None, ML bytes or None) of every record of a
    BAM file, in order."""
    with open(path, "rb") as f:
        raw = bgzf_payload(f.read())
    mv = memoryview(raw)
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    o = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, o)[0]
    o += 4
    for _ in range(n_ref):
        o += 4 + struct.unpack_from("<i", raw, o)[0] + 4
    out = []
    while o < len(raw):
        size = struct.unpack_from("<I", raw, o)[0]
        end = o + 4 + size
        l_name = raw[o + 12]
        n_cigar = struct.unpack_from("<H", raw, o + 16)[0]
        l_seq = struct.unpack_from("<i", raw, o + 20)[0]
        name = bytes(mv[o + 36:o + 36 + l_name - 1]).decode()
        t = o + 36 + l_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        mm = ml = None
        while t < end:
            tag, typ = bytes(mv[t:t + 2]), raw[t + 2]
            t += 3
            if typ == ord("Z") or typ == ord("H"):
                z = raw.index(b"\x00", t)
                if tag == b"MM":
                    mm = bytes(mv[t:z]).decode()
                t = z + 1
            elif typ == ord("B"):
                sub = raw[t]
                count = struct.unpack_from("<I", raw, t + 1)[0]
                t += 5
                nbytes = count * _TAG_SIZE[sub]
                if tag == b"ML" and sub == ord("C"):
                    ml = np.frombuffer(mv[t:t + nbytes], np.uint8).copy()
                t += nbytes
            else:
                t += _TAG_SIZE[typ]
        out.append((name, mm, ml))
        o = end
    return out


def ml_gap(ml: np.ndarray, p1: np.ndarray) -> float:
    """The widest distance from 255 * p1 to the bin [v, v + 1) of each
    byte v (0 where the reference's probability lies in the bin)."""
    if not len(ml):
        return 0.0
    p = 255.0 * p1
    v = ml.astype(np.float64)
    return float(np.max(np.maximum(0.0, np.maximum(v - p, p - v - 1.0))))


def compare(records, served: int, names, expected, limits: dict) -> dict:
    """Hold the run's records to the reference.

    records: read_records of the output; served: records the input
    handed out; names(j): pool read j's name; expected[j]: call_pool's
    (MM, p1, ML) of pool read j; limits: {"ml_gap_u8": limit}.  Returns
    {"numbers": {name: (value, limit)}, "correct": bool, "failed": records
    missing or off}."""
    n = len(expected)
    missing = max(0, served - len(records)) + max(0, len(records) - served)
    mismatch = 0
    gap = 0.0
    failed = 0
    for k, (name, mm, ml) in enumerate(records[:served]):
        j = k % n
        if name != names(j):
            missing += 1
            failed += 1
            continue
        mm_ref, p1, _ = expected[j]
        got = 0 if ml is None else len(ml)
        if mm != mm_ref or got != len(p1):
            mismatch += 1
            failed += 1
            continue
        g = ml_gap(ml, p1) if got else 0.0
        if g > limits["ml_gap_u8"]:
            failed += 1
        gap = max(gap, g)
    failed += max(0, served - len(records))
    numbers = {"missing": (missing, 0), "site_mismatch": (mismatch, 0),
               "ml_gap_u8": (gap, limits["ml_gap_u8"])}
    correct = served > 0 and all(v <= lim for v, lim in numbers.values())
    return {"numbers": numbers, "correct": correct, "failed": failed}


def score_answers(expected, answers, limits: dict) -> dict:
    """The same comparison for answers given per pool read (the control:
    answers[j] is (MM, p1, ML) of another computation of read j)."""
    records = [(f"r{j}", mm, ml if mm is not None else None)
               for j, (mm, _, ml) in enumerate(answers)]
    return compare(records, len(records), lambda j: f"r{j}", expected,
                   limits)
