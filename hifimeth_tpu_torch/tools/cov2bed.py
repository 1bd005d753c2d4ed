"""`cov2bed`: convert 1-based Bismark .cov files to the 0-based 7-column BED
convention, with the reference's per-context strand aggregation rules
(cov_to_bed.cpp):

 - CpG: fwd C kept at the C; rev-strand G counts aggregated (+=) into the
   fwd C at soff-1 (cov_to_bed.cpp:111-130)
 - CHG: fwd C[ACT]G kept at the C; rev CAG/CTG aggregated to the fwd C at
   soff-2; rev CCG (genome CGG) kept at its own G position -- a deliberate
   reference quirk (cov_to_bed.cpp:229-285)
 - CHH: fwd sites at the C, rev sites at their own G, motif name from the
   forward motif table (cov_to_bed.cpp:373-391)

Output columns: chr start end freq% pcov ncov motif.
"""
from __future__ import annotations

import sys

import numpy as np

from ..constants import (FWD_CHH_MOTIFS, FWD_CHH_IDX, REV_CHH_IDX,
                         IUPACNA_TO_CODE)
from ..io.fasta import FastaDatabase
from ..utils.logging import log

_C, _G = ord("C"), ord("G")


def _motif_hash_at(seq: np.ndarray, off: int) -> int:
    h = 0
    for k in range(3):
        c = int(IUPACNA_TO_CODE[seq[off + k]])
        if c > 3:
            return 64
        h = (h << 2) | c
    return h


class _ChrAccum:
    def __init__(self, size: int):
        self.pcov = np.zeros(size, np.int64)
        self.ncov = np.zeros(size, np.int64)
        self.motif = [None] * size

    def set(self, off: int, pcov: int, ncov: int, motif: str):
        self.pcov[off] = pcov
        self.ncov[off] = ncov
        self.motif[off] = motif

    def add(self, off: int, pcov: int, ncov: int, motif: str,
            keep_existing_motif: bool = False):
        self.pcov[off] += pcov
        self.ncov[off] += ncov
        if not (keep_existing_motif and self.motif[off]):
            self.motif[off] = motif


def _zero_cov_error(name: str, pos: int) -> ValueError:
    """A Bismark row with pcov=ncov=0 at a motif position: the reference
    hard-aborts on this (hbn_assert(cov > 0), cov_to_bed.cpp:27) because
    real Bismark .cov files only list covered positions.  Pin the behavior
    as a clean error instead of an accidental nan row."""
    return ValueError(
        f"cov2bed: zero total coverage at {name}:{pos} (0-based, "
        f"strand-AGGREGATED output position; the offending 1-based .cov "
        f"row may be at {pos + 1} or a reverse-strand mate 1-2 bp away). "
        f"The reference asserts cov > 0 (cov_to_bed.cpp:27); remove 0/0 "
        f"rows from the Bismark input")


def _dump_chr(out, name: str, acc: _ChrAccum) -> None:
    for i in np.flatnonzero(np.asarray([m is not None for m in acc.motif])):
        cov = int(acc.pcov[i] + acc.ncov[i])
        if cov <= 0:
            raise _zero_cov_error(name, int(i))
        freq = 100.0 * acc.pcov[i] / cov
        out.write(f"{name}\t{i}\t{i + 1}\t{freq:g}\t{int(acc.pcov[i])}"
                  f"\t{int(acc.ncov[i])}\t{acc.motif[i]}\n")


def _run_cov2bed_vec(db, ctx: str, names, chrid, soff, pcov, ncov, out):
    """Vectorized per-chromosome-run conversion (bit-identical rows to the
    sequential loop for position-sorted runs - the caller checks).  Returns
    (fwd_sites, rev_sites)."""
    from ..io import native

    _A, _T = ord("A"), ord("T")
    if ctx == "CPG":
        motif_names = ["CG"]
    elif ctx == "CHG":
        motif_names = ["CCG", "CAG", "CTG"]
    else:
        motif_names = list(FWD_CHH_MOTIFS)
    fs = rs = 0
    for run, nm in enumerate(names):
        sid = db.seq_name2id(nm)
        seq = db.seq_bases(sid)
        L = len(seq)
        m = chrid == run
        s, p, nv = soff[m], pcov[m], ncov[m]
        ok = (s >= 0) & (s < L)
        s, p, nv = s[ok], p[ok], nv[ok]
        c0 = seq[s]
        pc = np.zeros(L, np.int64)
        nc = np.zeros(L, np.int64)
        mid = np.zeros(L, np.uint8)          # 0 = no site, else motif id + 1

        def at(off):
            return seq[np.clip(s + off, 0, L - 1)]

        if ctx == "CPG":
            fwd = (c0 == _C) & (s + 1 < L) & (at(1) == _G)
            rev = (c0 == _G) & (s - 1 >= 0) & (at(-1) == _C)
            t = s[fwd]
            pc[t], nc[t], mid[t] = p[fwd], nv[fwd], 1
            t = s[rev] - 1
            np.add.at(pc, t, p[rev])
            np.add.at(nc, t, nv[rev])
            mid[t] = 1
        elif ctx == "CHG":
            c1, c2 = at(1), at(2)
            b1, b2 = at(-1), at(-2)
            fwd = ((c0 == _C) & (s + 2 < L) & (c2 == _G)
                   & ((c1 == _C) | (c1 == _A) | (c1 == _T)))
            revg = (c0 == _G) & (s - 2 >= 0) & (b2 == _C) & (b1 == _G)
            reva = ((c0 == _G) & (s - 2 >= 0) & (b2 == _C)
                    & ((b1 == _A) | (b1 == _T)))
            t = s[fwd]
            pc[t], nc[t] = p[fwd], nv[fwd]
            mid[t] = np.where(c1[fwd] == _C, 1,
                              np.where(c1[fwd] == _A, 2, 3)).astype(np.uint8)
            t = s[revg]                       # genome CGG kept at its own G
            pc[t], nc[t], mid[t] = p[revg], nv[revg], 1
            t = s[reva] - 2                   # rev CAG/CTG aggregated to fwd C
            np.add.at(pc, t, p[reva])
            np.add.at(nc, t, nv[reva])
            fill = mid[t] == 0                # keep_existing_motif=True
            mid[t[fill]] = np.where(b1[reva][fill] == _A, 2,
                                    3).astype(np.uint8)
            rev = revg | reva
        else:  # CHH
            codes = IUPACNA_TO_CODE[seq].astype(np.int16)

            def hsh(off):
                a = codes[np.clip(s + off, 0, L - 1)]
                b = codes[np.clip(s + off + 1, 0, L - 1)]
                c = codes[np.clip(s + off + 2, 0, L - 1)]
                valid = (a <= 3) & (b <= 3) & (c <= 3)
                return np.where(valid, (a << 4) | (b << 2) | c, 64)

            hf = hsh(0)
            fidx = np.asarray(FWD_CHH_IDX)[np.minimum(hf, 63)]
            fwd = (c0 == _C) & (s + 2 < L) & (hf < 64) & (fidx != 255)
            hr = hsh(-2)
            ridx = np.asarray(REV_CHH_IDX)[np.minimum(hr, 63)]
            rev = ((c0 != _C) & (c0 == _G) & (s - 2 >= 0) & (hr < 64)
                   & (ridx != 255))
            t = s[fwd]
            pc[t], nc[t] = p[fwd], nv[fwd]
            mid[t] = (fidx[fwd] + 1).astype(np.uint8)
            t = s[rev]
            pc[t], nc[t] = p[rev], nv[rev]
            mid[t] = (ridx[rev] + 1).astype(np.uint8)
        fs += int(fwd.sum())
        rs += int(rev.sum())
        rows = np.flatnonzero(mid)
        zero = rows[(pc[rows] + nc[rows]) <= 0]
        if len(zero):
            raise _zero_cov_error(db.seq_name(sid), int(zero[0]))
        for lo in range(0, len(rows), 1 << 20):
            sel = rows[lo:lo + (1 << 20)]
            out.write(native.bed_rows7(
                db.seq_name(sid), sel, pc[sel], pc[sel] + nc[sel],
                mid[sel] - 1, motif_names).decode())
    return fs, rs


def run_cov2bed(reference_path: str, context: str, bismark_path: str,
                bed_path: str) -> None:
    ctx = context.upper()
    if ctx not in ("CPG", "CHG", "CHH"):
        print(f"Illegal 5mc context: {context}\n"
              "Plausible contexts: CpG, CHG, CHH", file=sys.stderr)
        raise SystemExit(1)
    db = FastaDatabase(reference_path)
    out = open(bed_path, "w")
    # everything below may raise (zero-coverage rows, corrupted
    # records); the finally keeps the output handle from leaking
    # (close() is idempotent, so the early-return closes stay)
    try:
        from ..io import native
        raw_data: bytes | None = None
        if native.available():
            from ..utils.lines import read_bytes
            raw_data = read_bytes(bismark_path)
            names, chrid, start, end, pcov, ncov = native.scan_bed6(
                raw_data, skip_short=False)
            if np.any(end != start):
                i = int(np.flatnonzero(end != start)[0])
                out.close()
                raise ValueError(
                    f"bismark cov must have end==start: "
                    f"{names[chrid[i]]}:{start[i]}-{end[i]}")
            # the vectorized path assumes position-sorted runs (standard
            # Bismark output); anything else falls back to the row loop
            soff = start - 1
            sorted_runs = all(
                np.all(np.diff(soff[chrid == r]) >= 0) for r in range(len(names)))
            if sorted_runs:
                fs, rs = _run_cov2bed_vec(db, ctx, names, chrid, soff,
                                          pcov, ncov, out)
                out.close()
                log("forward-strand-sites: %d, reverse-strand-sites: %d", fs, rs)
                return
        acc: _ChrAccum | None = None
        last_sid = -1
        fs = rs = 0
        import contextlib
        if raw_data is not None:
            # the native path already consumed the source (possibly stdin);
            # iterate the bytes we hold instead of reopening the path
            f_ctx = contextlib.nullcontext(
                line + "\n" for line in raw_data.decode().splitlines())
        else:
            from ..utils.lines import open_text
            f_ctx = open_text(bismark_path)
        with f_ctx as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 6:
                    raise ValueError(f"corrupted bismark record {line!r}")
                sid = db.seq_name2id(cols[0])
                if sid != last_sid:
                    if last_sid != -1:
                        _dump_chr(out, db.seq_name(last_sid), acc)
                    last_sid = sid
                    acc = _ChrAccum(db.seq_length(sid))
                soff = int(cols[1])
                send = int(cols[2])
                if send != soff:
                    raise ValueError(f"bismark cov must have end==start: {line!r}")
                pcov = int(cols[4])
                ncov = int(cols[5])
                soff -= 1
                seq = db.seq_bases(sid)
                L = len(seq)
                c0 = seq[soff]

                if ctx == "CPG":
                    if c0 == _C and soff + 1 < L and seq[soff + 1] == _G:
                        acc.set(soff, pcov, ncov, "CG")
                        fs += 1
                    if c0 == _G and soff - 1 >= 0 and seq[soff - 1] == _C:
                        acc.add(soff - 1, pcov, ncov, "CG")
                        rs += 1
                elif ctx == "CHG":
                    if c0 == _C and soff + 2 < L:
                        c1, c2 = seq[soff + 1], seq[soff + 2]
                        if c2 == _G and c1 in (ord("C"), ord("A"), ord("T")):
                            acc.set(soff, pcov, ncov, "C" + chr(c1) + "G")
                            fs += 1
                    if c0 == _G and soff - 2 >= 0:
                        c1, c2 = seq[soff - 1], seq[soff - 2]
                        if c2 == _C and c1 == _G:
                            # genome CGG: kept at the G's own position
                            acc.set(soff, pcov, ncov, "CCG")
                            rs += 1
                        elif c2 == _C and c1 in (ord("A"), ord("T")):
                            acc.add(soff - 2, pcov, ncov, "C" + chr(c1) + "G",
                                    keep_existing_motif=True)
                            rs += 1
                else:  # CHH
                    if c0 == _C and soff + 2 < L:
                        h = _motif_hash_at(seq, soff)
                        if h < 64 and FWD_CHH_IDX[h] != 255:
                            acc.set(soff, pcov, ncov,
                                    FWD_CHH_MOTIFS[FWD_CHH_IDX[h]])
                            fs += 1
                    elif c0 == _G and soff - 2 >= 0:
                        h = _motif_hash_at(seq, soff - 2)
                        if h < 64 and REV_CHH_IDX[h] != 255:
                            acc.set(soff, pcov, ncov,
                                    FWD_CHH_MOTIFS[REV_CHH_IDX[h]])
                            rs += 1
        if acc is not None and last_sid != -1:
            _dump_chr(out, db.seq_name(last_sid), acc)
        out.close()
        log("forward-strand-sites: %d, reverse-strand-sites: %d", fs, rs)
    finally:
        out.close()
