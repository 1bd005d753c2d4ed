"""`corr`: Pearson correlation between two 6-column methylation BEDs.

Replicates pileup_correlation.cpp: loci keyed (chr, start) with
pcov+ncov >= min_cov (default 5), sorted-merge intersection, Pearson r over
freq = pcov/(pcov+ncov); requires >= 5 common loci.
"""
from __future__ import annotations

import sys

import numpy as np

from ..utils.logging import log


def load_bed_methy(path: str, min_cov: int, chr_name2id: dict[str, int]):
    from ..io import native
    from ..utils.lines import read_bytes
    if native.available():
        # native buffer scan + vectorized filter (~20x the per-line loop;
        # short rows skipped like pileup_correlation.cpp:98-104)
        r = native.scan_bed6(read_bytes(path), skip_short=True)
        names, chrid, start, _, pcov, ncov = r
        sids = np.array([chr_name2id.setdefault(nm, len(chr_name2id))
                         for nm in names], np.uint64)
        cov = pcov + ncov
        keep = cov >= min_cov
        keys = ((sids[chrid[keep]] << np.uint64(32))
                | start[keep].astype(np.uint64))
        freqs = pcov[keep] / cov[keep]
        return keys, freqs.astype(np.float64)
    keys, freqs = [], []
    last_chr = None
    last_sid = -1
    from ..utils.lines import open_text
    with open_text(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 6:
                continue
            pcov = int(cols[4])
            ncov = int(cols[5])
            if pcov + ncov < min_cov:
                continue
            if cols[0] != last_chr:
                last_chr = cols[0]
                last_sid = chr_name2id.setdefault(last_chr, len(chr_name2id))
            keys.append((last_sid << 32) | int(cols[1]))
            freqs.append(pcov / (pcov + ncov))
    return np.asarray(keys, np.uint64), np.asarray(freqs, np.float64)


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    if len(x) < 2:
        raise ValueError("need >= 2 points")
    dx = x - x.mean()
    dy = y - y.mean()
    vx = float((dx * dx).sum())
    vy = float((dy * dy).sum())
    if vx == 0 or vy == 0:
        return 0.0
    return float((dx * dy).sum()) / np.sqrt(vx * vy)


def run_corr(bed1: str, bed2: str, min_cov: int = 5) -> float | None:
    chr_name2id: dict[str, int] = {}
    k1, f1 = load_bed_methy(bed1, min_cov, chr_name2id)
    k2, f2 = load_bed_methy(bed2, min_cov, chr_name2id)
    o1 = np.argsort(k1, kind="stable")
    o2 = np.argsort(k2, kind="stable")
    k1, f1 = k1[o1], f1[o1]
    k2, f2 = k2[o2], f2[o2]
    common, i1, i2 = np.intersect1d(k1, k2, return_indices=True)
    if len(common) < 5:
        log("Intersect genomic loci is less than 5. Skip computation")
        return None
    r = pearson(f1[i1], f2[i2])
    print(f"Intersect loci: {len(common)}")
    print(f"correlation: {r:g}", file=sys.stderr)
    return r
