"""Per-site feature windows built on the host (numpy): the golden extractor.

The device paths (features/windows.py, the gather kernels) are held against
this one; it is a copy of the JAX package's features/extract.py, so the port's
tests have an oracle that shares no code with the code under test.

Per-base features for a site, replicating s_extract_kmer_features
(eval_kmer_features.cpp:9-65) and assemble_one_sample_features
(sample_dataset.py:84-139):
  [ one_hot(base) x4,
    ipd_same_strand, pw_same_strand,       (codeV1-decoded / 952)
    ipd_opposite_strand, pw_opposite_strand ]
with the window centered on the site, zero-padded at read edges; for
reverse-strand sites the window is built on the reverse-complement read with
fwd/rev kinetics swapped.
"""
from __future__ import annotations

import numpy as np

from ..constants import CODEV1_TO_FRAME_NORM, FEATURES_PER_BASE, FWD, KMER_SIZE
from .read_decode import DecodedRead


def extract_site_features(read: DecodedRead, offs: np.ndarray,
                          strands: np.ndarray,
                          kmer_size: int = KMER_SIZE) -> np.ndarray:
    """Build (n_sites, kmer, 8) float32 features for sites on one read.

    offs are native-forward offsets; strands FWD/REV per site.
    """
    n = len(offs)
    hk = kmer_size // 2
    L = read.size
    out = np.zeros((n, kmer_size, FEATURES_PER_BASE), dtype=np.float32)
    if n == 0:
        return out

    offs = np.asarray(offs, np.int64)
    strands = np.asarray(strands)
    dirs = np.where(strands == FWD, 1, -1).astype(np.int64)

    # window positions in native-forward coordinates: for FWD sites the
    # window ascends (off-hk .. off+hk); for REV sites it descends, which
    # equals ascending positions on the reverse-complement strand.
    j = np.arange(kmer_size, dtype=np.int64)
    pos = offs[:, None] + dirs[:, None] * (j[None, :] - hk)
    valid = (pos >= 0) & (pos < L)
    p = np.clip(pos, 0, L - 1)

    codes = read.codes[p]                     # (n, k)
    is_rev = (strands != FWD)[:, None]
    # complement 2-bit codes on the reverse strand; codes > 3 stay invalid
    codes = np.where(is_rev & (codes < 4), 3 - codes, codes)

    onehot = (codes[..., None] == np.arange(4, dtype=codes.dtype)).astype(np.float32)

    fi = CODEV1_TO_FRAME_NORM[read.fi[p]]
    fp = CODEV1_TO_FRAME_NORM[read.fp[p]]
    ri = CODEV1_TO_FRAME_NORM[read.ri[p]]
    rp = CODEV1_TO_FRAME_NORM[read.rp[p]]

    same_ipd = np.where(is_rev, ri, fi)
    same_pw = np.where(is_rev, rp, fp)
    opp_ipd = np.where(is_rev, fi, ri)
    opp_pw = np.where(is_rev, fp, rp)

    out[..., 0:4] = onehot
    out[..., 4] = same_ipd
    out[..., 5] = same_pw
    out[..., 6] = opp_ipd
    out[..., 7] = opp_pw
    out *= valid[..., None].astype(np.float32)
    return out
