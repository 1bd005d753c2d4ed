"""Adaptive scaled-probability threshold from a 256-bin histogram.

Verbatim replication of s_resolve_scaled_prob_threshold
(pileup.cpp:355-436 == eval.cpp:228-305): trim edge bins with < 10 counts
starting from [20, 236); if the surviving span is >= 50 bins and holds
>= 10000 samples, the threshold is the argmin bin (the valley of the bimodal
distribution; ties keep the lowest bin), else 128.
"""
from __future__ import annotations

import sys

import numpy as np


def resolve_threshold(bins: np.ndarray, ctx_name: str = "",
                      verbose: bool = True) -> int:
    a = np.asarray(bins, dtype=np.int64)
    assert a.shape == (256,)
    st, en = 20, 256 - 20
    while st < 256 and a[st] < 10:
        st += 1
    while en and a[en - 1] < 10:
        en -= 1
    total = 0
    min_i = -1
    if en - st >= 50:
        window = a[st:en]
        total = int(window.sum())
        min_i = st + int(np.argmin(window))
    if verbose:
        print(f"{ctx_name} samples: {total}", file=sys.stderr)
    if total < 10000 or min_i == -1:
        if verbose:
            print("Not enough samples for inferring scaled probability "
                  "threshold, set it to 128", file=sys.stderr)
        return 128
    if verbose:
        print(f"{ctx_name} scaled probability threshold: {min_i}", file=sys.stderr)
    return min_i
