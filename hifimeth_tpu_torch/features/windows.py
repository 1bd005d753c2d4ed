"""Device feature pipeline: packed read planes -> feature table -> per-site
windows -> CNN -> u8 probabilities.

Reads are packed host-side into a flat u8 buffer of 5 planes (2-bit codes,
fi, fp, ri, rp, all in native-forward coordinates, see
features/read_decode.py).  On the device:

 1. `featurize_planes_t` expands the buffer once into an (8, N) float32
    table (one-hot + codeV1-normalized kinetics), O(bases), shared by the
    ~100 overlapping windows that cover each base;
 2. `call_sites_group` cuts each group-planned site's window out of the
    table with the gather kernel (ops/gather.group_windows_t) and runs the
    per-context CNN on them.

codeV1 decodes through the 256-entry CODEV1_TO_FRAME_NORM table on every
device, so the table equals the host extractor's values bit for bit.
"""
from __future__ import annotations

import torch

from ..constants import CODEV1_TO_FRAME_NORM, KMER_SIZE
from ..model.cnn import DNAModNet, logits_to_scaled_probs
from ..ops.gather import REV_CHANNEL_PERM, group_windows_t  # noqa: F401

_CODEV1_NORM = torch.from_numpy(CODEV1_TO_FRAME_NORM)


def featurize_planes_t(planes: torch.Tensor) -> torch.Tensor:
    """(5, N) u8 packed planes -> (8, N) float32 channel-major table.

    Seq code c in 0..3 sets one-hot channel c; any other code (the packer's
    255 fill, IUPAC codes > 3) gives an all-zero one-hot."""
    out = torch.empty((8, planes.shape[1]), dtype=torch.float32,
                      device=planes.device)
    _featurize_into(planes, out)
    return out


def featurize_planes_t_seg(prefix: torch.Tensor, cap: int) -> torch.Tensor:
    """Featurize the filled (5, m) prefix of the plane buffer into an
    (8, cap) table whose tail [m, cap) is zero - what the packer's 255/0
    fill featurizes to - so the result equals featurize_planes_t over the
    whole (5, cap) buffer."""
    m = prefix.shape[1]
    if m > cap:
        raise ValueError(f"prefix of {m} lanes exceeds capacity {cap}")
    out = torch.zeros((8, cap), dtype=torch.float32, device=prefix.device)
    _featurize_into(prefix, out[:, :m])
    return out


def _featurize_into(planes: torch.Tensor, out: torch.Tensor) -> None:
    codes = planes[0]
    arange = torch.arange(4, dtype=codes.dtype, device=codes.device)
    out[:4] = codes[None, :] == arange[:, None]
    lut = _CODEV1_NORM.to(planes.device)
    out[4:] = lut[planes[1:5].to(torch.int64)]


def call_sites_group(model: DNAModNet, table: torch.Tensor,
                     bases: torch.Tensor, rels: torch.Tensor, rev: bool,
                     kmer: int = KMER_SIZE) -> torch.Tensor:
    """One batch of planned groups -> (ng*G,) u8 scaled probs in slot order.

    No per-site read-bounds mask: the engine packs reads with a >= kmer//2
    zero-feature gap, so window lanes past a read's edge read exact zeros
    from the table, the reference's window zero padding
    (eval_kmer_features.cpp:40)."""
    w = group_windows_t(table, bases, rels, rev=rev, kmer=kmer)
    return logits_to_scaled_probs(model(w))
