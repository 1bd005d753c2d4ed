"""Operations, bytes and peaks that the per-layer shares are measured
against.

- FLOPs per site: each net's multiply-adds counted twice, from its
  geometry in `models/<context>.npz`: a conv of Cin -> Cout channels,
  kernel K and Lo outputs does 2 * Cin * Cout * K * Lo, an FC of in -> out
  2 * in * out; bias, ReLU and the input BatchNorm are not counted.  The
  shipped nets: CpG and CHG 22,297,600, CHH 22,881,280.
- The window gather's least bytes: each site's window written once (KMER
  x 8 float32) and each base's row of the feature table read once (8
  float32).
- Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
  989 TFLOP/s bf16 on the tensor cores, the rate every FLOP share here is
  taken against, and 3.35 TB/s of HBM3.  TF32 495 and FP32 67 TFLOP/s are
  kept for readers' conversions (PERF.md).
"""
from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

KMER = 401
CHANNELS = 8
TABLE_BYTES = 4            # the feature table and windows are float32


def conv_out(length: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (length + lo + hi - k) // stride + 1


def net_flops(path: str, kmer: int = KMER) -> int:
    """FLOPs of one site's forward through the net stored at `path`."""
    with np.load(path) as z:
        f = {k: z[k] for k in z.files}
    flops = 0
    length = kmer
    i = 0
    while f"convs.{i}.w" in f:
        k, cin, cout = f[f"convs.{i}.w"].shape
        lo, hi = (int(v) for v in f[f"convs.{i}.pad"])
        length = conv_out(length, k, int(f[f"convs.{i}.stride"]), lo, hi)
        flops += 2 * cin * cout * k * length
        i += 1
    for fc in ("fc1", "fc2"):
        n_in, n_out = f[f"{fc}.w"].shape
        flops += 2 * n_in * n_out
    return int(flops)


def model_flops(sites: dict, flops_per_site: dict) -> float:
    """FLOPs of the sites called, {context: count}."""
    return float(sum(n * flops_per_site[c] for c, n in sites.items()))


def gather_bytes(n_sites: int, n_bases: int, kmer: int = KMER) -> float:
    """Least bytes the window gather moves for n_sites windows over a
    table of n_bases rows."""
    return float(n_sites * kmer * CHANNELS * TABLE_BYTES
                 + n_bases * CHANNELS * TABLE_BYTES)
