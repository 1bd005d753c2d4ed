"""Per-site window gather of the call path: group planning, the CUDA kernel
wrapper and its plain PyTorch version.

The host sorts each context's sites by position and packs groups of GROUP
sites whose windows fit one span of BLOCK_LANES table lanes (`plan_groups`,
or the native planner in io/native.py).  `group_windows_t` then cuts every
site's (8, kmer) window out of the (8, N) feature table, flipped and
channel-permuted for the reverse strand, in the NCW layout the first
convolution takes.

On a CUDA tensor it launches the hand-written kernel in
ops/csrc/group_windows.cu (which replaces the Pallas kernel
hifimeth_tpu/ops/gather.py:group_windows_t; the source note there gives its
bound and design); on a CPU tensor it runs `group_windows_t_plain`, the same
function in PyTorch indexing.  There is no fallback between the two: a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

GROUP = 32
BLOCK_LANES = 2048
#: planner extent: the block room a window needs past its start lane.  The
#: JAX package's 128-lane aligned chunk (640 lanes) plus 127 lanes of
#: alignment phase; kept so the native planner (bamcore hm_plan_groups)
#: and `plan_groups` give the JAX package's plans unchanged.
CHUNK_LANES = 640
PLAN_EXTENT = CHUNK_LANES + 127

#: reverse-strand channel order: one-hot A,C,G,T -> T,G,C,A (complement);
#: kinetics (fi, fp, ri, rp) -> (ri, rp, fi, fp)
REV_CHANNEL_PERM = (3, 2, 1, 0, 6, 7, 4, 5)


def plan_groups(starts_sorted: np.ndarray, group: int, block_rows: int,
                kmer: int, n_rows: int, extent: int | None = None):
    """Pack position-sorted window starts into groups of `group` sites whose
    span fits one block.

    Returns (bases (ng,) int32, rels (ng, group) int32, idx).  idx maps each
    group slot back to its position in starts_sorted; partial groups are
    padded by repeating one of the group's real sites (identical windows ->
    identical probs, so callers can scatter flat results through idx and the
    duplicates overwrite with the same value).  When every consecutive chunk
    of `group` sites fits the span cap, slot order IS input order and idx is
    None.  Span violations fall back to a greedy split loop with a real idx.
    """
    n = len(starts_sorted)
    cap = block_rows - (kmer if extent is None else extent)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros((0, group), np.int32), None
    ng0 = (n + group - 1) // group
    pad = ng0 * group - n
    padded = np.concatenate(
        [starts_sorted, np.full(pad, starts_sorted[-1], starts_sorted.dtype)])
    chunks = padded.reshape(ng0, group)
    if (chunks[:, -1] - chunks[:, 0] <= cap).all():
        bases = np.minimum(chunks[:, 0], n_rows - block_rows).astype(np.int32)
        return bases, (chunks - bases[:, None]).astype(np.int32), None
    # greedy split: some group's span exceeds the cap
    bases, rels, idx = [], [], []
    i = 0
    while i < n:
        j = min(i + group, n)
        if starts_sorted[j - 1] - starts_sorted[i] > cap:
            j = i + int(np.searchsorted(starts_sorted[i:j],
                                        starts_sorted[i] + cap, side="right"))
            j = max(j, i + 1)
        s = starts_sorted[i:j]
        s = np.concatenate([s, np.full(group - len(s), s[0], s.dtype)])
        k = np.concatenate([np.arange(i, j, dtype=np.int64),
                            np.full(group - (j - i), i, np.int64)])
        base = min(int(s.min()), n_rows - block_rows)
        bases.append(base)
        rels.append(s - base)
        idx.append(k)
        i = j
    return (np.asarray(bases, np.int32), np.asarray(rels, np.int32),
            np.asarray(idx, np.int64))


def check_plan(bases: np.ndarray, rels: np.ndarray, n_cols: int,
               kmer: int) -> None:
    """Raise ValueError unless a host plan meets group_windows_t's contract:
    every window inside the table and each group's span within
    BLOCK_LANES."""
    if len(bases) == 0:
        return
    starts = bases.astype(np.int64)[:, None] + rels
    if starts.min() < 0 or starts.max() + kmer > n_cols:
        raise ValueError("group plan reaches outside the feature table")
    if (rels.max(axis=1) - rels.min(axis=1)).max() + kmer > BLOCK_LANES:
        raise ValueError(f"group plan spans more than {BLOCK_LANES} lanes")


def group_windows_t_plain(table: torch.Tensor, bases: torch.Tensor,
                          rels: torch.Tensor, rev: bool, kmer: int,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (ng*G, 8, kmer) windows."""
    starts = (bases.to(torch.int64)[:, None] + rels).reshape(-1)
    lanes = torch.arange(kmer, device=table.device)
    src = table
    if rev:
        lanes = lanes.flip(0)
        src = table[list(REV_CHANNEL_PERM)]
    pos = starts[:, None] + lanes                     # (B, kmer)
    return src[:, pos].permute(1, 0, 2).to(out_dtype).contiguous()


_KERNEL_LIB = None


def _kernel_lib():
    global _KERNEL_LIB
    if _KERNEL_LIB is None:
        from .build import kernel_library
        lib = ctypes.CDLL(kernel_library("group_windows"))
        vp = ctypes.c_void_p
        lib.hm_group_windows_t.restype = ctypes.c_int
        lib.hm_group_windows_t.argtypes = [
            vp, ctypes.c_int64, vp, vp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp]
        _KERNEL_LIB = lib
    return _KERNEL_LIB


def group_windows_t(table: torch.Tensor, bases: torch.Tensor,
                    rels: torch.Tensor, rev: bool = False, kmer: int = 401,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(8, N) float32 table, bases (ng,) int32, rels (ng, G) int32 ->
    (ng*G, 8, kmer) windows of `out_dtype` (float32 or bfloat16).

    Window t of group g starts at lane bases[g] + rels[g, t]; the plan must
    meet check_plan's contract.  CUDA tensors launch the kernel (counted in
    `group_windows_t.launches`); CPU tensors run the plain version."""
    if table.dim() != 2 or table.shape[0] != 8 or table.dtype != torch.float32:
        raise ValueError(f"table must be (8, N) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if bases.dim() != 1 or bases.dtype != torch.int32:
        raise ValueError("bases must be (ng,) int32")
    if (rels.dim() != 2 or rels.dtype != torch.int32
            or rels.shape[0] != bases.shape[0]
            or not 1 <= rels.shape[1] <= GROUP):
        raise ValueError(f"rels must be (ng, G<={GROUP}) int32 matching bases")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not 1 <= kmer <= BLOCK_LANES:
        raise ValueError(f"kmer must be in [1, {BLOCK_LANES}]")
    if not (bases.device == rels.device == table.device):
        raise ValueError("table, bases and rels must share one device")
    if not (table.is_contiguous() and bases.is_contiguous()
            and rels.is_contiguous()):
        raise ValueError("table, bases and rels must be contiguous")
    if table.device.type == "cpu":
        return group_windows_t_plain(table, bases, rels, rev, kmer, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    ng, g = rels.shape
    out = torch.empty((ng * g, 8, kmer), dtype=out_dtype, device=table.device)
    if ng == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.hm_group_windows_t(
            table.data_ptr(), table.shape[1], bases.data_ptr(),
            rels.data_ptr(), ng, g, kmer, int(rev),
            int(out_dtype == torch.bfloat16), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"group_windows_t launch failed: CUDA error {err}")
    group_windows_t.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it to show the
#: main path went through the kernel)
group_windows_t.launches = 0
