"""Per-site window gathers: group planning, the CUDA kernel wrappers and
their plain PyTorch versions.

The host sorts each context's sites by position and packs groups of GROUP
sites whose windows fit one span of BLOCK_LANES table lanes (`plan_groups`,
or the native planner in io/native.py).  `group_windows_t` then cuts every
site's (8, kmer) window out of the (8, N) feature table, flipped and
channel-permuted for the reverse strand, in the NCW layout the first
convolution takes.  It is the call path's gather.

Three row-major gathers over an (N, C) table return (B, rows, C) windows
in the JAX package's NWC layout; scripts/microbench_torch_gather.py drives
them:
 - `group_windows`: one block of `block_rows` rows per group of sites, each
   site's `kmer` rows cut from its group's block;
 - `window_slices`: `kmer` consecutive rows per site;
 - `window_rows`: every other row of `fetch_rows` rows per site, from the
   forward or the reverse table.  On the card it takes one of two routes,
   chosen by `window_rows_route` from the table width and the pointers'
   alignment: TMA boxes over a row-pair view of each table with one bulk
   store per site, or a scalar copy.
Each clamps the start it reads from into its table, as lax.dynamic_slice
does, so no start reads outside the table.

On a CUDA tensor each wrapper launches its hand-written kernel
(ops/csrc/group_windows.cu replaces the Pallas kernel
hifimeth_tpu/ops/gather.py:group_windows_t; ops/csrc/row_windows.cu
replaces group_windows, window_slices and window_rows there; the source
notes give bounds and designs); on a CPU tensor it runs its `*_plain`
version, the same function in PyTorch indexing.  There is no fallback
between the two: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import math

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
#: main path went through the kernel); a replay of a captured program adds
#: the launches its body made (engine/programs.py), its capture none
group_windows_t.launches = 0


# --- row-major gathers over an (N, C) table ---------------------------------

def _check_table(name: str, t: torch.Tensor, min_rows: int) -> None:
    if t.dim() != 2 or t.dtype != torch.float32:
        raise ValueError(f"{name} must be (N, C) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.shape[0] < min_rows or t.shape[1] < 1:
        raise ValueError(f"{name} has {t.shape[0]} rows, fewer than the "
                         f"{min_rows} one window reads")


def _check_same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError("all arguments must share one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all arguments must be contiguous")
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ts[0].device}")


def _check_starts(name: str, t: torch.Tensor, spp: int) -> None:
    if t.dim() != 1 or t.dtype != torch.int32:
        raise ValueError(f"{name} must be (B,) int32")
    if spp < 1 or t.shape[0] % spp:
        raise ValueError(f"B = {t.shape[0]} sites is not a multiple of "
                         f"spp = {spp}")


def _rows(starts: torch.Tensor, lo_max: int, n: int,
          step: int = 1) -> torch.Tensor:
    """(B, n) row indices: start clamped into [0, lo_max], then every
    `step`-th row."""
    s = starts.to(torch.int64).clamp(0, lo_max)
    return s[:, None] + step * torch.arange(n, device=starts.device)


def group_windows_plain(feats: torch.Tensor, bases: torch.Tensor,
                        rels: torch.Tensor, group: int, block_rows: int,
                        kmer: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (ng*group, kmer, C)."""
    b = bases.to(torch.int64).clamp(0, feats.shape[0] - block_rows)
    r = rels.to(torch.int64).clamp(0, block_rows - kmer)
    return feats[_rows((b[:, None] + r).reshape(-1), feats.shape[0] - kmer,
                       kmer)]


def window_slices_plain(feats: torch.Tensor, starts: torch.Tensor,
                        kmer: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, kmer, C)."""
    return feats[_rows(starts, feats.shape[0] - kmer, kmer)]


def window_rows_plain(d_table: torch.Tensor, dr_table: torch.Tensor,
                      starts: torch.Tensor, is_rev: torch.Tensor,
                      fetch_rows: int, out_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, out_rows, C)."""
    rows = _rows(starts, d_table.shape[0] - fetch_rows, out_rows, step=2)
    return torch.where((is_rev != 0)[:, None, None], dr_table[rows],
                       d_table[rows])


_ROW_LIB = None


def _row_lib():
    global _ROW_LIB
    if _ROW_LIB is None:
        from .build import kernel_library
        lib = ctypes.CDLL(kernel_library("row_windows"))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hm_group_windows.argtypes = [vp, i64, i32, vp, vp, i32, i32,
                                         i32, i32, vp, vp]
        lib.hm_window_slices.argtypes = [vp, i64, i32, vp, i32, i32, vp, vp]
        lib.hm_window_rows.argtypes = [vp, vp, i64, i32, vp, vp, i32, i32,
                                       i32, i32, i32, i32, i32, vp, vp, vp]
        for fn in (lib.hm_group_windows, lib.hm_window_slices,
                   lib.hm_window_rows):
            fn.restype = ctypes.c_int
        _ROW_LIB = lib
    return _ROW_LIB


def _launch(name: str, device: torch.device, entry: str, *args) -> None:
    """Call `entry` of the row_windows library on `device`'s current stream
    (the last argument); raise on a CUDA error (a negative code: a failed
    tensor-map encode, minus its CUresult)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_row_lib(), entry)(*args, stream)
    if err < 0:
        raise RuntimeError(f"{name}: tensor-map encode failed: CUresult "
                           f"{-err}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


#: largest block group_windows stages in shared memory (bytes)
GROUP_BLOCK_BYTES = 96 << 10


def group_windows(feats: torch.Tensor, bases: torch.Tensor,
                  rels: torch.Tensor, group: int, block_rows: int,
                  kmer: int) -> torch.Tensor:
    """(N, C) float32 table, bases (ng,) int32, rels (ng, group) int32 ->
    (ng*group, kmer, C) windows: window t of group g is rows [b + r, b + r
    + kmer) with b = bases[g] clamped into [0, N - block_rows] and r =
    rels[g, t] clamped into [0, block_rows - kmer].  CUDA tensors launch
    the kernel (counted in `group_windows.launches`); CPU tensors run the
    plain version."""
    _check_table("feats", feats, block_rows)
    if group < 1:
        raise ValueError(f"group must be positive, got {group}")
    if bases.dim() != 1 or bases.dtype != torch.int32:
        raise ValueError("bases must be (ng,) int32")
    if (rels.dim() != 2 or rels.dtype != torch.int32
            or tuple(rels.shape) != (bases.shape[0], group)):
        raise ValueError(f"rels must be (ng, group={group}) int32 matching "
                         f"bases")
    if not 1 <= kmer <= block_rows:
        raise ValueError(f"kmer must be in [1, block_rows={block_rows}]")
    if block_rows * feats.shape[1] * 4 > GROUP_BLOCK_BYTES:
        raise ValueError(f"a block of {block_rows} rows x {feats.shape[1]} "
                         f"channels exceeds {GROUP_BLOCK_BYTES} bytes")
    _check_same_device(feats, bases, rels)
    if feats.device.type == "cpu":
        return group_windows_plain(feats, bases, rels, group, block_rows,
                                   kmer)
    ng = bases.shape[0]
    out = torch.empty((ng * group, kmer, feats.shape[1]),
                      dtype=torch.float32, device=feats.device)
    if ng == 0:
        return out
    _launch("group_windows", feats.device, "hm_group_windows",
            feats.data_ptr(), feats.shape[0], feats.shape[1],
            bases.data_ptr(), rels.data_ptr(), ng, group, block_rows, kmer,
            out.data_ptr())
    group_windows.launches += 1
    return out


group_windows.launches = 0


def window_slices(feats: torch.Tensor, starts: torch.Tensor, kmer: int,
                  spp: int = 8) -> torch.Tensor:
    """(N, C) float32 table, starts (B,) int32 -> (B, kmer, C) windows of
    `kmer` consecutive rows from starts[i] clamped into [0, N - kmer].  B
    must be a multiple of `spp` (the JAX kernel's sites per grid step,
    kept as that contract only).  CUDA tensors launch the kernel (counted
    in `window_slices.launches`); CPU tensors run the plain version."""
    if kmer < 1:
        raise ValueError("kmer must be positive")
    _check_table("feats", feats, kmer)
    _check_starts("starts", starts, spp)
    _check_same_device(feats, starts)
    if feats.device.type == "cpu":
        return window_slices_plain(feats, starts, kmer)
    b = starts.shape[0]
    out = torch.empty((b, kmer, feats.shape[1]), dtype=torch.float32,
                      device=feats.device)
    if b == 0:
        return out
    _launch("window_slices", feats.device, "hm_window_slices",
            feats.data_ptr(), feats.shape[0], feats.shape[1],
            starts.data_ptr(), b, kmer, out.data_ptr())
    window_slices.launches += 1
    return out


window_slices.launches = 0


#: shared memory of one CTA's ring of stages in window_rows' TMA route,
#: bytes (two CTAs fit an SM); the route needs room for two stages (one
#: site's boxes each), and the kernel takes as many as fit, up to 8
ROWS_RING_BYTES = 104 << 10
#: the TMA's largest box side, in elements
TMA_BOX_MAX = 256


def window_rows_boxes(out_rows: int, channels: int) -> tuple[int, int]:
    """The TMA route's tiling of one site's `out_rows` rows: (n_box, R),
    the fewest boxes of R <= 256 rows that cover them, R rounded up so that
    a box of R x `channels` float32 is a multiple of 128 bytes (every box's
    shared-memory address stays 128-byte aligned)."""
    n_box = -(-out_rows // TMA_BOX_MAX)
    step = 32 // math.gcd(channels, 32)
    r = -(-out_rows // n_box)
    return n_box, -(-r // step) * step


def window_rows_route(channels: int, out_rows: int, *ptrs: int) -> str:
    """"tma" where a table row is whole 16-byte units (`channels` % 4 == 0)
    that fit a TMA box (<= 256), every data pointer in `ptrs` is 16-byte
    aligned and two stages of one site's boxes fit ROWS_RING_BYTES; else
    "scalar".  window_rows launches the route this returns and no other."""
    if channels % 4 or channels > TMA_BOX_MAX or any(p % 16 for p in ptrs):
        return "scalar"
    n_box, r = window_rows_boxes(out_rows, channels)
    stage = n_box * r * channels * 4
    return "tma" if 2 * stage <= ROWS_RING_BYTES else "scalar"


def window_rows(d_table: torch.Tensor, dr_table: torch.Tensor,
                starts: torch.Tensor, is_rev: torch.Tensor, fetch_rows: int,
                out_rows: int, spp: int = 8) -> torch.Tensor:
    """Two (N, C) float32 tables, starts and is_rev (B,) int32 -> (B,
    out_rows, C): rows s, s+2, ..., s+2*(out_rows-1) of dr_table where
    is_rev[i] != 0, else of d_table, with s = starts[i] clamped into [0, N -
    fetch_rows].  No flip: callers flip reverse-strand rows.  fetch_rows
    must be even and out_rows <= fetch_rows // 2; B a multiple of `spp`.
    CUDA tensors launch the kernel by the route `window_rows_route` picks
    (counted in `window_rows.launches`); CPU tensors run the plain
    version."""
    if fetch_rows < 2 or fetch_rows % 2:
        raise ValueError(f"fetch_rows must be even and positive, got "
                         f"{fetch_rows}")
    if not 1 <= out_rows <= fetch_rows // 2:
        raise ValueError(f"out_rows must be in [1, fetch_rows // 2 = "
                         f"{fetch_rows // 2}], got {out_rows}")
    _check_table("d_table", d_table, fetch_rows)
    if dr_table.shape != d_table.shape or dr_table.dtype != d_table.dtype:
        raise ValueError("dr_table must match d_table's shape and dtype")
    _check_starts("starts", starts, spp)
    if is_rev.shape != starts.shape or is_rev.dtype != torch.int32:
        raise ValueError("is_rev must be (B,) int32 matching starts")
    _check_same_device(d_table, dr_table, starts, is_rev)
    if d_table.device.type == "cpu":
        return window_rows_plain(d_table, dr_table, starts, is_rev,
                                 fetch_rows, out_rows)
    b = starts.shape[0]
    out = torch.empty((b, out_rows, d_table.shape[1]), dtype=torch.float32,
                      device=d_table.device)
    if b == 0:
        return out
    c = d_table.shape[1]
    route = window_rows_route(c, out_rows, d_table.data_ptr(),
                              dr_table.data_ptr(), out.data_ptr())
    n_box, box_rows = window_rows_boxes(out_rows, c)
    # the TMA route's site order, (site, start and strand) per site, and
    # its site counter
    plan = (torch.empty(2 * b + 2, dtype=torch.int32, device=d_table.device)
            if route == "tma" else None)
    _launch("window_rows", d_table.device, "hm_window_rows",
            d_table.data_ptr(), dr_table.data_ptr(), d_table.shape[0], c,
            starts.data_ptr(), is_rev.data_ptr(), b, fetch_rows, out_rows,
            int(route == "tma"), n_box, box_rows, ROWS_RING_BYTES,
            None if plan is None else plan.data_ptr(), out.data_ptr())
    window_rows.launches += 1
    return out


window_rows.launches = 0
