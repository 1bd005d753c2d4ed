"""ctypes bridge to the native I/O core (src/native/bamcore.cpp).

The library is compiled from the repository's own source at first use
(ops/build.bamcore_library) into the port's git-ignored build directory.
Every entry point has a pure-numpy fallback, used when no C++ compiler or
zlib is available.
"""
from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    from ..ops.build import bamcore_library
    path = bamcore_library()
    if path is None:
        _LIB = False
        return _LIB
    lib = ctypes.CDLL(path)
    c_i64 = ctypes.c_int64
    c_i32 = ctypes.c_int32
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.hm_bgzf_scan.restype = c_i64
    lib.hm_bgzf_scan.argtypes = [u8p, c_i64, i64p, i32p, c_i64, i64p]
    lib.hm_bgzf_inflate.restype = c_i32
    lib.hm_bgzf_inflate.argtypes = [u8p, i64p, i32p, c_i64, u8p, i64p, i32p, c_i32]
    lib.hm_bgzf_compress.restype = c_i64
    lib.hm_bgzf_compress.argtypes = [u8p, c_i64, u8p, c_i64, c_i32, c_i32, c_i32]
    lib.hm_scan_sites.restype = None
    lib.hm_scan_sites.argtypes = [u8p, c_i64, i32p, i64p, i32p, i64p,
                                  i32p, u8p, i64p]
    lib.hm_mm_deltas.restype = c_i64
    lib.hm_mm_deltas.argtypes = [u8p, c_i64, ctypes.c_uint8, i32p, c_i64,
                                 ctypes.c_char_p, c_i64]
    lib.hm_plan_groups.restype = c_i64
    lib.hm_plan_groups.argtypes = [i32p, c_i64, c_i32, c_i32, c_i32,
                                   c_i64, c_i64, i32p, i32p, i64p, i32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return bool(_load())


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bgzf_inflate_buffer(comp: np.ndarray, n_threads: int = 8):
    """Inflate all complete BGZF blocks in `comp` (u8 array).

    Returns (payload bytes, compressed bytes consumed) or None if the native
    library is unavailable."""
    lib = _load()
    if not lib:
        return None
    comp = np.ascontiguousarray(comp, np.uint8)
    max_blocks = len(comp) // 28 + 2
    offsets = np.empty(max_blocks, np.int64)
    sizes = np.empty(max_blocks, np.int32)
    consumed = ctypes.c_int64(0)
    n = lib.hm_bgzf_scan(
        _u8p(comp), len(comp),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_blocks, ctypes.byref(consumed))
    if n < 0:
        raise ValueError("corrupt BGZF stream")
    if n == 0:
        return b"", 0
    offsets = offsets[:n]
    sizes = sizes[:n]
    # pre-size output from each block's ISIZE footer
    isz = np.empty(n, np.int64)
    for i in range(n):
        end = offsets[i] + sizes[i]
        isz[i] = int(np.frombuffer(comp[end - 4:end], "<u4")[0])
    out_offsets = np.zeros(n, np.int64)
    np.cumsum(isz[:-1], out=out_offsets[1:])
    total = int(isz.sum())
    out = np.empty(max(total, 1), np.uint8)
    out_sizes = np.empty(n, np.int32)
    r = lib.hm_bgzf_inflate(
        _u8p(comp),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        _u8p(out),
        out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if r != 0:
        raise ValueError(f"BGZF inflate failed (code {r})")
    return out[:total].tobytes(), int(consumed.value)


def bgzf_compress_buffer(raw: bytes, level: int = 6, n_threads: int = 8):
    """Compress a raw buffer into BGZF blocks (no EOF marker); None if
    unavailable."""
    lib = _load()
    if not lib:
        return None
    arr = np.frombuffer(raw, np.uint8)
    if len(arr) == 0:
        return b""
    cap = len(arr) + (len(arr) // 65280 + 2) * 1024 + 1024
    out = np.empty(cap, np.uint8)
    r = lib.hm_bgzf_compress(_u8p(np.ascontiguousarray(arr)), len(arr),
                             _u8p(out), cap, level, 65280, n_threads)
    if r < 0:
        raise ValueError("BGZF compress failed")
    return out[:r].tobytes()


def scan_sites(seq: np.ndarray):
    """Single-pass CpG/CHG/CHH candidate scan (native-forward ASCII seq).

    Returns (cpg_offs, chg_offs, chh_offs, chh_strands) as int32/uint8
    arrays, or None if the native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    seq = np.ascontiguousarray(seq, np.uint8)
    n = len(seq)
    cpg = np.empty(n or 1, np.int32)
    chg = np.empty(n or 1, np.int32)
    chh = np.empty(n or 1, np.int32)
    chs = np.empty(n or 1, np.uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    nc, ng, nh = (ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64())
    lib.hm_scan_sites(_u8p(seq), n,
                      cpg.ctypes.data_as(i32), ctypes.byref(nc),
                      chg.ctypes.data_as(i32), ctypes.byref(ng),
                      chh.ctypes.data_as(i32),
                      _u8p(chs), ctypes.byref(nh))
    return (cpg[:nc.value], chg[:ng.value], chh[:nh.value],
            chs[:nh.value])


def mm_deltas(seq: np.ndarray, base: int, qoffs: np.ndarray):
    """MM skip-delta string bytes (",d0,d1,...") for ascending qoffs sitting
    on `base` chars; None if the native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    seq = np.ascontiguousarray(seq, np.uint8)
    qoffs = np.ascontiguousarray(qoffs, np.int32)
    cap = 13 * len(qoffs) + 16
    out = ctypes.create_string_buffer(cap)
    w = lib.hm_mm_deltas(_u8p(seq), len(seq), base,
                         qoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         len(qoffs), out, cap)
    if w < 0:
        raise ValueError("mm_deltas: call offset not on the series base")
    return out.raw[:w]


def plan_groups_fast(starts_sorted: np.ndarray, group: int, block_rows: int,
                     extent: int, n_rows: int):
    """Native group planning (fast path + greedy span splitting in one C
    pass): returns (b128 bases (ng,), rels (ng, group), idx) with bases
    aligned down to 128 lanes and idx None when no group was split (slot
    order == input order); None if the native library is unavailable
    (caller falls back to ops/gather.plan_groups)."""
    lib = _load()
    if not lib:
        return None
    starts_sorted = np.ascontiguousarray(starts_sorted, np.int32)
    n = len(starts_sorted)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros((0, group), np.int32), None)
    i32 = ctypes.POINTER(ctypes.c_int32)
    # start at the no-split group count (+ slack for occasional cuts);
    # retry at the true worst case (n 1-site groups) if the C pass says so
    for max_groups in ((n + group - 1) // group + 64, n):
        bases = np.empty(max_groups, np.int32)
        rels = np.empty((max_groups, group), np.int32)
        idx = np.empty((max_groups, group), np.int64)
        trivial = ctypes.c_int32(0)
        ng = lib.hm_plan_groups(
            starts_sorted.ctypes.data_as(i32), n, group, block_rows, extent,
            n_rows, max_groups, bases.ctypes.data_as(i32),
            rels.ctypes.data_as(i32),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(trivial))
        if ng >= 0:
            break
    return (bases[:ng].copy(), rels[:ng].copy(),
            None if trivial.value else idx[:ng].copy())
