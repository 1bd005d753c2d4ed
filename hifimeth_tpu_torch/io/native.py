"""ctypes bridge to the native I/O core (src/native/bamcore.cpp) and to
the flush-wide MM/ML builder (ops/csrc/mmbuild.cpp).

The libraries are compiled from the repository's own sources at first use
(ops/build.bamcore_library, ops/build.mmbuild_library) into the port's
git-ignored build directory.  Every I/O core entry point has a pure-numpy
fallback, used when no C++ compiler or zlib is available; where the MM/ML
builder is missing, `mm_flush` returns None and the engine builds each
read's tags on its own.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..constants import (BAM_NIBBLE_TO_BASE, BASE_COMPLEMENT,
                         encode_frames_codev1)

_LIB = None
_MMLIB = None


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
    lib.hm_seq_unpack.restype = None
    lib.hm_seq_unpack.argtypes = [u8p, c_i64, u8p]
    lib.hm_revcomp.restype = None
    lib.hm_revcomp.argtypes = [u8p, c_i64, u8p]
    lib.hm_encode_codev1.restype = None
    lib.hm_encode_codev1.argtypes = [ctypes.POINTER(ctypes.c_uint16), c_i64,
                                     u8p]
    lib.hm_scan_sites.restype = None
    lib.hm_scan_sites.argtypes = [u8p, c_i64, i32p, i64p, i32p, i64p,
                                  i32p, u8p, i64p]
    lib.hm_mm_deltas.restype = c_i64
    lib.hm_mm_deltas.argtypes = [u8p, c_i64, ctypes.c_uint8, i32p, c_i64,
                                 ctypes.c_char_p, c_i64]
    lib.hm_plan_groups.restype = c_i64
    lib.hm_plan_groups.argtypes = [i32p, c_i64, c_i32, c_i32, c_i32,
                                   c_i64, c_i64, i32p, i32p, i64p, i32p]
    # pileup, cov2bed, corr and eval
    dp = ctypes.POINTER(ctypes.c_double)
    lib.hm_parse_deltas.restype = c_i64
    lib.hm_parse_deltas.argtypes = [u8p, c_i64, i32p]
    lib.hm_bed_rows.restype = c_i64
    lib.hm_bed_rows.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, c_i64,
                                ctypes.c_char_p, c_i64]
    lib.hm_bed_rows7.restype = c_i64
    lib.hm_bed_rows7.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, u8p,
                                 ctypes.c_char_p, c_i32, c_i64,
                                 ctypes.c_char_p, c_i64]
    lib.hm_scan_bed6.restype = c_i64
    lib.hm_scan_bed6.argtypes = [u8p, c_i64, c_i32, i64p, i64p, i64p, i64p,
                                 i32p, i64p, i32p, c_i64, i64p]
    lib.hm_map_mod_sites.restype = c_i64
    lib.hm_map_mod_sites.argtypes = [
        u8p, c_i64, c_i32,            # query, qsize, qdir
        u8p, c_i64, c_i64,            # chr_seq, chr_len, pos
        u8p, i32p, c_i64,             # cigar ops, lens, n_cigar
        u8p, u8p,                     # has_prob, prob_at
        dp, dp,                       # pi, epi
        i32p, u8p, u8p, c_i64]        # soff, prob, motif, cap
    lib.hm_hist_mods.restype = None
    lib.hm_hist_mods.argtypes = [u8p, c_i64, i64p, u8p, c_i64, i64p]
    lib.hm_accum_counts.restype = None
    lib.hm_accum_counts.argtypes = [i32p, u8p, u8p, c_i64, u8p,
                                    i32p, i32p, u8p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return bool(_load())


def _load_mmbuild():
    global _MMLIB
    if _MMLIB is not None:
        return _MMLIB
    from ..ops.build import mmbuild_library
    path = mmbuild_library()
    if path is None:
        _MMLIB = False
        return _MMLIB
    lib = ctypes.CDLL(path)
    c_i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hm_mm_flush.restype = c_i64
    lib.hm_mm_flush.argtypes = [c_i64, c_i64,              # reads, contexts
                                u8p, i64p,                 # seq, seq_off
                                i64p, u8p,                 # offs, strands
                                i64p, i64p, u8p,           # counts, prob_at, probs
                                u8p, c_i64, i64p,          # mm, cap, mm_off
                                u8p, i64p]                 # ml, ml_off
    _MMLIB = lib
    return _MMLIB


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


def seq_unpack(nibbles: bytes, l_seq: int) -> np.ndarray:
    """BAM 4-bit SEQ -> l_seq ASCII bytes."""
    arr = np.frombuffer(nibbles, np.uint8)
    lib = _load()
    if not lib:
        return np.stack([BAM_NIBBLE_TO_BASE[arr >> 4],
                         BAM_NIBBLE_TO_BASE[arr & 15]], 1).reshape(-1)[:l_seq]
    out = np.empty(l_seq, np.uint8)
    lib.hm_seq_unpack(_u8p(np.ascontiguousarray(arr)), l_seq, _u8p(out))
    return out


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII sequence (ACGTacgtNn; anything else
    -> N)."""
    seq = np.ascontiguousarray(seq, np.uint8)
    lib = _load()
    if not lib:
        return BASE_COMPLEMENT[seq[::-1]]
    out = np.empty(len(seq), np.uint8)
    lib.hm_revcomp(_u8p(seq), len(seq), _u8p(out))
    return out


def encode_codev1(frames: np.ndarray) -> np.ndarray:
    """Raw kinetics frames -> codeV1 bytes."""
    frames = np.ascontiguousarray(frames, np.uint16)
    lib = _load()
    if not lib:
        return encode_frames_codev1(frames)
    out = np.empty(len(frames), np.uint8)
    lib.hm_encode_codev1(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), len(frames),
        _u8p(out))
    return out


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


def mm_flush(seq: np.ndarray, seq_off: np.ndarray, offs: np.ndarray,
             strands: np.ndarray, counts: np.ndarray, prob_at: np.ndarray,
             probs: np.ndarray):
    """Every read's MM text and ML bytes of one flush in one native call
    (ops/csrc/mmbuild.cpp, which documents the layout): `counts` and
    `prob_at` are (reads, contexts); `offs` and `strands` hold the
    entries' sites one after another in read-major order.  Returns (MM
    bytes, MM offsets, ML array, ML offsets), the offsets (reads + 1,)
    lists; a read without sites has empty slices.  None if the builder is
    unavailable; ValueError naming the read's index if a call does not
    sit on its series base."""
    lib = _load_mmbuild()
    if not lib:
        return None
    n_reads, n_ctx = counts.shape
    seq = np.ascontiguousarray(seq, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    offs = np.ascontiguousarray(offs, np.int64)
    strands = np.ascontiguousarray(strands, np.uint8)
    counts = np.ascontiguousarray(counts, np.int64)
    prob_at = np.ascontiguousarray(prob_at, np.int64)
    probs = np.ascontiguousarray(probs, np.uint8)
    n_sites = len(offs)
    if (len(seq_off) != n_reads + 1 or prob_at.shape != counts.shape
            or len(strands) != n_sites or int(counts.sum()) != n_sites
            or seq_off[-1] > len(seq)
            or (n_sites and (prob_at.min() < 0 or
                             (prob_at + counts).max() > len(probs)))):
        raise ValueError("mm_flush: inconsistent site arrays")
    # "C+m" ";G-m" ";" a read; a comma and at most 10 digits a call
    cap = 8 * n_reads + 11 * n_sites
    mm = np.empty(max(cap, 1), np.uint8)
    mm_off = np.empty(n_reads + 1, np.int64)
    ml = np.empty(n_sites, np.uint8)
    ml_off = np.empty(n_reads + 1, np.int64)
    w = lib.hm_mm_flush(n_reads, n_ctx, _u8p(seq), _i64p(seq_off),
                        _i64p(offs), _u8p(strands), _i64p(counts),
                        _i64p(prob_at), _u8p(probs), _u8p(mm), cap,
                        _i64p(mm_off), _u8p(ml), _i64p(ml_off))
    if w < 0:
        raise ValueError(f"mm_flush: read {-1 - w} of the flush has a call "
                         f"offset not on its series base")
    return mm[:w].tobytes(), mm_off.tolist(), ml, ml_off.tolist()


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


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def parse_deltas(body: bytes):
    """An MM delta body b"d0,d1,..." -> int32 array; None if the native
    library is unavailable; ValueError on malformed input (illegal char,
    empty token, overflow)."""
    lib = _load()
    if not lib:
        return None
    arr = np.frombuffer(body, np.uint8)
    out = np.empty(len(body) // 2 + 1, np.int32)
    n = lib.hm_parse_deltas(_u8p(arr), len(arr), _i32p(out))
    if n < 0:
        raise ValueError("illegal MM delta body")
    return out[:n]


def bed_rows(chr_name: str, pos: np.ndarray, pcov: np.ndarray,
             cov: np.ndarray):
    """Pileup's 6-column BED rows as bytes (C %g == Python :g); None if
    the native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    pos = np.ascontiguousarray(pos, np.int32)
    pcov = np.ascontiguousarray(pcov, np.int32)
    cov = np.ascontiguousarray(cov, np.int32)
    name = chr_name.encode()
    # the native per-row guard wants chr_len + 128 bytes of headroom
    cap = (len(name) + 128) * max(len(pos), 1) + 8
    out = ctypes.create_string_buffer(cap)
    w = lib.hm_bed_rows(name, _i32p(pos), _i32p(pcov), _i32p(cov), len(pos),
                        out, cap)
    if w < 0:
        raise ValueError("bed_rows: buffer overflow")
    return out.raw[:w]


def bed_rows7(chr_name: str, pos: np.ndarray, pcov: np.ndarray,
              cov: np.ndarray, motif_id: np.ndarray,
              motif_names: list[str]):
    """cov2bed's 7-column BED rows (... motif) as bytes; None if the
    native library is unavailable."""
    lib = _load()
    if not lib:
        return None
    pos = np.ascontiguousarray(pos, np.int32)
    pcov = np.ascontiguousarray(pcov, np.int32)
    cov = np.ascontiguousarray(cov, np.int32)
    motif_id = np.ascontiguousarray(motif_id, np.uint8)
    stride = max(len(m) for m in motif_names) + 1
    table = b"".join(m.encode().ljust(stride, b"\0") for m in motif_names)
    name = chr_name.encode()
    cap = (len(name) + 128) * max(len(pos), 1)
    out = ctypes.create_string_buffer(cap)
    w = lib.hm_bed_rows7(name, _i32p(pos), _i32p(pcov), _i32p(cov),
                         _u8p(motif_id), table, stride, len(pos), out, cap)
    if w < 0:
        raise ValueError("bed_rows7: buffer overflow")
    return out.raw[:w]


def scan_bed6(data: bytes, skip_short: bool):
    """Parse 6+-column methylation-BED / Bismark-cov text ->
    (names, chrid, start, end, pcov, ncov): `names` lists the chromosome
    names in run order and chrid indexes it.  None if the native library is
    unavailable; ValueError (with the offending line) on a malformed row."""
    lib = _load()
    if not lib:
        return None
    buf = np.frombuffer(data, np.uint8)
    max_rows = data.count(b"\n") + 2
    start = np.empty(max_rows, np.int64)
    end = np.empty(max_rows, np.int64)
    pcov = np.empty(max_rows, np.int64)
    ncov = np.empty(max_rows, np.int64)
    chrid = np.empty(max_rows, np.int32)
    # a 64 Ki name table first; a failure is a parse error OR the table
    # overflowing (> 64 Ki chromosome runs), so retry once with the true
    # upper bound (one run per row) to tell them apart
    for max_names in ((1 << 16), max_rows):
        name_off = np.empty(max_names, np.int64)
        name_len = np.empty(max_names, np.int32)
        n_names = ctypes.c_int64(0)
        n = lib.hm_scan_bed6(
            _u8p(buf), len(buf), int(skip_short), _i64p(start), _i64p(end),
            _i64p(pcov), _i64p(ncov), _i32p(chrid), _i64p(name_off),
            _i32p(name_len), max_names, ctypes.byref(n_names))
        if n >= 0 or max_rows <= max_names:
            break
    if n < 0:
        off = -(n + 1)
        stop = data.find(b"\n", off)
        line = data[off:stop if stop >= 0 else len(data)]
        raise ValueError(f"corrupted BED record {line!r}")
    names = [data[name_off[i]:name_off[i] + name_len[i]].decode()
             for i in range(n_names.value)]
    return names, chrid[:n], start[:n], end[:n], pcov[:n], ncov[:n]


_MAP_SCRATCH = None


def map_mod_sites(query: np.ndarray, qdir: int, chr_seq: np.ndarray,
                  pos: int, ops: np.ndarray, lens: np.ndarray,
                  has_prob: np.ndarray, prob_at: np.ndarray):
    """Pileup pass 1 for one read in one native call: CIGAR expansion,
    identities, alignment-exact motif mapping and spill assembly (as
    quant/alignment.expand_alignment + quant/mapping.map_*).

    Returns (pi, epi, soffs i32, probs u8, motifs u8) in spill order, or
    None if the native library is unavailable or the alignment walks out of
    bounds (the caller takes the numpy path)."""
    global _MAP_SCRATCH
    lib = _load()
    if not lib:
        return None
    query = np.ascontiguousarray(query, np.uint8)
    chr_seq = np.ascontiguousarray(chr_seq, np.uint8)
    ops = np.ascontiguousarray(ops, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    has_prob = np.ascontiguousarray(has_prob, np.uint8)
    prob_at = np.ascontiguousarray(prob_at, np.uint8)
    cap = 4 * int(lens.sum()) + 8
    # per-process scratch, grown on demand (results are copied out); not
    # thread-safe: pass 1 runs on one thread per process
    if _MAP_SCRATCH is None or len(_MAP_SCRATCH[0]) < cap:
        _MAP_SCRATCH = (np.empty(cap, np.int32), np.empty(cap, np.uint8),
                        np.empty(cap, np.uint8))
    soffs, probs, motifs = _MAP_SCRATCH
    pi = ctypes.c_double(0.0)
    epi = ctypes.c_double(0.0)
    n = lib.hm_map_mod_sites(
        _u8p(query), len(query), int(qdir), _u8p(chr_seq), len(chr_seq),
        int(pos), _u8p(ops), _i32p(lens), len(ops), _u8p(has_prob),
        _u8p(prob_at), ctypes.byref(pi), ctypes.byref(epi), _i32p(soffs),
        _u8p(probs), _u8p(motifs), cap)
    if n == -1:
        raise ValueError("map_mod_sites: record buffer overflow")
    if n == -3:
        # HIFIMETH_DEBUG_ALIGN's column self-check (the reference aborts,
        # bam_info.cpp:399-416): fail loudly, never spill corrupt sites
        raise ValueError(
            "map_mod_sites: alignment column self-check failed "
            "(HIFIMETH_DEBUG_ALIGN); CIGAR/sequence mismatch in input?")
    if n < 0:
        return None
    return (pi.value, epi.value, soffs[:n].copy(), probs[:n].copy(),
            motifs[:n].copy())


def hist_mods(fwd_seq: np.ndarray, qoffs: np.ndarray, probs: np.ndarray,
              bins: np.ndarray) -> bool:
    """Pass-1 histogram update for one read (classify by read-local context
    and count, pileup.cpp:237-271) into the (3, 256) int64 `bins` in
    place.  False if the native library is unavailable."""
    lib = _load()
    if not lib:
        return False
    fwd_seq = np.ascontiguousarray(fwd_seq, np.uint8)
    qoffs = np.ascontiguousarray(qoffs, np.int64)
    probs = np.ascontiguousarray(probs, np.uint8)
    assert bins.dtype == np.int64 and bins.flags.c_contiguous
    lib.hm_hist_mods(_u8p(fwd_seq), len(fwd_seq), _i64p(qoffs), _u8p(probs),
                     len(qoffs), _i64p(bins))
    return True


def accum_counts(soff: np.ndarray, prob: np.ndarray, motif: np.ndarray,
                 thresholds: np.ndarray, pcov: np.ndarray, ncov: np.ndarray,
                 motif_map: np.ndarray) -> bool:
    """Pass-2 accumulation of one spill chunk into a chromosome's (pcov,
    ncov, motif_map) arrays in place (pileup.cpp:513-560).  False if the
    native library is unavailable."""
    lib = _load()
    if not lib:
        return False
    soff = np.ascontiguousarray(soff, np.int32)
    prob = np.ascontiguousarray(prob, np.uint8)
    motif = np.ascontiguousarray(motif, np.uint8)
    thresholds = np.ascontiguousarray(thresholds, np.uint8)
    assert pcov.dtype == np.int32 and pcov.flags.c_contiguous
    assert ncov.dtype == np.int32 and ncov.flags.c_contiguous
    assert motif_map.dtype == np.uint8 and motif_map.flags.c_contiguous
    lib.hm_accum_counts(_i32p(soff), _u8p(prob), _u8p(motif), len(soff),
                        _u8p(thresholds), _i32p(pcov), _i32p(ncov),
                        _u8p(motif_map))
    return True
