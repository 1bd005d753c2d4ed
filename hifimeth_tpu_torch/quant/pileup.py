"""Genome-wide methylation quantification (`pileup`).

Replicates the reference two-pass algorithm (pileup.cpp:461-606):

Pass 1 (streaming over a coordinate-sorted mod-BAM):
  - parse MM/ML per read; histogram scaled probs per context classified by
    read-local sequence context, primary reads only (pileup.cpp:237-272)
  - for reads passing mapQ/identity filters, map each called site to genome
    coordinates via alignment-exact motif matching and spill
    (sid, soff, prob, motif) records to a temp file (pileup.cpp:485-505)

Then derive per-context adaptive thresholds (quant/threshold.py) and replay
the spill per chromosome into pcov/ncov arrays, emitting three 6-column BEDs
`chr start end freq% pcov ncov` with freq = 100*p/(p+n) (pileup.cpp:513-595).

Three entry points: `run_pileup` (one process, or one read shard of several
processes that share a filesystem), `run_pileup_parallel` (pass 1
and pass 2 fanned out over spawned numpy-only worker processes) and
`run_pileup_multihost` (one process per rank of a torch.distributed group:
the histograms and each chromosome's per-site partial counts are summed by
collectives, parallel/collectives.py; `merge_pileup_shards` joins the
per-rank BEDs).  Everything here is host code: numpy and the native core.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
from dataclasses import dataclass

import numpy as np

from ..constants import BASE_COMPLEMENT
from ..features.sites import _IS_H  # A/C/T membership table
from ..io import native
from ..io.bam import BamReader, BamRecord
from ..io.fasta import FastaDatabase
from ..io.mmtags import parse_mod_tags_flat
from ..parallel.dist import ShardSpec, chromosome_ranges
from ..utils.logging import log
from .alignment import expand_alignment
from .mapping import map_chg_sites, map_chh_sites, map_cpg_sites
from .threshold import resolve_threshold

_C, _G = ord("C"), ord("G")
_IS_D = np.zeros(256, dtype=bool)   # A/G/T (rev CHH inner bases)
_IS_D[list(b"AGT")] = True

SPILL_DTYPE = np.dtype(
    [("sid", "<i4"), ("soff", "<i4"), ("prob", "u1"), ("motif", "u1")])
CONTEXT_NAMES = ("CpG", "CHG", "CHH")


@dataclass
class PileupConfig:
    min_mapq: int = 0        # reference default (pileup.cpp:18)
    min_identity: float = 0.0
    io_threads: int = 0      # 0 = physical cores (mod_options.cpp:120-132)

    def __post_init__(self):
        if self.io_threads <= 0:
            from ..utils.system import physical_core_count
            self.io_threads = physical_core_count()


def classify_read_mods(fwd_seq: np.ndarray, qoffs: np.ndarray) -> np.ndarray:
    """Read-local context class per mod: 0 CpG, 1 CHG, 2 CHH, -1 none.

    Vectorized pileup.cpp:237-271: 'C' sites classify by the forward 3-mer
    with CpG > CHG > CHH precedence; 'G' sites count as CHH only when the
    preceding 3-mer is a reverse CHH motif."""
    L = len(fwd_seq)
    cls = np.full(len(qoffs), -1, np.int8)
    if len(qoffs) == 0:
        return cls
    base = fwd_seq[qoffs]

    c_mask = base == _C
    c_off = qoffs[c_mask]
    nxt1 = np.where(c_off + 1 < L, fwd_seq[np.minimum(c_off + 1, L - 1)], 0)
    nxt2 = np.where(c_off + 2 < L, fwd_seq[np.minimum(c_off + 2, L - 1)], 0)
    is_cpg = (c_off + 1 < L) & (nxt1 == _G)
    is_chg = ~is_cpg & (c_off + 2 < L) & _IS_H[nxt1] & (nxt2 == _G)
    is_chh = ~is_cpg & ~is_chg & (c_off + 2 < L) & _IS_H[nxt1] & _IS_H[nxt2]
    c_cls = np.full(len(c_off), -1, np.int8)
    c_cls[is_cpg] = 0
    c_cls[is_chg] = 1
    c_cls[is_chh] = 2
    cls[c_mask] = c_cls

    g_mask = base == _G
    g_off = qoffs[g_mask]
    p1 = np.where(g_off - 1 >= 0, fwd_seq[np.maximum(g_off - 1, 0)], 0)
    p2 = np.where(g_off - 2 >= 0, fwd_seq[np.maximum(g_off - 2, 0)], 0)
    is_rev_chh = (g_off - 2 >= 0) & _IS_D[p2] & _IS_D[p1]
    cls[g_mask] = np.where(is_rev_chh, 2, -1).astype(np.int8)
    return cls


def accumulate_counts(soffs: np.ndarray, probs: np.ndarray, motifs: np.ndarray,
                      thresholds: np.ndarray, chr_size: int):
    """(pcov, ncov, motif_map) per-position arrays for one chromosome.

    Pure-function equivalent of pileup.cpp:513-560; motif_map records the
    LAST motif class written per position (replicating file-order overwrite)
    with 255 = untouched."""
    pos = probs >= thresholds[motifs]
    pcov = np.bincount(soffs[pos], minlength=chr_size).astype(np.int32)
    ncov = np.bincount(soffs[~pos], minlength=chr_size).astype(np.int32)
    motif_map = np.full(chr_size, 255, np.uint8)
    motif_map[soffs] = motifs          # fancy assignment: last write wins
    return pcov, ncov, motif_map


def write_bed_rows(out, chr_name: str, pcov, ncov, motif_map, motif: int,
                   span: tuple[int, int] | None = None) -> int:
    """Write one motif class's 6-column rows to the binary file `out`; %g
    freq formatting matches the reference's default ostream double
    formatting (pileup.cpp:562-586).  `span` restricts the rows to
    positions [lo, hi), so one chromosome can be split across pass-2
    workers.  Rows are formatted natively in 1 Mi-row chunks, or by a
    numpy/f-string fallback that caches the freq string of each (pcov,
    cov) pair (coverage is small, so pairs are few)."""
    cov = pcov + ncov
    mask = (cov > 0) & (motif_map == motif)
    if span is None:
        rows = np.flatnonzero(mask)
    else:
        rows = np.flatnonzero(mask[span[0]:span[1]]) + span[0]
    cache: dict = {}
    for lo in range(0, len(rows), 1 << 20):
        sel = rows[lo:lo + (1 << 20)]
        data = native.bed_rows(chr_name, sel, pcov[sel], cov[sel])
        if data is None:
            parts = []
            for k, pi, ci in zip(sel.tolist(), pcov[sel].tolist(),
                                 cov[sel].tolist()):
                fs = cache.get((pi, ci))
                if fs is None:
                    fs = cache[(pi, ci)] = f"{100.0 * pi / ci:g}"
                parts.append(f"{chr_name}\t{k}\t{k + 1}\t{fs}\t{pi}"
                             f"\t{ci - pi}\n")
            data = "".join(parts).encode()
        out.write(data)
    return len(rows)


def _accumulate_part(part, thresholds, pcov, ncov, motif_map,
                     size: int) -> None:
    """Accumulate one spill chunk into per-chromosome arrays in place
    (native single pass when built; numpy bincount fallback)."""
    if native.accum_counts(part["soff"], part["prob"], part["motif"],
                           thresholds, pcov, ncov, motif_map):
        return
    p, n, mm = accumulate_counts(
        part["soff"].astype(np.int64), part["prob"], part["motif"],
        thresholds, size)
    pcov += p
    ncov += n
    touched = mm != 255
    motif_map[touched] = mm[touched]


class PileupSpill:
    """Buffered spill of mapped mod records, replayed per chromosome.

    The reference's read_base_mods temp file (pileup.cpp:485-505): input
    order over a coordinate-sorted BAM keeps the spill sid-ordered, so the
    replay is a sequential scan."""

    def __init__(self, flush_records: int = 1 << 20, dir=None):
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._flush_records = flush_records
        fd, self.path = tempfile.mkstemp(prefix="read_base_mods_", dir=dir)
        self._fh = os.fdopen(fd, "wb")

    def add(self, recs: np.ndarray) -> None:
        if len(recs) == 0:
            return
        self._buf.append(recs)
        self._buffered += len(recs)
        if self._buffered >= self._flush_records:
            self.flush()

    def flush(self) -> None:
        for b in self._buf:
            b.tofile(self._fh)
        self._buf.clear()
        self._buffered = 0

    def finish(self) -> None:
        self.flush()
        self._fh.close()

    def replay(self, chunk: int = 1 << 20):
        """Yield record chunks in file order (after finish)."""
        return _read_spill(self.path, chunk)

    def cleanup(self) -> None:
        _remove(self.path)


class _ExternalSpill:
    """Replay wrapper over a finished spill file given by path: another
    shard's on a shared filesystem, or a pool worker's."""

    def __init__(self, path: str):
        self.path = path

    def replay(self, chunk: int = 1 << 20):
        return _read_spill(self.path, chunk)


def _read_spill(path: str, chunk: int):
    with open(path, "rb") as f:
        while True:
            arr = np.fromfile(f, dtype=SPILL_DTYPE, count=chunk)
            if len(arr) == 0:
                return
            yield arr


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _sid_grouped(src, chunk: int = 1 << 20):
    """Yield (sid, record-part) pairs from a sid-ordered spill (anything
    with `replay`)."""
    for arr in src.replay(chunk):
        sids = arr["sid"]
        if sids[0] == sids[-1]:              # single-sid chunk: no copy
            yield int(sids[0]), arr
            continue
        cuts = np.flatnonzero(np.diff(sids)) + 1
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(sids)]):
            yield int(sids[lo]), arr[lo:hi]


def _pass1_stream(reader, hdr, db, cfg, shard, bins, spill) -> int:
    """Pass 1 over the shard's reads: histogram + genome mapping + spill.

    The per-read expansion and mapping run in one native call
    (map_mod_sites) when the native core is built, as the reference's pass
    1 is a tight C++ loop (pileup.cpp:208-353); the numpy pipeline is the
    bit-identical fallback."""
    use_native = native.available()
    n_reads = 0
    read_id = -1
    sam_text = reader.is_sam_text
    while True:
        if sam_text:
            # SAM text yields parsed records: take them directly
            rec = next(reader, None)
            if rec is None:
                break
            read_id += 1
            if not shard.owns_read(read_id):
                continue
        else:
            raw = reader.next_raw()
            if raw is None:
                break
            read_id += 1
            # ownership before the parse: other processes' reads cost only
            # the shared BGZF inflate (the reference's workers likewise
            # skip by read id, sam_batch.hpp:38-54); the view is released
            # before the next next_raw() so the buffer can compact
            if not shard.owns_read(read_id):
                raw.release()
                continue
            rec = BamRecord.from_bytes(raw)
            raw.release()
        n_reads += 1
        if n_reads % 100000 == 0:
            log("%10d reads processed", n_reads)
        stored_seq = rec.seq_ascii()         # aligned orientation
        fwd_seq = (BASE_COMPLEMENT[stored_seq[::-1]] if rec.is_reverse
                   else stored_seq)
        qoffs, strands, codes, probs = parse_mod_tags_flat(rec, fwd_seq)
        if len(qoffs) == 0:
            continue

        if not rec.is_secondary_or_supplementary:
            # histogram: all codes, C/G bases only (pileup.cpp:238-271)
            if not native.hist_mods(fwd_seq, qoffs, probs, bins):
                keep = (fwd_seq[qoffs] == _C) | (fwd_seq[qoffs] == _G)
                cls = classify_read_mods(fwd_seq, qoffs[keep])
                pr = probs[keep]
                for m in range(3):
                    sel = cls == m
                    if sel.any():
                        bins[m] += np.bincount(pr[sel], minlength=256)

        if rec.mapq < cfg.min_mapq or rec.is_unmapped:
            continue

        # read-position -> prob lookup for code 'm' mods (pileup.cpp:277-284)
        has_prob = np.zeros(rec.l_seq, np.uint8)
        prob_at = np.zeros(rec.l_seq, np.uint8)
        m_mask = codes == ord("m")
        has_prob[qoffs[m_mask]] = 1
        prob_at[qoffs[m_mask]] = probs[m_mask]

        res = None
        if use_native:
            sid = db.seq_name2id(hdr.tid2name(rec.refid))
            ops, lens = rec.cigar_ops()
            res = native.map_mod_sites(
                stored_seq, 1 if rec.is_reverse else 0, db.seq_bases(sid),
                rec.pos, ops, lens, has_prob, prob_at)
        if res is not None:
            pi, _epi, soffs, sprobs, motifs = res
            if pi < cfg.min_identity:
                continue
            if len(soffs):
                recs = np.empty(len(soffs), SPILL_DTYPE)
                recs["sid"] = sid
                recs["soff"] = soffs
                recs["prob"] = sprobs
                recs["motif"] = motifs
                spill.add(recs)
            continue

        aln = expand_alignment(rec, db, hdr.tid2name(rec.refid))
        if aln is None or aln.pi < cfg.min_identity:
            continue
        has_prob = has_prob.astype(bool)
        out_parts = []
        for motif, (mq, ms) in enumerate((
                map_cpg_sites(aln), map_chg_sites(aln), map_chh_sites(aln))):
            if len(mq) == 0:
                continue
            sel = has_prob[mq]
            if not sel.any():
                continue
            part = np.empty(int(sel.sum()), SPILL_DTYPE)
            part["sid"] = aln.sid
            part["soff"] = ms[sel]
            part["prob"] = prob_at[mq[sel]]
            part["motif"] = motif
            out_parts.append(part)
        if out_parts:
            spill.add(np.concatenate(out_parts))
    return n_reads


def _thresholds(bins: np.ndarray) -> np.ndarray:
    return np.array([resolve_threshold(bins[m], CONTEXT_NAMES[m])
                     for m in range(3)], np.uint8)


def _open_beds(output_prefix: str, suffix: str) -> list:
    return [open(f"{output_prefix}.{ctx}.cov.bed{suffix}", "wb")
            for ctx in CONTEXT_NAMES]


def _pass2(db, thresholds, spills, output_prefix: str, my_chroms,
           suffix: str) -> int:
    """Per-chromosome multi-way merge over sid-ordered spills (anything
    with `replay`: this process's PileupSpill, other processes' files as
    _ExternalSpill); memory
    bounded by one chromosome (pileup.cpp:513-560).

    `my_chroms` is either a set of owned sids or a dict sid -> (lo, hi)
    position span, so a single chromosome can be range-split across
    workers (each accumulates the whole chromosome but writes only its
    span; BED part files concatenate in span order to the serial bytes)."""
    outs = _open_beds(output_prefix, suffix)
    rows = 0
    streams = [_sid_grouped(s) for s in spills]
    heads = [next(s, None) for s in streams]
    while any(h is not None for h in heads):
        sid = min(h[0] for h in heads if h is not None)
        size = db.seq_length(sid)
        pcov = np.zeros(size, np.int32)
        ncov = np.zeros(size, np.int32)
        motif_map = np.full(size, 255, np.uint8)
        wanted = sid in my_chroms
        span = (my_chroms[sid] if isinstance(my_chroms, dict) and wanted
                else None)
        for i, stream in enumerate(streams):
            while heads[i] is not None and heads[i][0] == sid:
                if wanted:
                    _accumulate_part(heads[i][1], thresholds, pcov, ncov,
                                     motif_map, size)
                heads[i] = next(stream, None)
        if wanted:
            name = db.seq_name(sid)
            for m in range(3):
                rows += write_bed_rows(outs[m], name, pcov, ncov, motif_map,
                                       m, span=span)
    for f in outs:
        f.close()
    return rows


#: collective pass-2 chunk length: one fixed shape for every process's
#: all-reduces whatever the chromosome sizes (4 Mi positions = 48 MB of
#: (pcov, ncov, motif) int32 rows)
PASS2_CHUNK = 1 << 22


def _pass2_collective(db, thresholds, spill, output_prefix: str,
                      shard, suffix: str, chunk: int = PASS2_CHUNK) -> int:
    """Distributed pass 2 on collectives.

    Every process accumulates per-site (pcov, ncov, motif) partials from its
    own spill only, then per chunk `psum_site_partials_multihost` gives the
    global counts, in place of the reference's temp-file shuffle and mutex
    merge (pileup.cpp:158-167, 513-560).  The chromosome's round-robin owner
    writes its BED rows; a per-chromosome chunk-occupancy sum keeps the
    chunk collectives to covered regions.  All processes walk sids 0..n-1
    and the globally touched chunks in order, so their collectives line
    up."""
    from ..parallel.collectives import (psum_i64_multihost,
                                        psum_site_partials_multihost)

    my_chroms = set(chromosome_ranges(db.num_seqs, shard))
    outs = _open_beds(output_prefix, suffix)
    rows = 0
    stream = _sid_grouped(spill)
    head = next(stream, None)
    for sid in range(db.num_seqs):
        size = db.seq_length(sid)
        pcov = np.zeros(size, np.int32)
        ncov = np.zeros(size, np.int32)
        motif_map = np.full(size, 255, np.uint8)
        while head is not None and head[0] == sid:
            _accumulate_part(head[1], thresholds, pcov, ncov, motif_map,
                             size)
            head = next(stream, None)
        touched = motif_map != 255
        menc = np.zeros(size, np.int32)
        menc[touched] = (shard.process_id * 4
                         + motif_map[touched].astype(np.int32) + 1)
        n_chunks = -(-size // chunk)
        flags = np.zeros(n_chunks, np.int64)
        for ci in range(n_chunks):
            sl = slice(ci * chunk, min((ci + 1) * chunk, size))
            if menc[sl].any() or pcov[sl].any() or ncov[sl].any():
                flags[ci] = 1
        for ci in np.flatnonzero(psum_i64_multihost(flags)):
            lo = int(ci) * chunk
            hi = min(lo + chunk, size)
            parts = [np.zeros(chunk, np.int32) for _ in range(3)]
            for part, a in zip(parts, (pcov, ncov, menc)):
                part[:hi - lo] = a[lo:hi]
            gp, gn, gm = psum_site_partials_multihost(*parts)
            if sid in my_chroms:
                pcov[lo:hi] = gp[:hi - lo]
                ncov[lo:hi] = gn[:hi - lo]
                menc[lo:hi] = gm[:hi - lo]
        if sid in my_chroms:
            motif_map = np.where(menc > 0, (menc - 1) % 4,
                                 255).astype(np.uint8)
            name = db.seq_name(sid)
            for m in range(3):
                rows += write_bed_rows(outs[m], name, pcov, ncov,
                                       motif_map, m)
    for f in outs:
        f.close()
    return rows


def _check_input(mod_bam_path: str) -> None:
    """The reference's input check (pileup.cpp:438-459): a mapped,
    coordinate-sorted BAM, else exit 1.  Every entry point runs it before pass
    1, in the parent process."""
    reader = BamReader(mod_bam_path, threads=1)
    hdr = reader.header
    reader.close()
    if hdr.n_refs == 0 or hdr.sort_order() != "coordinate":
        print("ERROR: Methylation frequency could not be computed due to the "
              "following errors:", file=sys.stderr)
        if hdr.n_refs == 0:
            print("BAM is not mapped", file=sys.stderr)
        if hdr.sort_order() != "coordinate":
            print("BAM is not sorted", file=sys.stderr)
        raise SystemExit(1)


def _pass1(reference_path: str, mod_bam_path: str, cfg, shard, spill_dir,
           io_threads: int, db=None):
    """Pass 1 over one read shard: (bins, finished PileupSpill, n_reads)."""
    reader = BamReader(mod_bam_path, threads=io_threads)
    try:
        db = db or FastaDatabase(reference_path)
        bins = np.zeros((3, 256), np.int64)
        spill = PileupSpill(dir=spill_dir)
        try:
            n_reads = _pass1_stream(reader, reader.header, db, cfg, shard,
                                    bins, spill)
        finally:
            spill.finish()
    finally:
        reader.close()
    return bins, spill, n_reads


def run_pileup(reference_path: str, mod_bam_path: str, output_prefix: str,
               cfg: PileupConfig | None = None,
               spill_dir: str | None = None, shard: ShardSpec | None = None,
               bins_reduce=None, extra_spill_paths: list[str] | None = None,
               keep_spill: bool = False) -> dict:
    """Genome-wide quantification in this process.

    Sharded over processes that share a filesystem and no collective group
    (shard = ShardSpec with num_processes > 1): this process histograms and
    maps only its round-robin read blocks, `bins_reduce` turns its 256-bin
    histograms into the global ones (the sum over every shard), pass 2
    covers this process's round-robin chromosomes over its own spill and
    every other shard's (`extra_spill_paths`), and the BED rows go to
    per-shard files that merge_pileup_shards joins.  `keep_spill` keeps
    this process's spill file and returns its path as "spill_path", for the
    other shards' pass 2."""
    cfg = cfg or PileupConfig()
    shard = shard or ShardSpec()
    _check_input(mod_bam_path)
    db = FastaDatabase(reference_path)
    bins, spill, n_reads = _pass1(reference_path, mod_bam_path, cfg, shard,
                                  spill_dir, cfg.io_threads, db)
    try:
        if bins_reduce is not None:
            bins = bins_reduce(bins)
        thresholds = _thresholds(bins)
        suffix = ""
        if shard.num_processes > 1:
            suffix = f".shard{shard.process_id:04d}"
            _write_chroms_sidecar(output_prefix, db)
        spills = [spill] + [_ExternalSpill(p)
                            for p in extra_spill_paths or ()]
        rows = _pass2(db, thresholds, spills, output_prefix,
                      set(chromosome_ranges(db.num_seqs, shard)), suffix)
    finally:
        if not keep_spill:
            spill.cleanup()
    return {"reads": n_reads, "thresholds": thresholds.tolist(),
            "bed_rows": rows, "bins": bins,
            "spill_path": spill.path if keep_spill else None}


def _pass2_worker(args):
    """Pool worker: pass 2 over a contiguous (sid, position) span set,
    writing per-context part files (suffix) the parent concatenates in span
    order.  numpy only."""
    reference_path, thresholds, spill_paths, prefix, spans, suffix = args
    return _pass2(_get_db(reference_path), np.asarray(thresholds, np.uint8),
                  [_ExternalSpill(p) for p in spill_paths], prefix, spans,
                  suffix)


def _pass1_worker(args):
    """Pool worker: pass 1 for one shard -> (bins, spill path, n_reads).
    numpy only."""
    reference_path, mod_bam_path, cfg, shard, spill_dir = args
    bins, spill, n_reads = _pass1(reference_path, mod_bam_path, cfg, shard,
                                  spill_dir, 2, _get_db(reference_path))
    return bins, spill.path, n_reads


_DB_CACHE: dict = {}


def _get_db(path: str, quiet: bool = True) -> FastaDatabase:
    """Per-process FastaDatabase cache keyed by (path, mtime): pool workers
    persist across pileup calls, so repeated quantification over one
    reference skips the reload."""
    key = (os.path.abspath(path), os.path.getmtime(path))
    db = _DB_CACHE.get(key)
    if db is None:
        _DB_CACHE.clear()
        db = _DB_CACHE[key] = FastaDatabase(path, quiet=quiet)
    return db


_POOL_CACHE: dict = {}


def _get_worker_pool(workers: int):
    """Spawned numpy-only worker pool, cached per size (spawning and the
    children's imports cost ~0.5 s, which would recur on every pileup call
    in library use).  Spawned, never forked, so no child inherits the
    parent's CUDA context, and the cards are hidden from the children
    (utils/system.worker_spawn_env)."""
    import atexit
    import multiprocessing as mp

    from ..utils.system import worker_spawn_env

    pool = _POOL_CACHE.get(workers)
    if pool is None:
        with worker_spawn_env():
            pool = mp.get_context("spawn").Pool(workers)
        _POOL_CACHE[workers] = pool
        atexit.register(pool.terminate)
    return pool


def _pool_map(workers: int, fn, jobs):
    pool = _get_worker_pool(workers)
    try:
        return pool.map(fn, jobs)
    except Exception:
        # a broken pool would poison every later call: drop it
        _POOL_CACHE.pop(workers, None)
        pool.terminate()
        raise


def run_pileup_parallel(reference_path: str, mod_bam_path: str,
                        output_prefix: str, cfg: PileupConfig | None = None,
                        workers: int = 8, spill_dir: str | None = None) -> dict:
    """One-host parallel pileup: pass 1 fans out over `workers` local
    processes with round-robin read shards (the process analog of the
    reference's pthread pool, pileup.cpp:494-504), the histograms sum in the
    parent, and pass 2 splits the genome into balanced (sid, position)
    spans, one per worker, over all spill files."""
    cfg = cfg or PileupConfig()
    if workers <= 1:
        return run_pileup(reference_path, mod_bam_path, output_prefix, cfg,
                          spill_dir=spill_dir)
    _check_input(mod_bam_path)
    results = _pool_map(workers, _pass1_worker, [
        (reference_path, mod_bam_path, cfg, ShardSpec(i, workers, 100),
         spill_dir) for i in range(workers)])
    bins = sum(r[0] for r in results)
    spill_paths = [r[1] for r in results]
    n_reads = sum(r[2] for r in results)
    try:
        thresholds = _thresholds(bins)
        db = _get_db(reference_path, quiet=False)
        lens = [db.seq_length(s) for s in range(db.num_seqs)]
        total = sum(lens)
        # balanced contiguous (sid, position) spans: rows are independent
        # per position, and part files concatenated in span order give the
        # serial bytes.  Tiny genomes stay serial.
        n_jobs = min(workers, max(1, total // (1 << 18)))
        if n_jobs == 1:
            rows = _pass2(db, thresholds,
                          [_ExternalSpill(p) for p in spill_paths],
                          output_prefix, set(range(db.num_seqs)), "")
        else:
            target = -(-total // n_jobs)
            spans: list[dict] = [dict() for _ in range(n_jobs)]
            j = acc = 0
            for s, L in enumerate(lens):
                off = 0
                while off < L:
                    take = min(L - off, target - acc)
                    spans[j][s] = (off, off + take)
                    acc += take
                    off += take
                    if acc >= target and j < n_jobs - 1:
                        j += 1
                        acc = 0
            spans = [sp for sp in spans if sp]
            rows = sum(_pool_map(workers, _pass2_worker, [
                (reference_path, thresholds.tolist(), spill_paths,
                 output_prefix, sp, f".part{i}")
                for i, sp in enumerate(spans)]))
            for ctx in CONTEXT_NAMES:
                final = f"{output_prefix}.{ctx}.cov.bed"
                with open(final, "wb") as outf:
                    for i in range(len(spans)):
                        with open(f"{final}.part{i}", "rb") as pf:
                            shutil.copyfileobj(pf, outf)
                        _remove(f"{final}.part{i}")
    finally:
        for p in spill_paths:
            _remove(p)
    return {"reads": n_reads, "thresholds": thresholds.tolist(),
            "bed_rows": rows, "bins": bins}


def run_pileup_multihost(reference_path: str, mod_bam_path: str,
                         output_prefix: str, shard: ShardSpec,
                         cfg: PileupConfig | None = None,
                         spill_dir: str | None = None) -> dict:
    """Pileup over a torch.distributed group, one rank per process.

    Every process: pass 1 over its round-robin read shard -> local spill ->
    histogram all-reduce (also the pass-1 barrier) -> collective pass 2
    (_pass2_collective; no process reads another's spill) -> per-shard BEDs
    `{prefix}.{ctx}.cov.bed.shard%04d` for its round-robin chromosomes, and
    the `{prefix}.chroms` sidecar.  Join them with merge_pileup_shards (CLI
    merge-pileup-shards)."""
    from ..parallel.collectives import psum_histograms_multihost

    cfg = cfg or PileupConfig()
    _check_input(mod_bam_path)
    db = FastaDatabase(reference_path)
    bins, spill, n_reads = _pass1(reference_path, mod_bam_path, cfg, shard,
                                  spill_dir, cfg.io_threads, db)
    try:
        bins = psum_histograms_multihost(bins)
        thresholds = _thresholds(bins)
        _write_chroms_sidecar(output_prefix, db)
        rows = _pass2_collective(db, thresholds, spill, output_prefix,
                                 shard, f".shard{shard.process_id:04d}")
    finally:
        spill.cleanup()
    return {"reads": n_reads, "thresholds": thresholds.tolist(),
            "bed_rows": rows, "bins": bins}


def _write_chroms_sidecar(output_prefix: str, db) -> None:
    """Record the reference chromosome names in sid order so
    merge_pileup_shards can interleave shard BEDs back into global sid
    order without re-reading the FASTA.  Atomic (temp + rename) because
    every process writes the same content."""
    tmp = f"{output_prefix}.chroms.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        for sid in range(db.num_seqs):
            f.write(db.seq_name(sid) + "\n")
    os.replace(tmp, f"{output_prefix}.chroms")


def merge_pileup_shards(output_prefix: str, n_shards: int,
                        chrom_names: list[str] | None = None) -> None:
    """Interleave per-shard BED files back into global sid order.

    Each shard's BED holds blocks of rows for the chromosomes it owns
    (round-robin over sid), in ascending sid order, so the merge takes one
    chromosome block at a time to be byte-equal to the one-process output
    (chromosomes in sid order, pileup.cpp:513-595).  The sid order comes
    from `chrom_names` or the `{output_prefix}.chroms` sidecar the sharded
    runs wrote; chromosomes with no rows are skipped."""
    if chrom_names is None:
        with open(f"{output_prefix}.chroms") as f:
            chrom_names = [line.rstrip("\n") for line in f]
    for ctx in CONTEXT_NAMES:
        paths = [f"{output_prefix}.{ctx}.cov.bed.shard{s:04d}"
                 for s in range(n_shards)]
        readers = [open(p) if os.path.exists(p) else None for p in paths]
        heads = [r.readline() if r is not None else "" for r in readers]
        with open(f"{output_prefix}.{ctx}.cov.bed", "w") as out:
            for name in chrom_names:
                for i, r in enumerate(readers):
                    if r is None:
                        continue
                    while heads[i] and heads[i].split("\t", 1)[0] == name:
                        out.write(heads[i])
                        heads[i] = r.readline()
        for r in readers:
            if r is not None:
                r.close()
