"""Read-level 5mC calling engine: BAM -> mod-BAM with MM/ML/MN tags.

The call pipeline of the reference `hifimeth call` (mod_main.cpp:303-412),
run on a GPU.  Reads are decoded and packed host-side into a flat (5, cap)
u8 plane buffer; each flush ships the buffer's filled prefix to the device
once, featurizes it once into an (8, cap) table (amortized over the ~100
overlapping windows per base), plans position-sorted sites into groups, and
calls every candidate site of a context in fixed-size batches: through the
window-gather kernel and the context's CNN (`gather_impl` "pallas", the
default), through the fused kernel that runs gather and CNN per site in
one launch ("fused"), or through the JAX package's XLA gathers, plain
PyTorch indexing into an (N, 8) table ("slice") or its (N/16, 128) fold
("folded"), each followed by the CNN.  Output records keep input order.

Behavioral parity with the reference:
 - reads shorter than min_read_size or without kinetics pass through
   unannotated (mod_main.cpp:189-196)
 - per-read calls are sorted by qoff and split into fwd ('C') / rev ('G')
   series before MM/ML construction (mod_main.cpp:228-253)
 - kinetics tags are stripped unless keep_kinetics (mod_main.cpp:119-143)

The engine is synchronous: one flush stays in flight on the device while the
host decodes and packs the next, and is resolved (D2H + MM/ML build + write)
when the next flush has been dispatched.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import CONTEXTS, FWD, KMER_SIZE
from ..device import resolve_device
from ..features import sites as sitefind
from ..features.read_decode import decode_read
from ..features.windows import (call_sites_batched, call_sites_group,
                                featurize_planes_seg, featurize_planes_t_seg,
                                fold_table)
from ..io import native
from ..io.bam import BamReader, BamRecord, BamWriter
from ..io.mmtags import build_mod_tags
from ..model.cnn import exact_float32, load_model_npz
from ..ops.fused import KMER as FUSED_KMER
from ..ops.fused import call_sites_fused, prepare_fused_params
from ..ops.gather import (BLOCK_LANES, GROUP, PLAN_EXTENT, check_plan,
                          plan_groups)
from ..utils.logging import bytes_to_datasize, format_with_commas, log

PROG = "hifimeth-tpu-torch"


def default_model_dir() -> str:
    """models/ next to the package root (mirrors the reference's
    <exe_dir>/models default, mod_options.cpp:73-78)."""
    return os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "models"))


@dataclass
class CallConfig:
    model_dir: str = ""
    contexts: tuple[str, ...] = CONTEXTS
    min_read_size: int = 1000            # reference default (mod_options.cpp:10)
    site_batch: int = 8192               # sites per CNN batch (multiple of GROUP)
    buffer_bases: int = 1 << 21          # packed plane-buffer capacity
    flush_bases: int = 768 << 10         # dispatch once this many bases are
                                         # packed (0 = buffer_bases)
    keep_kinetics: bool = False
    read_batch_size: int = 10000         # stats/progress granularity
    io_threads: int = 8                  # BGZF codec pool (sam_batch.hpp:19)
    stats_json: str = ""                 # write machine-readable run stats
    device: str = "cuda"                 # "cuda" or "cpu"
    gather_impl: str = "auto"            # "auto" (= "pallas"): gather kernel
                                         # + CNN; "fused": one kernel for
                                         # both; "slice" | "folded": indexing
                                         # gathers + CNN

    def resolve_model_dir(self) -> str:
        return self.model_dir or default_model_dir()


@dataclass
class _PendingRead:
    rec: BamRecord
    fwd_seq: np.ndarray | None = None    # set iff the read was called
    # per-context site slices into the flush's site arrays
    site_slices: dict = field(default_factory=dict)


#: gather paths of the group plan (the rest index per site: slice, folded)
_PLANNED_GATHERS = ("pallas", "fused")


def resolve_gather_impl(name: str) -> str:
    """"auto" -> "pallas"; raises ValueError for an unknown name."""
    if name == "auto":
        return "pallas"
    if name not in ("slice", "folded", "pallas", "fused"):
        raise ValueError(f"unknown gather_impl {name!r}; choose auto, slice, "
                         f"folded, pallas, or fused")
    return name


class ModelSet:
    """Per-context DNAModNet modules on the device, plus the window size;
    with `fused`, each context's weights also packed for the fused kernel."""

    def __init__(self, model_dir: str, contexts, device: torch.device,
                 fused: bool = False):
        self.models = {}
        self.fused = {}
        self.kmer = KMER_SIZE
        kmer_path = os.path.join(model_dir, "kmer.txt")
        if os.path.exists(kmer_path):
            with open(kmer_path) as f:
                self.kmer = int(f.read().strip())
        if fused and self.kmer != FUSED_KMER:
            raise ValueError(
                f"gather_impl=fused supports kmer={FUSED_KMER} only (model "
                f"dir declares kmer={self.kmer}); use gather_impl=pallas")
        for ctx in contexts:
            path = os.path.join(model_dir, f"{ctx}.npz")
            if not os.path.exists(path):
                raise FileNotFoundError(f"model file {path} not found")
            self.models[ctx] = load_model_npz(path, device)
            if fused:
                self.fused[ctx] = prepare_fused_params(self.models[ctx],
                                                       device, self.kmer)
            log("loaded %s model from %s (kmer=%d)", ctx, path, self.kmer)


class CallEngine:
    #: allowed per-flush batch counts (see _decompose_batches)
    _BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

    def __init__(self, cfg: CallConfig):
        # resolved values live on a private copy: the caller's config is
        # never mutated.  A 128-multiple capacity keeps the planner's
        # 128-lane aligned bases inside the table.
        cfg = dataclasses.replace(
            cfg, buffer_bases=-(-cfg.buffer_bases // 128) * 128,
            gather_impl=resolve_gather_impl(cfg.gather_impl))
        if cfg.site_batch < GROUP or cfg.site_batch % GROUP:
            raise ValueError(f"site_batch must be a positive multiple of "
                             f"{GROUP}, got {cfg.site_batch}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            exact_float32()
        self.models = ModelSet(cfg.resolve_model_dir(), cfg.contexts,
                               self.device, fused=cfg.gather_impl == "fused")
        self.kmer = self.models.kmer
        self._inflight = None
        self.stats = {ctx: 0 for ctx in cfg.contexts}
        self.stats.update(reads=0, bases=0, called_reads=0)
        self.timers = {"decode": 0.0, "sites": 0.0, "pack": 0.0,
                       "dispatch": 0.0, "resolve": 0.0, "mmbuild": 0.0}
        self._reset_buffer()

    # -- packing -----------------------------------------------------------
    def _reset_buffer(self):
        cap = self.cfg.buffer_bases
        self._planes = np.zeros((5, cap), dtype=np.uint8)
        # seq-plane fill 255 featurizes to an all-zero one-hot, kinetics 0
        # to 0.0: margins and inter-read gaps are zero features
        self._planes[0].fill(255)
        self._margin = self.kmer
        # the inter-read gap reaches kmer//2, so a window at a read's edge
        # reads ONLY zero features past it - the reference's window zero
        # padding (eval_kmer_features.cpp:40) without a per-site mask
        self._gap = self.kmer // 2 + 16
        self._fill = self._margin
        self._reset_flush_state()

    def _reset_flush_state(self):
        """Start a new flush within the current buffer: pending reads and
        site lists reset; the packed planes persist (fill-through)."""
        self._last_flush_fill = self._fill
        self._pending: list[_PendingRead] = []
        self._sites = {ctx: {"centers": [], "strands": [], "rstart": [],
                             "rend": []}
                       for ctx in self.cfg.contexts}

    def add_read(self, rec: BamRecord, out: list):
        """Queue one record; finished records are appended to `out` in
        input order."""
        self.stats["reads"] += 1
        self.stats["bases"] += rec.l_seq
        if rec.l_seq < self.cfg.min_read_size:
            self._pending.append(_PendingRead(rec))
            return
        t0 = time.perf_counter()
        read = decode_read(rec)
        self.timers["decode"] += time.perf_counter() - t0
        if read is None:
            self._pending.append(_PendingRead(rec))
            return
        cap = self.cfg.buffer_bases
        if read.size > cap - 2 * self.kmer:
            raise ValueError(
                f"read {rec.qname} ({read.size} bp) exceeds buffer capacity "
                f"{cap}; raise --buffer-bases")
        # the slice/folded paths featurize the whole buffer per flush, so
        # they flush only when it is exhausted (the JAX engine's schedule)
        planned = self.cfg.gather_impl in _PLANNED_GATHERS
        fb = (self.cfg.flush_bases if planned else 0) or cap
        packed = self._fill - self._last_flush_fill
        if self._fill + read.size > cap - self._margin:
            # buffer exhausted: flush whatever is pending, start a new one
            self.flush(out)
            self._reset_buffer()
        elif packed > 0 and packed + read.size > fb:
            # fill-through flush: keep packing into the same buffer
            self.flush(out)
        t0 = time.perf_counter()
        start = self._fill
        end = start + read.size
        self._planes[0, start:end] = read.codes
        self._planes[1, start:end] = read.fi
        self._planes[2, start:end] = read.fp
        self._planes[3, start:end] = read.ri
        self._planes[4, start:end] = read.rp
        self._fill = end + self._gap
        self.timers["pack"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        pend = _PendingRead(rec, fwd_seq=read.seq)
        found = sitefind.scan_all(read.seq)
        for ctx in self.cfg.contexts:
            offs, strands = found[ctx]
            s = self._sites[ctx]
            lo = sum(len(c) for c in s["centers"])
            s["centers"].append(offs.astype(np.int32) + start)
            s["strands"].append(strands)
            s["rstart"].append(np.full(len(offs), start, np.int32))
            s["rend"].append(np.full(len(offs), end, np.int32))
            pend.site_slices[ctx] = (lo, lo + len(offs), offs, strands)
            self.stats[ctx] += len(offs)
        self.timers["sites"] += time.perf_counter() - t0
        self.stats["called_reads"] += 1
        self._pending.append(pend)

    # -- device flush ------------------------------------------------------
    @classmethod
    def _bucket_batches(cls, nb: int) -> int:
        for b in cls._BUCKETS:
            if b >= nb:
                return b
        return nb

    @classmethod
    def _decompose_batches(cls, nb: int) -> list[int]:
        """Split a stream's batch count into bucket-sized chunks: the
        largest bucket(s) <= nb plus the remainder rounded UP to one bucket
        (52 -> [48, 4]), or one rounded-up chunk when that pads <= 20%
        (the JAX engine's schedule, which the port keeps so both engines
        run the same batches)."""
        chunks = []
        top = cls._BUCKETS[-1]
        while nb > top:
            chunks.append(top)
            nb -= top
        up = cls._bucket_batches(nb)
        if (up - nb) / up <= 0.2:
            chunks.append(up)
            return chunks
        b = max(b for b in cls._BUCKETS if b <= nb)
        chunks.append(b)
        if nb - b:
            chunks.append(cls._bucket_batches(nb - b))
        return chunks

    def flush(self, out: list):
        """Dispatch the pending reads' sites; resolve the previous flush."""
        t0 = time.perf_counter()
        pending = self._pending
        futures = None
        if any(p.fwd_seq is not None for p in pending):
            futures = self._dispatch(self._planes[:, :self._fill], self._sites)
        self._reset_flush_state()
        self.timers["dispatch"] += time.perf_counter() - t0
        prev, self._inflight = self._inflight, (pending, futures)
        if prev is not None:
            self._emit(prev, out)

    def _dispatch(self, prefix: np.ndarray, sites: dict):
        """Ship + featurize the filled plane prefix, enqueue every
        context's batches; returns the flush's futures."""
        with torch.inference_mode():
            planes = torch.from_numpy(np.ascontiguousarray(prefix))
            planes = planes.to(self.device)
            cap = self.cfg.buffer_bases
            if self.cfg.gather_impl in _PLANNED_GATHERS:
                table = featurize_planes_t_seg(planes, cap)
            else:
                table = featurize_planes_seg(planes, cap)
                if self.cfg.gather_impl == "folded":
                    table = fold_table(table)
            futures = {ctx: self._call_context(ctx, table, sites[ctx])
                       for ctx in self.cfg.contexts}
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return futures, done

    def _call_context(self, ctx: str, table: torch.Tensor, s: dict):
        """Plan groups of GROUP position-sorted sites whose windows fit one
        block and call them; returns (n_sites, streams, order).

        Reverse-strand sites run as a separate stream through the kernels'
        reverse mode, so no per-site strand vector reaches the device.  The
        gather and fused paths share this plan."""
        centers = (np.concatenate(s["centers"]) if s["centers"]
                   else np.empty(0, np.int32))
        n = len(centers)
        if n == 0:
            return n, None, None
        if self.cfg.gather_impl not in _PLANNED_GATHERS:
            return self._call_context_batched(ctx, table, s, centers)
        strands = np.concatenate(s["strands"])
        if n > 1 and not np.all(centers[:-1] <= centers[1:]):
            order = np.argsort(centers, kind="stable")
            c_s, st_s = centers[order], strands[order]
        else:
            order = None
            c_s, st_s = centers, strands
        if st_s.any():
            streams = [(np.flatnonzero(st_s == 0), False),
                       (np.flatnonzero(st_s == 1), True)]
        else:
            streams = [(None, False)]

        n_rows = self.cfg.buffer_bases
        ngrp = self.cfg.site_batch // GROUP
        if self.cfg.gather_impl == "fused":
            weights = self.models.fused[ctx]

            def call(b, r, rev):
                return call_sites_fused(weights, table, b, r, rev)
        else:
            model = self.models.models[ctx]

            def call(b, r, rev):
                return call_sites_group(model, table, b, r, rev, self.kmer)
        results = []
        for sel, rev in streams:
            cs = c_s if sel is None else c_s[sel]
            if len(cs) == 0:
                continue
            starts = (cs - self.kmer // 2).astype(np.int32)
            fast = native.plan_groups_fast(starts, GROUP, BLOCK_LANES,
                                           PLAN_EXTENT, n_rows)
            if fast is not None:
                b128, rels, idx = fast
            else:
                bases, rels, idx = plan_groups(starts, GROUP, BLOCK_LANES,
                                               self.kmer, n_rows,
                                               extent=PLAN_EXTENT)
                b128 = (bases // 128) * 128
                rels = rels + (bases - b128)[:, None]
            check_plan(b128, rels, n_rows, self.kmer)
            ng = len(b128)
            nb = sum(self._decompose_batches((ng + ngrp - 1) // ngrp))
            pad_g = nb * ngrp - ng
            if pad_g:
                # padded groups read the buffer-start margin (base 0): zero
                # windows whose prob slots are dropped at resolve
                b128 = np.concatenate([b128, np.zeros(pad_g, np.int32)])
                rels = np.concatenate([rels, np.zeros((pad_g, GROUP), np.int32)])
            bases_d = torch.from_numpy(b128).to(self.device)
            rels_d = torch.from_numpy(np.ascontiguousarray(rels)).to(self.device)
            parts = [call(bases_d[b * ngrp:(b + 1) * ngrp],
                          rels_d[b * ngrp:(b + 1) * ngrp], rev)
                     for b in range(nb)]
            results.append((self._to_host(torch.cat(parts)), idx, sel, ng))
        return n, results, order

    def _call_context_batched(self, ctx: str, table: torch.Tensor, s: dict,
                              centers: np.ndarray):
        """The slice/folded paths: every site in input order, padded with
        center-0 sites (empty read bounds, so zero windows whose probs are
        dropped at resolve) to the batch decomposition, called one bucket
        chunk at a time; returns (n, streams, order) in _resolve's form,
        one stream in site order."""
        n = len(centers)
        bs = self.cfg.site_batch
        chunks = self._decompose_batches((n + bs - 1) // bs)
        pad = sum(chunks) * bs - n
        arrays = [np.concatenate([a, np.zeros(pad, a.dtype)]) for a in (
            centers, np.concatenate(s["strands"]),
            np.concatenate(s["rstart"]), np.concatenate(s["rend"]))]
        dev = [torch.from_numpy(a).to(self.device) for a in arrays]
        model = self.models.models[ctx]
        parts, o = [], 0
        for k in chunks:
            sl = slice(o * bs, (o + k) * bs)
            parts.append(call_sites_batched(
                model, table, *(a[sl] for a in dev), site_batch=bs,
                kmer=self.kmer, gather_impl=self.cfg.gather_impl))
            o += k
        return n, [(self._to_host(torch.cat(parts)), None, None, n)], None

    def _to_host(self, probs: torch.Tensor) -> torch.Tensor:
        """Enqueue the copy of a device result into pinned host memory (the
        flush's event marks it done); CPU results pass through."""
        if self.device.type != "cuda":
            return probs
        host = torch.empty(probs.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        return host

    def finalize(self, out: list):
        """Flush any packed reads and resolve everything in flight."""
        self.flush(out)
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._emit(prev, out)

    def _emit(self, inflight, out: list):
        pending, futures = inflight
        self._build_emit(pending, self._resolve(futures), out)

    def _resolve(self, futures):
        """Wait for a flush's device results; scatter each stream's slots
        back to site order (padded slots duplicate a real site -> same
        value), then unsort."""
        t0 = time.perf_counter()
        probs = {ctx: np.empty(0, np.uint8) for ctx in self.cfg.contexts}
        if futures is not None:
            per_ctx, done = futures
            if done is not None:
                done.synchronize()
            for ctx, (n, streams, order) in per_ctx.items():
                if streams is None:
                    continue
                sorted_probs = np.empty(n, np.uint8)
                for part, idx, sel, ng in streams:
                    flat = part.numpy()
                    m = n if sel is None else len(sel)
                    if idx is None:
                        sp = flat[:m]
                    else:
                        sp = np.empty(m, np.uint8)
                        sp[idx.ravel()] = flat[:ng * idx.shape[1]]
                    if sel is None:
                        sorted_probs = sp
                    else:
                        sorted_probs[sel] = sp
                if order is None:
                    probs[ctx] = sorted_probs
                else:
                    unsorted = np.empty(n, np.uint8)
                    unsorted[order] = sorted_probs
                    probs[ctx] = unsorted
        self.timers["resolve"] += time.perf_counter() - t0
        return probs

    def _build_emit(self, pending, probs, out: list):
        """MM/ML tag construction + ordered record emission."""
        t0 = time.perf_counter()
        for pend in pending:
            rec = pend.rec
            if pend.fwd_seq is None:
                out.append(rec)
                continue
            qoffs_all, strands_all, probs_all = [], [], []
            for ctx, (lo, hi, offs, strands) in pend.site_slices.items():
                qoffs_all.append(offs)
                strands_all.append(strands)
                probs_all.append(probs[ctx][lo:hi])
            qoffs = np.concatenate(qoffs_all)
            strands = np.concatenate(strands_all)
            pvals = np.concatenate(probs_all)
            fwd_mask = strands == FWD
            fq, fp = qoffs[fwd_mask], pvals[fwd_mask]
            rq, rp = qoffs[~fwd_mask], pvals[~fwd_mask]
            fo = np.argsort(fq, kind="stable")
            ro = np.argsort(rq, kind="stable")
            build_mod_tags(rec, pend.fwd_seq, fq[fo], fp[fo], rq[ro], rp[ro],
                           keep_kinetics=self.cfg.keep_kinetics)
            out.append(rec)
        self.timers["mmbuild"] += time.perf_counter() - t0

    def log_timers(self):
        parts = ", ".join(f"{k}={v:.2f}s" for k, v in self.timers.items())
        print(f"[engine timers] {parts}", file=sys.stderr)


def _print_stats(title: str, contexts, s: dict) -> None:
    """Reference-format stats block (mod_main.cpp:364-407): reads, datasize
    bases, then per-context comma-formatted sample counts (nonzero only)."""
    print(title, file=sys.stderr)
    print(f"  ## Reads: {s['reads']}", file=sys.stderr)
    print(f"  ## Bases: {bytes_to_datasize(s['bases'])}", file=sys.stderr)
    for ctx in contexts:
        if s.get(ctx):
            print(f"  ## {ctx} samples: {format_with_commas(s[ctx])}",
                  file=sys.stderr)
    sys.stderr.flush()


def run_call(in_bam: str, out_bam: str, cfg: CallConfig,
             cmdline: str = f"{PROG} call") -> dict:
    """End-to-end `call`: returns the stats dict."""
    from .. import __version__

    engine = CallEngine(cfg)
    reader = BamReader(in_bam, threads=cfg.io_threads)
    header = reader.header.with_pg_line(PROG, __version__, cmdline)
    writer = BamWriter(out_bam, header, threads=cfg.io_threads)
    try:
        done: list[BamRecord] = []
        next_log = cfg.read_batch_size
        batch_snap = dict(engine.stats)
        for rec in reader:
            engine.add_read(rec, done)
            if engine.stats["reads"] >= next_log:
                # per-batch stats in the reference's format
                # (mod_main.cpp:364-379)
                _print_stats("######## Batch stats:", cfg.contexts,
                             {k: engine.stats[k] - batch_snap[k]
                              for k in engine.stats})
                batch_snap = dict(engine.stats)
                log("%10d reads processed", engine.stats["reads"])
                next_log += cfg.read_batch_size
            for r in done:
                writer.write(r)
            done.clear()
        engine.finalize(done)
        for r in done:
            writer.write(r)
    finally:
        writer.close()
        reader.close()

    s = engine.stats
    engine.log_timers()
    log("Done.")
    _print_stats("******** Final stats:", cfg.contexts, s)
    if cfg.stats_json:
        import json
        with open(cfg.stats_json, "w") as f:
            json.dump({"stats": {k: int(v) for k, v in s.items()},
                       "timers": engine.timers,
                       "config": {"contexts": list(cfg.contexts),
                                  "site_batch": cfg.site_batch,
                                  "gather_impl": engine.cfg.gather_impl,
                                  "device": str(engine.device)}}, f, indent=1)
    return s
