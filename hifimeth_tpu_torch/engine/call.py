"""Read-level 5mC calling engine: BAM -> mod-BAM with MM/ML/MN tags.

The call pipeline of the reference `hifimeth call` (mod_main.cpp:303-412),
run on a GPU.  Reads are decoded and packed host-side into a flat (5, cap)
u8 plane buffer; the device featurizes the packed planes once into an
(8, cap) table (amortized over the ~100 overlapping windows per base),
position-sorted sites are planned into groups, and every candidate site of
a context is called in fixed-size batches: through the window-gather kernel
and the context's CNN (`gather_impl` "pallas", the default), through the
fused kernel that runs gather and CNN per site in one launch ("fused"), or
through the JAX package's XLA gathers, plain PyTorch indexing into an
(N, 8) table ("slice") or its (N/16, 128) fold ("folded"), each followed by
the CNN.  Output records keep input order.

Behavioral parity with the reference:
 - reads shorter than min_read_size or without kinetics pass through
   unannotated (mod_main.cpp:189-196)
 - per-read calls are sorted by qoff and split into fwd ('C') / rev ('G')
   series before MM/ML construction (mod_main.cpp:228-253)
 - kinetics tags are stripped unless keep_kinetics (mod_main.cpp:119-143)

The pipeline is the JAX engine's (hifimeth_tpu/engine/call.py):
 1. decode: `_DecodePrefetcher` threads run decode_read and the site scan
    ahead of the packer, in input order (`decode_workers`);
 2. pack (the caller's thread): reads pack into the plane buffer; on every
    path each finished 1/H2D_SEGMENTS segment of the buffer ships to the
    card at once, through a pinned staging buffer on a copy stream, so
    each segment crosses PCIe once per buffer.  The planned paths (pallas,
    fused) also flush before the buffer is full (fill-through, cut at the
    last shipped segment with `segment_align`; reads past it carry over
    to the next flush); slice and folded flush when it is exhausted;
 3. dispatch worker: featurize the flush's segments into each device's
    table, plan the sites (groups on the planned paths, site grids on
    slice and folded) and launch every batch on the engine's compute
    stream (`_run_programs`), queue the results' copies to pinned host
    memory, record the flush's event.  Each batch runs a program
    (engine/programs.py), the JAX engine's compiled per-batch program: one
    per (replica, context, strand) on the planned paths, one per (replica,
    context) on slice and folded (strand is data there), built with the
    engine and, with `graphs` on the card, replayed as a CUDA graph;
 4. resolve worker: wait for that event, scatter and unsort the probs;
 5. emit worker: MM/ML build, one native call for the whole flush
    (ops/csrc/mmbuild.cpp, without the interpreter lock), and the ordered
    BAM write (`sink`).
Each queue holds at most `queue_depth` flushes.  The first worker exception
stops the pipeline's work and is raised on the caller's thread.  With
`async_emit` off (CLI --sync-emit), or without a sink, stages 3-5 run on the
caller's thread with one flush in flight, resolved when the next one has
been dispatched.

Scale-out (parallel/): `data_parallel` splits every batch over a device
list, each device with its own plane segments, table and streams and the
device's read-only models (ModelSet.cached: a device named twice shares
them), the results gathered back to the first device in site order;
`run_call` with a multi-process ShardSpec calls only that process's read
blocks.

Every stage records into the engine's `spans` (engine/spans.py): its
seconds, the seconds it blocks (`decode_wait`, `flush_wait`,
`resolve_wait`, the workers' `*_idle`) and counts (`slots`, `batches`,
`pinned_new`, `mmbuild_native`, `mmbuild_calls`), read as `timers` and
written to `--stats-json`.  With `trace` (CLI: HIFIMETH_TRACE set, as in
the JAX package) each span also takes its thread's CPU seconds
(`<name>_cpu`) and the flush-level spans leave records (`--stats-json`
`spans`); the async pipeline stamps seven events per flush, `flush`
(handed to the dispatch queue), `dispatch0/1`, `resolve0/1` and `emit0/1`
(around each worker's work), and log_timers prints one `[trace flush N]`
line per flush.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import queue
import sys
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import CONTEXTS, FWD, KMER_SIZE
from ..device import resolve_device
from ..features import sites as sitefind
from ..features.read_decode import decode_read
from ..features.windows import (call_sites_group, call_sites_step,
                                featurize_planes_seg, featurize_planes_t_seg,
                                fold_table)
from ..io import native
from ..io.bam import BamReader, BamRecord, BamWriter
from ..io.mmtags import build_mod_tags, set_mod_tags, strip_mod_tags
from ..model.cnn import CONV_IMPLS, exact_float32, load_model_npz
from ..ops.fused import KMER as FUSED_KMER
from ..ops.fused import call_sites_fused, prepare_fused_params
from ..ops.gather import (BLOCK_LANES, GROUP, PLAN_EXTENT, check_plan,
                          plan_groups)
from ..parallel.dist import ShardSpec, shard_path, sharded_read_stream
from ..parallel.mesh import local_devices, resolve_devices
from ..utils.logging import bytes_to_datasize, format_with_commas, log, warn
from .programs import BatchProgram, GraphPool, plan_views, site_views
from .spans import SpanRecorder

PROG = "hifimeth-tpu-torch"

#: CallConfig.compute_dtype names -> torch dtypes
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    flush_ramp: tuple = (1 << 17, 1 << 18)
                                         # the first flushes' thresholds
                                         # (planned paths), so the card
                                         # starts while the host still packs
                                         # its first buffer; () disables
    keep_kinetics: bool = False
    read_batch_size: int = 10000         # stats/progress granularity
    io_threads: int = 8                  # BGZF codec pool (sam_batch.hpp:19)
    stats_json: str = ""                 # write machine-readable run stats
    device: str = "cuda"                 # "cuda" or "cpu"
    gather_impl: str = "auto"            # "auto" (= "pallas"): gather kernel
                                         # + CNN; "fused": one kernel for
                                         # both; "slice" | "folded": indexing
                                         # gathers + CNN
    compute_dtype: str = "float32"       # or "bfloat16": convs and FCs in
                                         # bf16 (ignored by "fused")
    conv_impl: str = "direct"            # direct | im2col | auto: each conv
                                         # as conv1d, as one matrix product
                                         # over unfolded columns, or im2col
                                         # where Cin * K <= 256 (conv1);
                                         # no CLI flag, ignored by "fused"
    feat_channels: int = 8               # the JAX engine's table width
                                         # (8|32|128); the port warns when
                                         # it is not 8 and runs 8 (CLI
                                         # --feat-channels)
    decode_workers: int = -1             # decode + site-scan threads ahead of
                                         # the packer (-1 auto: cores-1,
                                         # at least 1, at most 4; 0 inline)
    async_emit: bool = True              # dispatch/resolve/emit worker
                                         # threads (needs CallEngine.sink)
    queue_depth: int = 2                 # flushes each pipeline queue holds
    segment_align: bool = True           # cut fill-through flushes at the
                                         # last shipped segment (planned
                                         # paths); False ships the segment
                                         # in progress with every flush
    data_parallel: bool = False          # split each batch over every local
                                         # device (pallas, slice, folded)
    trace: bool = False                  # per-flush pipeline timeline on
                                         # stderr (async mode; the CLI sets
                                         # it from HIFIMETH_TRACE)
    graphs: bool = True                  # on the card each batch replays
                                         # its program captured as a CUDA
                                         # graph (every path).
                                         # False runs the program's body
                                         # eagerly, every op launched (no
                                         # CLI flag: for comparisons; the
                                         # CPU always does)

    def resolve_model_dir(self) -> str:
        return self.model_dir or default_model_dir()


#: sentinel for add_read's `decoded` argument ("compute inline")
_UNSET = object()


class _DecodePrefetcher:
    """Runs decode_read + scan_all for upcoming records on worker threads,
    in input order, so the packing thread only packs planes and flushes.

    A feeder thread drains the record stream; `workers` decode threads tag
    results with the input index; iterating reorders them through a dict,
    so output order always equals input order.  Yields (rec, (read, found))
    pairs for CallEngine.add_read.  A worker's exception is raised by the
    iterator.  The workers' decode and site-scan seconds and the iterator's
    wait for the next read in order go to `spans` (`decode`, `sites`,
    `decode_wait`).  `close` stops and joins every thread."""

    _DONE = object()

    def __init__(self, stream, min_read_size: int, spans: SpanRecorder,
                 workers: int = 1, depth: int = 64):
        self.min_read_size = min_read_size
        self.spans = spans
        self.workers = max(1, workers)
        self._exc = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._inq = queue.Queue(maxsize=depth)
        self._outq = queue.Queue(maxsize=depth + self.workers + 2)
        self._threads = [threading.Thread(target=self._feeder, args=(stream,),
                                          name="hifimeth-feed", daemon=True)]
        self._threads += [
            threading.Thread(target=self._worker, name=f"hifimeth-decode{i}",
                             daemon=True) for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def _fail(self, e: BaseException):
        """Keep the first exception (raised by __iter__) and stop reading."""
        with self._lock:
            if self._exc is None:
                self._exc = e
        self._stop.set()

    def _feeder(self, stream):
        try:
            for i, rec in enumerate(stream):
                if self._stop.is_set():
                    break
                self._inq.put((i, rec))
        except BaseException as e:  # noqa: BLE001 - raised by __iter__
            self._fail(e)
        finally:
            for _ in range(self.workers):
                self._inq.put(self._DONE)

    def _worker(self):
        # a worker consumes its queue to the end whatever happens, so the
        # feeder never blocks on a full queue and close() always returns
        spans = self.spans
        while True:
            item = self._inq.get()
            if item is self._DONE:
                break
            if self._stop.is_set():
                continue
            i, rec = item
            try:
                read = found = None
                if rec.l_seq >= self.min_read_size:
                    with spans.span("decode", keep=False):
                        read = decode_read(rec)
                    if read is not None:
                        with spans.span("sites", keep=False):
                            found = sitefind.scan_all(read.seq)
            except BaseException as e:  # noqa: BLE001 - raised by __iter__
                self._fail(e)
                continue
            self._outq.put((i, rec, (read, found)))
        self._outq.put(self._DONE)

    def __iter__(self):
        done = 0
        nxt = 0
        held: dict = {}
        while done < self.workers or held:
            if self._exc is not None:
                raise self._exc
            if done < self.workers:
                with self.spans.wait("decode_wait", keep=False):
                    item = self._outq.get()
                if item is self._DONE:
                    done += 1
                    continue
                i, rec, decoded = item
                held[i] = (rec, decoded)
            while nxt in held:
                yield held.pop(nxt)
                nxt += 1
        if self._exc is not None:
            raise self._exc

    def close(self):
        """Stop reading, let every thread run out, join them."""
        self._stop.set()
        while any(t.is_alive() for t in self._threads):
            with contextlib.suppress(queue.Empty):
                while True:
                    self._outq.get_nowait()
            for t in self._threads:
                t.join(timeout=0.01)


@dataclass
class _PendingRead:
    rec: BamRecord
    fwd_seq: np.ndarray | None = None    # set iff the read was called
    # per-context site slices into the flush's site arrays
    site_slices: dict = field(default_factory=dict)
    start: int = 0                       # packed lanes [start, extent)
    extent: int = 0


class _PinnedPool:
    """Page-locked host buffers for the engine's copies, reused: a buffer
    comes back with the events of the last copies that read or write it and
    is handed out again only once they have completed, so no buffer is
    rewritten under a copy in flight and none is allocated per flush.
    Buffers come in power-of-two byte sizes; the pool keeps every buffer it
    made until the engine goes, at most about one per copy in flight; each
    one made counts in `spans` as `pinned_new`."""

    def __init__(self, spans: SpanRecorder):
        self._free: list = []            # (uint8 buffer, [events])
        self._lock = threading.Lock()
        self._spans = spans

    def take(self, shape, dtype: torch.dtype):
        """(buffer, view of `shape` and `dtype` into it)."""
        n = math.prod(shape) * dtype.itemsize
        size = 1 << max(12, (n - 1).bit_length())
        buf = None
        with self._lock:
            for i, (b, evs) in enumerate(self._free):
                if b.numel() == size and all(ev.query() for ev in evs):
                    buf = self._free.pop(i)[0]
                    break
        if buf is None:
            with torch.inference_mode():
                buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self._spans.count("pinned_new")
        return buf, buf[:n].view(dtype).view(shape)

    def give(self, buf: torch.Tensor, events=()):
        """Return `buf`, free once every event of `events` (an event or a
        list of them) has completed."""
        if isinstance(events, torch.cuda.Event):
            events = [events]
        with self._lock:
            self._free.append((buf, list(events)))


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


def resolve_decode_workers(n: int) -> int:
    """-1 -> min(4, max(1, physical cores - 1)); n >= 0 stays."""
    if n < 0:
        from ..utils.system import physical_core_count
        return min(4, max(1, physical_core_count() - 1))
    return n


class ModelSet:
    """Per-context DNAModNet modules on one device, plus the window size;
    with `fused`, each context's weights also packed for the fused kernel.
    The modules are in eval mode without gradients and are never mutated,
    so one set may serve every engine and replica on its device."""

    #: process-level cache (see ModelSet.cached): key -> ModelSet
    _cache: dict = {}
    _cache_lock = threading.Lock()

    @classmethod
    def cached(cls, model_dir: str, contexts, device, fused: bool = False,
               compute_dtype=torch.float32, conv_impl: str = "direct",
               feat_channels: int = 8) -> "ModelSet":
        """The process-level cache of device-resident weights (the JAX
        engine's ModelSet.cached): engines built from one model directory
        on one device share one read-only set.

        The key holds the model directory's real path, the contexts, the
        resolved device, `fused`, the compute dtype, the convolution route
        and each model file's (st_mtime_ns, st_size), so a rewritten file
        reloads even when its mtime was put back.  Inserting a set evicts
        the sets of the same directory and settings with other file
        stamps.  One lock covers lookup, load and insert, so concurrent
        callers get one object.  `feat_channels` is taken for the JAX
        signature and ignored: every set holds the 8-channel models."""
        del feat_channels
        device = resolve_device(device)
        setting = (os.path.realpath(model_dir), tuple(contexts), str(device),
                   bool(fused), str(compute_dtype), conv_impl)
        stamps = []
        for name in [f"{c}.npz" for c in contexts] + ["kmer.txt"]:
            try:
                st = os.stat(os.path.join(model_dir, name))
                stamps.append((st.st_mtime_ns, st.st_size))
            except FileNotFoundError:
                stamps.append(None)
        key = setting + tuple(stamps)
        with cls._cache_lock:
            ms = cls._cache.get(key)
            if ms is None:
                ms = cls(model_dir, contexts, device, fused, compute_dtype,
                         conv_impl)
                for k in [k for k in cls._cache
                          if k[:len(setting)] == setting]:
                    del cls._cache[k]
                cls._cache[key] = ms
            return ms

    def __init__(self, model_dir: str, contexts, device: torch.device,
                 fused: bool = False, compute_dtype=torch.float32,
                 conv_impl: str = "direct"):
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
            self.models[ctx] = load_model_npz(
                path, device, compute_dtype, conv_impl).requires_grad_(False)
            if fused:
                self.fused[ctx] = prepare_fused_params(self.models[ctx],
                                                       device, self.kmer)
            log("loaded %s model from %s (kmer=%d) on %s", ctx, path,
                self.kmer, device)


class CallEngine:
    #: keys of `timers` in every run: seconds per stage (the first eight;
    #: in async mode dispatch, resolve and mmbuild run on their own threads
    #: and overlap the rest) and per wait, then counts
    SECONDS = ("decode", "sites", "pack", "flush", "dispatch", "resolve",
               "mmbuild", "capture", "decode_wait", "flush_wait",
               "resolve_wait", "write", "dispatch_idle", "resolve_idle",
               "emit_idle")
    COUNTS = ("slots", "batches", "pinned_new", "mmbuild_native",
              "mmbuild_calls")
    #: allowed per-flush batch counts (see _decompose_batches)
    _BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)
    #: the plane buffer ships to the card in this many segments
    H2D_SEGMENTS = 8

    def __init__(self, cfg: CallConfig, devices=None):
        """`devices` (not a CLI option): the device list a data-parallel
        engine splits its batches over, default every local device of
        cfg.device's type.  A device may repeat; each entry gets its own
        models, plane segments, tables and streams."""
        # resolved values live on a private copy: the caller's config is
        # never mutated.  A 128-multiple capacity keeps the planner's
        # 128-lane aligned bases inside the table.
        cfg = dataclasses.replace(
            cfg, buffer_bases=-(-cfg.buffer_bases // 128) * 128,
            gather_impl=resolve_gather_impl(cfg.gather_impl),
            flush_ramp=tuple(cfg.flush_ramp))
        if cfg.site_batch < GROUP or cfg.site_batch % GROUP:
            raise ValueError(f"site_batch must be a positive multiple of "
                             f"{GROUP}, got {cfg.site_batch}")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                             f"choose float32 or bfloat16")
        if cfg.conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {cfg.conv_impl!r}; choose "
                             f"{', '.join(CONV_IMPLS)}")
        if cfg.feat_channels != 8:
            # the JAX engine pads its table to a TPU lane width; wider rows
            # only slow the H100's gathers and never change a tag
            warn("--feat-channels is ignored: every gather path keeps the "
                 "8-channel table")
            cfg = dataclasses.replace(cfg, feat_channels=8)
        if not isinstance(cfg.queue_depth, int) or cfg.queue_depth < 1:
            raise ValueError(f"queue_depth must be an integer >= 1, got "
                             f"{cfg.queue_depth!r}")
        if cfg.decode_workers < -1:
            raise ValueError(f"decode_workers must be >= -1, got "
                             f"{cfg.decode_workers}")
        if any(int(r) < 1 for r in cfg.flush_ramp):
            raise ValueError(f"flush_ramp steps must be positive, got "
                             f"{cfg.flush_ramp}")
        if cfg.gather_impl == "fused" and cfg.compute_dtype != "float32":
            # the JAX engine's warning (its fused kernel runs the MXU's
            # default precision); the port's computes in 3xTF32
            warn("--dtype bf16 has no effect with gather_impl=fused "
                 "(the fused kernel computes every product in 3xTF32)")
            cfg = dataclasses.replace(cfg, compute_dtype="float32")
        if cfg.gather_impl == "fused" and cfg.data_parallel:
            warn("--data-parallel is not supported with gather_impl=fused "
                 "yet; running single-device")
            cfg = dataclasses.replace(cfg, data_parallel=False)
            if devices is not None:
                cfg = dataclasses.replace(
                    cfg, device=str(resolve_devices(devices)[0]))
                devices = None
        self.cfg = cfg
        #: pallas or fused: the group plan, an (8, cap) table and programs
        #: per strand, and the fill-through flush schedule
        self._planned = cfg.gather_impl in _PLANNED_GATHERS
        #: where the engine's threads spend their time (engine/spans.py)
        self.spans = SpanRecorder(cfg.trace)
        self.devices = self._device_list(cfg, devices)
        self.device = self.devices[0]
        if cfg.site_batch < len(self.devices):
            raise ValueError(f"site_batch {cfg.site_batch} is smaller than "
                             f"the {len(self.devices)} devices")
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        n_dev = len(self.devices)
        self._computes = self._copies = [None] * n_dev
        if self.device.type == "cuda":
            exact_float32()
            # each device's dispatch work launches on its _computes stream;
            # plane segments ship on its _copies stream, so their copies
            # overlap the previous flush's kernels
            self._computes = [torch.cuda.Stream(d) for d in self.devices]
            self._copies = [torch.cuda.Stream(d) for d in self.devices]
        #: one ModelSet per device, from the process-level cache: a device
        #: named twice shares one read-only set
        self.replicas = [
            ModelSet.cached(cfg.resolve_model_dir(), cfg.contexts, d,
                            fused=cfg.gather_impl == "fused",
                            compute_dtype=self.compute_dtype,
                            # the fused kernel runs no DNAModNet
                            conv_impl=("direct" if cfg.gather_impl == "fused"
                                       else cfg.conv_impl))
            for d in self.devices]
        self.models = self.replicas[0]
        self.kmer = self.models.kmer
        self.pinned = _PinnedPool(self.spans)
        #: record sink of the async pipeline (run_call: the BAM writer)
        self.sink = None
        self._inflight = None
        self._threads: list = []
        self._dispatch_q = self._resolve_q = self._emit_q = None
        self._exc = None
        self._exc_lock = threading.Lock()
        #: the flush schedule: flushes dispatched with packed reads (the
        #: ramp's index), plane buffers filled, reads carried by a cut
        self.flushes = 0
        self.buffers = 0
        self.carried = 0
        self.stats = {ctx: 0 for ctx in cfg.contexts}
        self.stats.update(reads=0, bases=0, called_reads=0)
        #: the per-flush pipeline timeline (cfg.trace): (flush number,
        #: stage, time) events, printed by log_timers
        self._trace_events = self.spans.stamps
        self._queued = 0
        #: each device's persistent feature table (every flush featurizes
        #: into it: (8, cap) on the planned paths, (cap, 8) on slice and
        #: folded) and its programs, by (context, reverse strand) on the
        #: planned paths and by context on slice and folded; both built
        #: here, before any pipeline thread starts
        self._tables = self._programs = None
        #: each device's sites per batch: all of a batch on the planned
        #: paths (a device calls whole batches); on slice and folded its
        #: share of one (np.linspace, as the JAX mesh splits the batch
        #: axis); Python ints, since `slots` goes to --stats-json
        self._widths = ([cfg.site_batch] * n_dev if self._planned else
                        np.diff(np.linspace(0, cfg.site_batch, n_dev + 1)
                                .astype(int)).tolist())
        with self.spans.span("capture"):
            self._build_programs()
        self._reset_buffer()

    def _build_programs(self):
        """Allocate the persistent tables and build every device's
        programs: on the planned paths one per (context, strand), on slice
        and folded one per context, sized to the device's share of a batch
        (all of it on one device).  With cfg.graphs on the card they are
        captured as CUDA graphs into one GraphPool per device entry (two
        replicas on one card run on two streams at once; the graphs of a
        replica share its pool's memory, one batch's intermediates), each
        geometry warmed up once per entry: contexts whose models have the
        same layer shapes share it; on the planned paths strands do not
        (the gather kernel has a variant per strand)."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        shape = ((8, cfg.buffer_bases) if self._planned
                 else (cfg.buffer_bases, 8))
        #: writes a flush's plane segments into a table of that layout
        self._featurize = (featurize_planes_t_seg if self._planned
                           else featurize_planes_seg)
        with torch.inference_mode():
            self._tables = [torch.zeros(shape, dtype=torch.float32, device=d)
                            for d in self.devices]
            self._programs = []
            for d, dev in enumerate(self.devices):
                pool = GraphPool(dev) if cuda and cfg.graphs else None
                warmed, progs = set(), {}
                width = self._widths[d]
                for ctx in cfg.contexts:
                    shapes = tuple(tuple(p.shape) for p in
                                   self.replicas[d].models[ctx].parameters())
                    if not self._planned:
                        progs[ctx] = BatchProgram(
                            self._site_body(d, ctx, width), 4 * width, width,
                            dev, pool=pool, warm=shapes not in warmed)
                        warmed.add(shapes)
                        continue
                    for rev in (False, True):
                        progs[(ctx, rev)] = BatchProgram(
                            self._batch_body(d, ctx, rev),
                            width // GROUP * (GROUP + 1), width, dev,
                            pool=pool, warm=(shapes, rev) not in warmed)
                        warmed.add((shapes, rev))
                self._programs.append(progs)
        if cuda:
            # the tables' fills and the programs' warm-ups are done before
            # the pipeline's streams use them
            for d in dict.fromkeys(self.devices):
                torch.cuda.synchronize(d)

    def _site_body(self, d: int, ctx: str, share: int):
        """Device d's slice/folded program body for one batch of `ctx`:
        its `share` sites (centers, strands, read bounds, packed in the
        plan) through the indexing gather over the device's persistent
        table (folded: its fold view; over a device list the slice gather
        over the table, as the JAX engine's call_sites_grid) and the CNN,
        into `out` (one step of call_sites_batched)."""
        table = self._tables[d]
        impl = self.cfg.gather_impl if len(self.devices) == 1 else "slice"
        if impl == "folded":
            table = fold_table(table)
        model, kmer = self.replicas[d].models[ctx], self.kmer

        def body(plan, out):
            call_sites_step(model, table, *site_views(plan, share), kmer,
                            impl, out=out)
        return body

    def _batch_body(self, d: int, ctx: str, rev: bool):
        """Device d's program body for one batch of `ctx` on one strand:
        the plan's groups through the gather kernel and the CNN, or through
        the fused kernel, over the device's persistent table, into `out`."""
        table = self._tables[d]
        ngrp = self.cfg.site_batch // GROUP
        replica = self.replicas[d]
        if self.cfg.gather_impl == "fused":
            weights = replica.fused[ctx]

            def body(plan, out):
                call_sites_fused(weights, table, *plan_views(plan, ngrp), rev,
                                 out=out)
        else:
            model, kmer = replica.models[ctx], self.kmer

            def body(plan, out):
                call_sites_group(model, table, *plan_views(plan, ngrp), rev,
                                 kmer, out=out)
        return body

    @staticmethod
    def _device_list(cfg: CallConfig, devices) -> list:
        """The engine's devices: data-parallel, `devices` or every local
        device of cfg.device's type (the JAX engine's rule: a split only
        when there is more than one); else cfg.device alone."""
        if not cfg.data_parallel:
            if devices is not None:
                raise ValueError("a device list needs data_parallel=True")
            return [resolve_device(cfg.device)]
        devs = (local_devices(cfg.device) if devices is None
                else resolve_devices(devices))
        if devs[0].type != torch.device(cfg.device).type:
            raise ValueError(f"devices {devs} are not of cfg.device's type "
                             f"{cfg.device!r}")
        if len(devs) == 1:
            log("data-parallel call: one local device, running the "
                "single-device path")
        else:
            log("data-parallel call over %d devices (%s)", len(devs),
                ", ".join(str(d) for d in devs))
        return devs

    # -- device context ------------------------------------------------------
    @contextlib.contextmanager
    def _on_device(self):
        """Inference mode, and on the card the primary device and its
        compute stream: each of them is per thread, so every thread that
        touches the device enters this."""
        with contextlib.ExitStack() as st:
            st.enter_context(torch.inference_mode())
            if self.device.type == "cuda":
                st.enter_context(torch.cuda.device(self.device))
                st.enter_context(torch.cuda.stream(self._computes[0]))
            yield

    def _stream(self, d: int):
        """Device d's compute stream as the current stream (and its device
        as the current device) on the card; nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._computes[d])

    def _ship(self, piece: np.ndarray) -> list:
        """A (5, seg) plane piece to every device: on the card through one
        pinned staging buffer and each device's copy stream, giving
        [(tensor, the copy's event)] per device; on the CPU a copy per
        device, [(tensor, None)].  Over a device list the bytes shipped,
        summed over the devices, count as `ship_bytes`."""
        if len(self.devices) > 1:
            self.spans.count("ship_bytes", piece.nbytes * len(self.devices))
        if self.device.type != "cuda":
            return [(torch.from_numpy(piece.copy()), None)
                    for _ in self.devices]
        buf, host = self.pinned.take(piece.shape, torch.uint8)
        np.copyto(host.numpy(), piece)
        out = []
        with torch.inference_mode():
            for dev, copy in zip(self.devices, self._copies):
                with torch.cuda.stream(copy):
                    t = torch.empty(piece.shape, dtype=torch.uint8,
                                    device=dev)
                    t.copy_(host, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(copy)
                out.append((t, ev))
        self.pinned.give(buf, [ev for _, ev in out])
        return out

    def _h2d(self, a: np.ndarray, hold: list, d: int = 0) -> torch.Tensor:
        """A host array to device d on its current stream (the caller is
        inside _stream(d)), through a pinned buffer (put in `hold` until
        the flush's event)."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(a))
        buf, host = self.pinned.take(a.shape, torch.from_numpy(a[:0]).dtype)
        np.copyto(host.numpy(), a)
        hold.append(buf)
        return host.to(self.devices[d], non_blocking=True)

    def _to_primary(self, per_dev: list) -> list:
        """per_dev[d]: device d's result tensor, made on its stream, over a
        device list -> the same results on the primary device, ready on the
        current (primary) stream.  A replica on the primary's own device is
        waited for by event; another card's result is copied on that
        card's stream (PyTorch's cross-device copy_: the source stream
        first waits for the primary stream, where the copy's target is
        allocated, and the primary stream then waits for the copy), and
        its bytes count as `peer_bytes`.  The CPU's results stay."""
        if self.device.type != "cuda":
            self.spans.count("peer_bytes", 0)
            return per_dev
        cur = torch.cuda.current_stream(self.device)
        out = [per_dev[0]]
        peer = 0
        for d in range(1, len(per_dev)):
            t = per_dev[d]
            if self.devices[d] == self.device:
                ev = torch.cuda.Event()
                ev.record(self._computes[d])
                cur.wait_event(ev)
                t.record_stream(cur)
                out.append(t)
            else:
                with self._stream(d):
                    out.append(t.to(self.device, non_blocking=True))
                peer += t.nbytes
        self.spans.count("peer_bytes", peer)
        return out

    def _to_host(self, probs: torch.Tensor):
        """Queue a device result's copy into a pinned buffer (done at the
        flush's event); returns (buffer or None, host tensor).  CPU
        results pass through."""
        if self.device.type != "cuda":
            return None, probs
        buf, host = self.pinned.take(probs.shape, probs.dtype)
        host.copy_(probs, non_blocking=True)
        return buf, host

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
        self.buffers += 1
        self._seg_size = cap // self.H2D_SEGMENTS
        #: the buffer's finished segments on the device, (tensor, event)
        self._segments: list = []
        self._reset_flush_state()

    def _reset_flush_state(self):
        """Start a new flush within the current buffer: pending reads and
        site lists reset; the packed planes and shipped segments persist
        (fill-through)."""
        self._last_flush_fill = self._fill
        self._pending: list[_PendingRead] = []
        self._sites = {ctx: {"centers": [], "strands": [], "rstart": [],
                             "rend": []}
                       for ctx in self.cfg.contexts}

    def add_read(self, rec: BamRecord, out: list, decoded=_UNSET):
        """Queue one record; finished records go to `out` (sync mode) or
        the sink (async mode) in input order.  `decoded` optionally carries
        the (read, site-scan) pair a _DecodePrefetcher worker computed."""
        self.stats["reads"] += 1
        self.stats["bases"] += rec.l_seq
        if rec.l_seq < self.cfg.min_read_size:
            self._pending.append(_PendingRead(rec))
            return
        found = None
        if decoded is _UNSET:
            with self.spans.span("decode", keep=False):
                read = decode_read(rec)
        else:
            read, found = decoded
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
        fb = (self.cfg.flush_bases if self._planned else 0) or cap
        ramp = self.cfg.flush_ramp
        if self._planned and self.flushes < len(ramp):
            fb = min(fb, ramp[self.flushes])
        packed = self._fill - self._last_flush_fill
        if self._fill + read.size > cap - self._margin:
            # buffer exhausted: flush whatever is pending, start a new one
            self.flush(out)
            self._reset_buffer()
        elif packed > 0 and packed + read.size > fb:
            # fill-through flush: keep packing into the same buffer, whose
            # shipped segments the next flushes reuse
            self.flush(out, defer_tail=True)
        with self.spans.span("pack", keep=False):
            start = self._fill
            end = start + read.size
            self._planes[0, start:end] = read.codes
            self._planes[1, start:end] = read.fi
            self._planes[2, start:end] = read.fp
            self._planes[3, start:end] = read.ri
            self._planes[4, start:end] = read.rp
            self._fill = end + self._gap
            # ship the segments this read finished, overlapping the copy
            # with the host's work on the next reads
            self._ship_segments(self._fill // self._seg_size)

        with self.spans.span("sites", keep=False):
            pend = _PendingRead(rec, fwd_seq=read.seq, start=start,
                                extent=end)
            if found is None:
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
        self.stats["called_reads"] += 1
        self._pending.append(pend)

    def _ship_segments(self, n_seg: int):
        """Ship plane segments [len(shipped), n_seg).  A segment ships only
        once every read in it is packed (reads pack forward only), so later
        packing never races its copy."""
        n_seg = min(n_seg, self.H2D_SEGMENTS)
        seg = self._seg_size
        while len(self._segments) < n_seg:
            a = len(self._segments) * seg
            self._segments.append(self._ship(self._planes[:, a:a + seg]))

    # -- flush -------------------------------------------------------------
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

    def flush(self, out: list, defer_tail: bool = False):
        """Snapshot the pending reads and their sites and hand them down
        the pipeline (async mode), or dispatch them here and resolve the
        previous flush (sync mode).

        The payload is the buffer's shipped segments, plus the segment in
        progress unless a tail is carried.  `defer_tail` (fill-through
        flushes, which only the planned paths' schedule makes; with
        segment_align): cut the flush at the last shipped segment - reads
        whose data reaches past it carry over to the next flush - so the
        payload is the segments already on the device.  Until one packed
        read clears a segment boundary the flush waits for the next read;
        a flush of the ramp does not wait, and ships the segment in
        progress instead (the JAX engine skipped its first ramp step
        whenever that step was below one segment).

        Flushes are numbered in order (`seq`); the `flush` span runs from
        the cut to the hand-off, `flush_wait` inside it while the dispatch
        queue is full.  A call that waits for the next read counts in no
        span."""
        with self.spans.span("flush") as span:
            carry = None
            if (defer_tail and self.cfg.segment_align
                    and self._fill > self._last_flush_fill):
                carry = self._split_tail()
                if carry is None and \
                        self.flushes >= len(self.cfg.flush_ramp):
                    span.drop()
                    return
            seq, self._queued = self._queued, self._queued + 1
            span.flush = seq
            work = None
            if any(p.fwd_seq is not None for p in self._pending):
                self._ship_segments(self._fill // self._seg_size)
                payload = list(self._segments)
                k = len(payload)
                if carry is None and k < self.H2D_SEGMENTS and \
                        self._fill > k * self._seg_size:
                    # the segment in progress, shipped for this flush only:
                    # it ships again, whole, when its last read is packed
                    a = k * self._seg_size
                    payload.append(self._ship(
                        self._planes[:, a:a + self._seg_size]))
                work = (payload, self._sites)
                self.flushes += 1
            pending = self._pending
            self._reset_flush_state()
            if carry is not None:
                self._restore_tail(carry)

            if self._async_active():
                self._ensure_pipeline()
                self._check_exc()
                self.spans.stamp("flush", seq)
                with self.spans.wait("flush_wait"):
                    self._dispatch_q.put((seq, pending, work))
                return
        futures = None
        if work is not None:
            with self._on_device():
                futures = self._dispatch_work(work, seq)
        prev, self._inflight = self._inflight, (seq, pending, futures)
        if prev is not None:
            self._emit(prev, out)

    def _split_tail(self):
        """Segment-aligned fill-through cut (see flush).

        Reads pack at increasing offsets, so the pends whose packed data
        reaches past the last shipped segment (extent > boundary) are a
        suffix of the pending list; their per-context site arrays are the
        trailing entries of the flush's site lists (one array per packed
        read per context).  A kept read's windows may still reach kmer//2
        past its extent, but only into the inter-read gap, whose features
        are zero - as the unshipped tail of the table is.  Splits both in
        place and returns the carried (pends, site arrays) for
        _restore_tail; ([], None) when nothing defers; None when no packed
        read would be kept."""
        seg = self._seg_size
        boundary = min(self._fill // seg, self.H2D_SEGMENTS) * seg
        cut = None
        for i, p in enumerate(self._pending):
            if p.fwd_seq is not None and p.extent > boundary:
                cut = i
                break
        if cut is None:
            return ([], None)
        kept = self._pending[:cut]
        if not any(p.fwd_seq is not None for p in kept):
            return None
        deferred = self._pending[cut:]
        n_def = sum(1 for p in deferred if p.fwd_seq is not None)
        arrays = {}
        for ctx in self.cfg.contexts:
            s = self._sites[ctx]
            arrays[ctx] = {}
            for k in s:
                keep_n = len(s[k]) - n_def
                arrays[ctx][k] = s[k][keep_n:]
                del s[k][keep_n:]
        self._pending = kept
        return (deferred, arrays)

    def _restore_tail(self, carry):
        """Re-seed the new flush with the reads _split_tail carried: their
        site arrays lead its lists (same buffer, so offsets stay valid and
        position-sorted), each pend's site_slices re-based to the new
        cumulative offsets, and the flush's packed count starts at the
        first carried read, so the next fill-through trigger counts the
        carried bases."""
        pends, arrays = carry
        if not pends:
            return
        for ctx in self.cfg.contexts:
            s = self._sites[ctx]
            for k in s:
                s[k].extend(arrays[ctx][k])
        cum = {ctx: 0 for ctx in self.cfg.contexts}
        for p in pends:
            if p.fwd_seq is None:
                continue
            for ctx in self.cfg.contexts:
                lo, hi, offs, strands = p.site_slices[ctx]
                p.site_slices[ctx] = (cum[ctx], cum[ctx] + hi - lo, offs,
                                      strands)
                cum[ctx] += hi - lo
        self._pending.extend(pends)
        self._last_flush_fill = min(p.start for p in pends
                                    if p.fwd_seq is not None)
        self.carried += sum(p.fwd_seq is not None for p in pends)

    # -- dispatch ----------------------------------------------------------
    def _dispatch_work(self, work, flush: int):
        """Featurize flush `flush`'s plane segments into each device's
        table, in the table's layout, once each segment's copy is done,
        then plan and launch every context's batches on the current stream
        (inside _on_device); returns (futures, event): the event marks the
        flush's results in host memory."""
        with self.spans.span("dispatch", flush):
            segments, sites = work
            hold: list = []
            # every flush rewrites each device's persistent table, which
            # its programs read, on the device's stream after the previous
            # flush's batches that read it
            for d in range(len(self.devices)):
                with self._stream(d):
                    segs = []
                    for t, ev in (seg[d] for seg in segments):
                        if ev is not None:
                            stream = torch.cuda.current_stream(
                                self.devices[d])
                            stream.wait_event(ev)
                            t.record_stream(stream)
                        segs.append(t)
                    self._featurize(segs, self.cfg.buffer_bases,
                                    out=self._tables[d])
            per_ctx = {ctx: self._call_context(ctx, sites[ctx], hold)
                       for ctx in self.cfg.contexts}
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event(blocking=True)
                done.record(torch.cuda.current_stream(self.device))
                for buf in hold:
                    self.pinned.give(buf, done)
        return per_ctx, done

    def _call_context(self, ctx: str, s: dict, hold: list):
        """Plan groups of GROUP position-sorted sites whose windows fit one
        block and call them over the devices' persistent tables (slice and
        folded: _call_context_batched); returns (n_sites, streams, order).

        Reverse-strand sites run as a separate stream through the kernels'
        reverse mode, so no per-site strand vector reaches the device.  The
        gather and fused paths share this plan.  Data-parallel, each batch
        holds site_batch // GROUP groups per device, split over the devices
        in group order: every device calls batches of the single-device
        shape, with its own models and table on its own stream (the JAX
        engine's call_sites_pallas_dp), and the results come back to the
        primary device in group order (_run_programs)."""
        centers = (np.concatenate(s["centers"]) if s["centers"]
                   else np.empty(0, np.int32))
        n = len(centers)
        if n == 0:
            return n, None, None
        if not self._planned:
            return self._call_context_batched(ctx, s, centers, hold)
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
        ndev = len(self.devices)
        ngrp = self.cfg.site_batch // GROUP
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
            step = ngrp * ndev
            nb = sum(self._decompose_batches((ng + step - 1) // step))
            pad_g = nb * step - ng
            if pad_g:
                # padded groups read the buffer-start margin (base 0): zero
                # windows whose prob slots are dropped at resolve
                b128 = np.concatenate([b128, np.zeros(pad_g, np.int32)])
                rels = np.concatenate([rels, np.zeros((pad_g, GROUP), np.int32)])
            # batch b's groups [b*step, (b+1)*step) go to the devices in
            # blocks of ngrp; a batch's plan row is its rels, then its
            # bases (programs.plan_views)
            plan = np.concatenate(
                [rels.astype(np.int32).reshape(nb, ndev, ngrp * GROUP),
                 b128.astype(np.int32).reshape(nb, ndev, ngrp)], axis=2)
            probs = self._run_programs(
                (ctx, rev), [plan[:, d] for d in range(ndev)], hold)
            results.append((self._to_host(probs), idx, sel, ng))
        return n, results, order

    def _call_context_batched(self, ctx: str, s: dict, centers: np.ndarray,
                              hold: list):
        """The slice/folded paths: every site in input order, padded with
        center-0 sites (empty read bounds, so zero windows whose probs are
        dropped at resolve) to the batch decomposition of one device (the
        JAX engine's bucket chunks of call_sites_batched) or to one bucket
        over a device list (call_sites_grid), as (nb, site_batch) grids
        split on the second axis into one contiguous share per device:
        device d's (nb, share) centers, strands, read bounds are its int32
        plan rows (programs.site_views), called through _run_programs.
        Returns (n, streams, order) in _resolve's form, one stream in site
        order."""
        n = len(centers)
        bs = self.cfg.site_batch
        nb = (n + bs - 1) // bs
        nb = (self._bucket_batches(nb) if len(self.devices) > 1
              else sum(self._decompose_batches(nb)))
        pad = nb * bs - n
        grids = [np.concatenate([a, np.zeros(pad, a.dtype)])
                 .astype(np.int32).reshape(nb, bs) for a in (
            centers, np.concatenate(s["strands"]),
            np.concatenate(s["rstart"]), np.concatenate(s["rend"]))]
        cuts = np.cumsum(self._widths)[:-1]
        shares = zip(*(np.split(g, cuts, axis=1) for g in grids))
        probs = self._run_programs(
            ctx, [np.concatenate(share, axis=1) for share in shares], hold)
        return n, [(self._to_host(probs), None, None, n)], None

    def _run_programs(self, key, plans: list, hold: list) -> torch.Tensor:
        """Call each device's (nb, row) int32 plan rows through its program
        of `key` ((ctx, rev) on the planned paths, ctx on slice and
        folded): the device's rows in one copy, then per batch its row into
        the program, a replay and the program's output, _widths[d] sites,
        into the flush's result, all on the device's stream.  Returns the
        (nb * sum(_widths),) u8 probs on the primary device, batch by batch
        in device order.  Counts the programs' calls (`batches`) and the
        site slots they compute, padding included (`slots`)."""
        nb = len(plans[0])
        per_dev = []
        for d, (plan, width) in enumerate(zip(plans, self._widths)):
            with self._stream(d):
                rows = self._h2d(plan, hold, d)
                res = torch.empty(nb * width, dtype=torch.uint8,
                                  device=self.devices[d])
                program = self._programs[d][key]
                for b in range(nb):
                    program(rows[b], res[b * width:(b + 1) * width])
                per_dev.append(res)
        self.spans.count("batches", nb * len(plans))
        self.spans.count("slots", nb * sum(self._widths))
        if len(per_dev) == 1:
            return per_dev[0]
        with self.spans.span("to_primary"):
            per_dev = self._to_primary(per_dev)
            return torch.cat([p.view(nb, -1) for p in per_dev],
                             dim=1).reshape(-1)

    # -- resolve and emit --------------------------------------------------
    def _emit(self, inflight, out: list):
        seq, pending, futures = inflight
        self._build_emit(pending, self._resolve(futures, seq), out, seq)

    def _resolve(self, futures, flush: int):
        """Wait for flush `flush`'s device results (`resolve_wait`);
        scatter each stream's slots back to site order (padded slots
        duplicate a real site -> same value), then unsort.  The pinned
        result buffers go back to the pool once read."""
        with self.spans.span("resolve", flush):
            probs = {ctx: np.empty(0, np.uint8)
                     for ctx in self.cfg.contexts}
            if futures is not None:
                per_ctx, done = futures
                if done is not None:
                    with self.spans.wait("resolve_wait"):
                        done.synchronize()
                for ctx, (n, streams, order) in per_ctx.items():
                    if streams is None:
                        continue
                    sorted_probs = np.empty(n, np.uint8)
                    for (buf, part), idx, sel, ng in streams:
                        flat = part.numpy()
                        m = n if sel is None else len(sel)
                        if idx is None:
                            sp = flat[:m]
                        else:
                            sp = np.empty(m, np.uint8)
                            sp[idx.ravel()] = flat[:ng * idx.shape[1]]
                        if sel is None:
                            sorted_probs[:] = sp
                        else:
                            sorted_probs[sel] = sp
                        if buf is not None:
                            self.pinned.give(buf)
                    if order is None:
                        probs[ctx] = sorted_probs
                    else:
                        unsorted = np.empty(n, np.uint8)
                        unsorted[order] = sorted_probs
                        probs[ctx] = unsorted
        return probs

    def _build_emit(self, pending, probs, out: list, flush: int):
        """Flush `flush`'s MM/ML tag construction + ordered record
        emission: one native call builds every called read's tags
        (`_flush_tags`), or, where that builder is unavailable, each read
        builds its own (`_read_tags`).  Both give the same bytes."""
        with self.spans.span("mmbuild", flush):
            called = [p for p in pending if p.fwd_seq is not None]
            tags = self._flush_tags(called, probs) if called else None
            if tags is None:
                for pend in called:
                    self._read_tags(pend, probs)
            else:
                for pend, (mm, ml) in zip(called, tags):
                    strip_mod_tags(pend.rec, self.cfg.keep_kinetics)
                    if mm is not None:
                        set_mod_tags(pend.rec, mm, ml)
            out.extend(pend.rec for pend in pending)

    def _flush_tags(self, called: list, probs: dict):
        """Every called read's (MM text, ML bytes) in one native call
        (io/native.py `mm_flush`), (None, None) for a read without sites;
        None if the builder is unavailable.  Counts the reads
        (`mmbuild_native`) and the calls (`mmbuild_calls`)."""
        entries = [(ctx, sl) for p in called
                   for ctx, sl in p.site_slices.items()]
        base, at = {}, 0
        for ctx, pv in probs.items():
            base[ctx] = at
            at += len(pv)
        n_ctx = len(entries) // len(called)
        counts = np.array([hi - lo for _, (lo, hi, _, _) in entries],
                          np.int64).reshape(len(called), n_ctx)
        prob_at = np.array([base[ctx] + lo for ctx, (lo, _, _, _) in entries],
                           np.int64).reshape(len(called), n_ctx)
        seq_off = np.zeros(len(called) + 1, np.int64)
        np.cumsum([len(p.fwd_seq) for p in called], out=seq_off[1:])
        built = native.mm_flush(
            np.concatenate([p.fwd_seq for p in called]), seq_off,
            np.concatenate([sl[2] for _, sl in entries], dtype=np.int64),
            np.concatenate([sl[3] for _, sl in entries], dtype=np.uint8),
            counts, prob_at, np.concatenate(list(probs.values())))
        if built is None:
            return None
        self.spans.count("mmbuild_calls")
        self.spans.count("mmbuild_native", len(called))
        mm, mm_off, ml, ml_off = built
        return [(mm[mm_off[i]:mm_off[i + 1]].decode(),
                 ml[ml_off[i]:ml_off[i + 1]])
                if ml_off[i + 1] > ml_off[i] else (None, None)
                for i in range(len(called))]

    def _read_tags(self, pend: _PendingRead, probs: dict):
        """One read's MM/ML/MN (build_mod_tags): the fallback of
        `_flush_tags`."""
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
        build_mod_tags(pend.rec, pend.fwd_seq, fq[fo], fp[fo], rq[ro],
                       rp[ro], keep_kinetics=self.cfg.keep_kinetics)

    # -- async pipeline ----------------------------------------------------
    def _async_active(self) -> bool:
        return self.cfg.async_emit and self.sink is not None

    def _fail(self, e: BaseException):
        with self._exc_lock:
            if self._exc is None:
                self._exc = e

    def _check_exc(self):
        if self._exc is not None:
            raise self._exc

    def _ensure_pipeline(self):
        if self._threads:
            return
        depth = self.cfg.queue_depth
        self._dispatch_q = queue.Queue(maxsize=depth)
        self._resolve_q = queue.Queue(maxsize=depth)
        self._emit_q = queue.Queue(maxsize=depth)
        self._threads = [
            threading.Thread(target=fn, name=f"hifimeth-{name}", daemon=True)
            for fn, name in ((self._dispatch_worker, "dispatch"),
                             (self._resolve_worker, "resolve"),
                             (self._emit_worker, "emit"))]
        for t in self._threads:
            t.start()

    def _dispatch_worker(self):
        """Stage 2: featurize + plan + launch on the compute stream."""
        spans = self.spans
        with self._on_device():
            while True:
                with spans.wait("dispatch_idle"):
                    item = self._dispatch_q.get()
                if item is None:
                    self._resolve_q.put(None)
                    return
                seq, pending, work = item
                futures = None
                spans.stamp("dispatch0", seq)
                try:
                    if self._exc is None and work is not None:
                        futures = self._dispatch_work(work, seq)
                except BaseException as e:  # noqa: BLE001 - raised on the caller
                    self._fail(e)
                spans.stamp("dispatch1", seq)
                self._resolve_q.put((seq, pending, futures))

    def _resolve_worker(self):
        """Stage 3: wait for the flush's event, unsort."""
        spans = self.spans
        while True:
            with spans.wait("resolve_idle"):
                item = self._resolve_q.get()
            if item is None:
                self._emit_q.put(None)
                return
            seq, pending, futures = item
            probs = None
            spans.stamp("resolve0", seq)
            try:
                if self._exc is None:
                    probs = self._resolve(futures, seq)
            except BaseException as e:  # noqa: BLE001 - raised on the caller
                self._fail(e)
            spans.stamp("resolve1", seq)
            self._emit_q.put((seq, pending, probs))

    def _emit_worker(self):
        """Stage 4: MM/ML build + the ordered record sink (`write`)."""
        spans = self.spans
        while True:
            with spans.wait("emit_idle"):
                item = self._emit_q.get()
            if item is None:
                return
            seq, pending, probs = item
            spans.stamp("emit0", seq)
            try:
                if self._exc is None and probs is not None:
                    local: list = []
                    self._build_emit(pending, probs, local, seq)
                    with spans.span("write", seq):
                        for rec in local:
                            self.sink(rec)
            except BaseException as e:  # noqa: BLE001 - raised on the caller
                self._fail(e)
            spans.stamp("emit1", seq)

    def finalize(self, out: list):
        """Flush any packed reads and drain the pipeline (or resolve the
        flush in flight); raises a worker's exception."""
        self.flush(out)
        if self._threads:
            self.close()
            self._check_exc()
            return
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._emit(prev, out)

    def close(self):
        """Stop the worker threads after the flushes already queued and
        join them.  Workers skip their work once one has failed, so the
        queues always drain."""
        if not self._threads:
            return
        self._dispatch_q.put(None)
        for t in self._threads:
            t.join()
        self._threads = []

    def release(self):
        """On the card, once the engine's runs are done: drop its programs
        (their graphs) and tables, on every path, then empty the
        allocator's cache.  A dead engine's graph pool and the blocks
        cached on its streams are reused by no later engine, so without
        this a process that runs `call` again and again keeps a few GB
        more reserved each run (scripts/probe_graph_memory.py)."""
        if self.device.type != "cuda":
            return
        for d in dict.fromkeys(self.devices):
            torch.cuda.synchronize(d)
        self._programs = self._tables = None
        torch.cuda.empty_cache()

    @property
    def timers(self) -> dict:
        """The spans' totals, one flat dict: seconds per stage and wait
        (SECONDS, and with cfg.trace `<name>_cpu` thread CPU seconds) and
        the counts (COUNTS), each key of SECONDS and COUNTS present; over a
        device list also the exchange's `to_primary` seconds and its
        `peer_bytes` and `ship_bytes` counts."""
        out = {**dict.fromkeys(self.SECONDS, 0.0),
               **dict.fromkeys(self.COUNTS, 0)}
        out.update(sorted(self.spans.totals().items()))
        return out

    def log_timers(self):
        """The timers on stderr; with cfg.trace first one line per flush,
        `[trace flush N] flush@t dispatch0@t ...`, in seconds from the
        first event (the JAX engine's format)."""
        if self._trace_events:
            t0 = min(t for _, _, t in self._trace_events)
            rows: dict = {}
            for seq, stage, t in self._trace_events:
                rows.setdefault(seq, []).append(f"{stage}@{t - t0:.3f}")
            for seq in sorted(rows):
                print(f"[trace flush {seq}] " + " ".join(rows[seq]),
                      file=sys.stderr)
            self._trace_events.clear()
        parts = ", ".join(f"{k}={v}" if isinstance(v, int) else
                          f"{k}={v:.2f}s" for k, v in self.timers.items())
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
             cmdline: str = f"{PROG} call", shard: ShardSpec | None = None,
             devices=None) -> dict:
    """End-to-end `call`: returns the stats dict.

    With a multi-process ShardSpec this process calls only its round-robin
    read blocks and writes them, in order, to `out_bam.shard%04d` (merge
    the shards with `merge-shards`).  `devices`: see CallEngine."""
    from .. import __version__

    shard = shard or ShardSpec()
    engine = CallEngine(cfg, devices=devices)
    reader = BamReader(in_bam, threads=cfg.io_threads)
    header = reader.header.with_pg_line(PROG, __version__, cmdline)
    writer = BamWriter(shard_path(out_bam, shard), header,
                       threads=cfg.io_threads)
    # async mode: the emit worker writes the records
    engine.sink = writer.write
    n_workers = resolve_decode_workers(cfg.decode_workers)
    prefetch = None
    try:
        records = (rec for _, rec in sharded_read_stream(reader, shard))
        if n_workers > 0:
            prefetch = _DecodePrefetcher(records, cfg.min_read_size,
                                         engine.spans, workers=n_workers)
            pairs = iter(prefetch)
        else:
            pairs = ((rec, _UNSET) for rec in records)
        done: list[BamRecord] = []

        def write_done():
            # sync mode: the records a flush finished (async mode: none,
            # the emit worker writes them)
            if done:
                with engine.spans.span("write"):
                    for r in done:
                        writer.write(r)
                done.clear()

        next_log = cfg.read_batch_size
        batch_snap = dict(engine.stats)
        for rec, decoded in pairs:
            engine.add_read(rec, done, decoded=decoded)
            if engine.stats["reads"] >= next_log:
                # per-batch stats in the reference's format
                # (mod_main.cpp:364-379)
                _print_stats("######## Batch stats:", cfg.contexts,
                             {k: engine.stats[k] - batch_snap[k]
                              for k in engine.stats})
                batch_snap = dict(engine.stats)
                log("%10d reads processed", engine.stats["reads"])
                next_log += cfg.read_batch_size
            write_done()
        engine.finalize(done)
        write_done()
    finally:
        if prefetch is not None:
            prefetch.close()
        engine.close()
        writer.close()
        reader.close()
    engine.release()

    s = engine.stats
    engine.log_timers()
    log("Done.")
    _print_stats("******** Final stats:", cfg.contexts, s)
    if cfg.stats_json:
        import json
        # with trace on, "spans" holds the flush-level records on the
        # perf_counter clock (engine/spans.py)
        extra = {"spans": engine.spans.records()} if cfg.trace else {}
        with open(cfg.stats_json, "w") as f:
            json.dump({"stats": {k: int(v) for k, v in s.items()},
                       "timers": engine.timers,
                       "schedule": {"flushes": engine.flushes,
                                    "buffers": engine.buffers,
                                    "carried_reads": engine.carried},
                       "config": {"contexts": list(cfg.contexts),
                                  "compute_dtype": engine.cfg.compute_dtype,
                                  "site_batch": cfg.site_batch,
                                  "gather_impl": engine.cfg.gather_impl,
                                  "async_emit": engine.cfg.async_emit,
                                  "decode_workers": n_workers,
                                  "device": str(engine.device),
                                  "devices": [str(d) for d in engine.devices],
                                  "shard": [shard.process_id,
                                            shard.num_processes]},
                       **extra},
                      f, indent=1)
    return s
