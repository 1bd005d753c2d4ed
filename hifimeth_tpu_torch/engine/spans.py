"""The call engine's one recorder of where its threads spend their time.

Three parts, all on the `time.perf_counter` clock:

 - spans: `span(name)` is a context manager around a stage's work,
   `wait(name)` the same around a blocking call (a queue's put or get,
   the host waiting for the card).  Each adds its wall seconds to a total
   of its name.  Totals are kept per thread, without a lock, and merged
   when read.  With `trace` on every span and wait also takes the
   thread's CPU time (`time.thread_time`), summed under `<name>_cpu`, and
   a span opened with `keep` (the default) leaves a record: name, flush
   number, thread name, start, end, CPU seconds, the name of the span it
   opened inside and whether it is a wait.  A span given no flush number
   takes the one of the span it opened inside, so the spans of one flush
   share its number.  Per-read spans pass keep=False: they count in the
   totals only.  `drop()` on an open span leaves it out of the totals and
   records when it closes.
 - counters: `count(name, n)`.
 - stamps: `stamp(stage, flush)` appends (flush, stage, time) to
   `stamps` with `trace` on (the engine's per-flush pipeline timeline).

`totals()` returns the seconds and counts as one flat dict; `records()`
the kept records, in order of start.  With `trace` off nothing but the
totals and counts is made: no CPU clock is read and no record is kept.
"""
from __future__ import annotations

import threading
from time import perf_counter, thread_time


class _Thread:
    """One thread's totals, counts, kept records and open spans."""

    __slots__ = ("name", "totals", "records", "open")

    def __init__(self, name: str):
        self.name = name
        self.totals: dict = {}
        self.records: list = []
        self.open: list = []


class _Span:
    __slots__ = ("_th", "_name", "flush", "_cpu", "_keep", "_wait", "_t0",
                 "_c0", "_parent", "_drop")

    def __init__(self, th: _Thread, name: str, flush, cpu: bool, keep: bool,
                 wait: bool):
        self._th = th
        self._name = name
        self.flush = flush
        self._cpu = cpu
        self._keep = keep
        self._wait = wait
        self._drop = False

    def drop(self) -> None:
        """Count this span nowhere (module notes)."""
        self._drop = True

    def __enter__(self):
        if self._keep:
            opened = self._th.open
            self._parent = opened[-1] if opened else None
            if self.flush is None and self._parent is not None:
                self.flush = self._parent.flush
            opened.append(self)
        if self._cpu:
            self._c0 = thread_time()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter()
        if self._drop:
            if self._keep:
                self._th.open.pop()
            return False
        tot = self._th.totals
        name = self._name
        tot[name] = tot.get(name, 0.0) + (t1 - self._t0)
        if self._cpu:
            cpu = thread_time() - self._c0
            key = name + "_cpu"
            tot[key] = tot.get(key, 0.0) + cpu
        if self._keep:
            self._th.open.pop()
            parent = self._parent
            self._th.records.append(
                (name, self.flush, self._th.name, self._t0, t1, cpu,
                 None if parent is None else parent._name, self._wait))
        return False


class SpanRecorder:
    """Spans, waits, counters and stamps of one engine (module notes)."""

    def __init__(self, trace: bool = False):
        self.trace = trace
        #: (flush, stage, perf_counter time) per stamp, with trace on
        self.stamps: list = []
        self._local = threading.local()
        self._threads: list = []
        self._lock = threading.Lock()

    def _thread(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            th = _Thread(threading.current_thread().name)
            with self._lock:
                self._threads.append(th)
            self._local.th = th
        return th

    def span(self, name: str, flush=None, keep: bool = True) -> _Span:
        """A span of work (module notes)."""
        return _Span(self._thread(), name, flush, self.trace,
                     self.trace and keep, False)

    def wait(self, name: str, flush=None, keep: bool = True) -> _Span:
        """A span around one blocking call: its seconds go under a name of
        their own, and its record says it is a wait, so a stage's waiting
        is told apart from its work."""
        return _Span(self._thread(), name, flush, self.trace,
                     self.trace and keep, True)

    def count(self, name: str, n: int = 1) -> None:
        tot = self._thread().totals
        tot[name] = tot.get(name, 0) + n

    def stamp(self, stage: str, flush: int) -> None:
        if self.trace:
            self.stamps.append((flush, stage, perf_counter()))

    def _each(self):
        with self._lock:
            return list(self._threads)

    def totals(self) -> dict:
        """Every thread's seconds (floats) and counts (ints), summed by
        name."""
        out: dict = {}
        for th in self._each():
            # dict() copies in one step; a thread may still be adding
            for k, v in dict(th.totals).items():
                out[k] = out.get(k, 0) + v
        return out

    def records(self) -> list:
        """The kept records as dicts, in order of start."""
        rows = [r for th in self._each() for r in list(th.records)]
        rows.sort(key=lambda r: r[3])
        keys = ("name", "flush", "thread", "start", "end", "cpu", "parent",
                "wait")
        return [dict(zip(keys, r)) for r in rows]
