"""The call engine's span recorder (engine/spans.py) on the CPU.

What is held:
 - totals from many threads merge, counts exactly, under a short switch
   interval;
 - records keep their parent's name and inherit its flush number; per-read
   spans (keep=False) leave none; a wait is marked as one; a dropped span
   counts nowhere;
 - the `flush` span holds the cut of a fill-through flush;
 - in a run: every key the timers always had is there with the new ones,
   each wait is no more than its stage, each `_cpu` no more than its wall
   time plus clock slack, and the flush-level records of one flush share
   its number;
 - with trace off no record is kept and no CPU clock is read, and the
   stats JSON holds `spans` only with trace on;
 - `slots` and `batches` equal what the programs were called with (a spy
   on BatchProgram.__call__), on pallas, fused and slice, on one device and
   over ["cpu", "cpu"];
 - the pinned pool counts each buffer it makes, not those it reuses.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hifimeth_tpu_torch.engine import call as engine_mod
from hifimeth_tpu_torch.engine import spans as spans_mod
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.engine.programs import BatchProgram
from hifimeth_tpu_torch.engine.spans import SpanRecorder

from util import make_kinetics_read, write_bam

#: a small forced schedule (8 Ki buffer, 1 Ki flushes, 64-site batches)
FORCED = dict(buffer_bases=1 << 13, flush_bases=1024, site_batch=64,
              min_read_size=250, contexts=("CpG", "CHH"), device="cpu")
#: the timers' keys before the recorder
OLD_KEYS = ("decode", "sites", "pack", "flush", "dispatch", "resolve",
            "mmbuild", "capture")
#: the spans whose thread CPU seconds `_cpu` keys hold with trace on
WORK = ("decode", "sites", "pack", "dispatch", "resolve", "mmbuild", "write")
#: seconds by which a CPU reading may pass its wall reading (the clocks
#: are read in turn, the CPU clock outside the wall clock)
SLACK = 0.01


def _bam(tmp_path, seed=5, n=12):
    rng = np.random.default_rng(seed)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(300, 1500)),
                               flag=16 if i % 3 == 0 else 4)
            for i in range(n)]
    path = str(tmp_path / "in.bam")
    write_bam(path, recs)
    return path


def _run(tmp_path, name="out", devices=None, **kw):
    stats = str(tmp_path / f"{name}.json")
    out = run_call(_bam(tmp_path), str(tmp_path / f"{name}.bam"),
                   CallConfig(**{**FORCED, **kw}, stats_json=stats),
                   devices=devices)
    with open(stats) as f:
        return out, json.load(f)


def test_totals_merge_across_threads():
    rec = SpanRecorder()
    n_threads, n = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                rec.count("items")
                with rec.span("stage", keep=False):
                    rec.count("inner", 2)
            with rec.wait("blocked"):
                time.sleep(0.01)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tot = rec.totals()
    assert tot["items"] == n_threads * n
    assert tot["inner"] == 2 * n_threads * n
    assert isinstance(tot["items"], int)
    assert tot["stage"] > 0
    assert tot["blocked"] >= n_threads * 0.01
    assert "stage_cpu" not in tot and rec.records() == []


def test_records_keep_parent_and_flush():
    rec = SpanRecorder(trace=True)
    with rec.span("flush", 3):
        with rec.span("pack", keep=False):
            pass
        with rec.wait("flush_wait"):
            time.sleep(0.002)
    with rec.span("resolve", 4):
        with rec.wait("resolve_wait"):
            pass
    with rec.span("write"):
        pass
    rows = {r["name"]: r for r in rec.records()}
    assert set(rows) == {"flush", "flush_wait", "resolve", "resolve_wait",
                         "write"}
    assert rows["flush_wait"]["parent"] == "flush"
    assert rows["flush_wait"]["flush"] == 3 and rows["flush"]["flush"] == 3
    assert rows["resolve_wait"]["parent"] == "resolve"
    assert rows["resolve_wait"]["flush"] == 4
    assert rows["write"]["parent"] is None and rows["write"]["flush"] is None
    assert [r["wait"] for r in rec.records()] == [False, True, False, True,
                                                  False]
    assert rows["flush"]["start"] <= rows["flush_wait"]["start"] <= \
        rows["flush_wait"]["end"] <= rows["flush"]["end"]
    for r in rows.values():
        assert r["thread"] == threading.current_thread().name
        assert 0 <= r["cpu"] <= r["end"] - r["start"] + SLACK
    tot = rec.totals()
    assert "pack_cpu" in tot and tot["flush"] >= tot["flush_wait"] >= 0.002


def test_dropped_span_counts_nowhere():
    rec = SpanRecorder(trace=True)
    with rec.span("flush") as span:
        with rec.wait("flush_wait"):
            pass
        span.drop()
    with rec.span("flush", 1):
        pass
    rows = rec.records()
    assert [(r["name"], r["parent"]) for r in rows] == [
        ("flush_wait", "flush"), ("flush", None)]
    assert rec.totals()["flush"] == rows[1]["end"] - rows[1]["start"]


def test_flush_span_holds_the_cut(tmp_path, monkeypatch):
    real = CallEngine._split_tail
    shipped = []

    def timed(self):
        t0 = time.perf_counter()
        carry = real(self)
        if carry is not None:
            shipped.append(t0)
        return carry
    monkeypatch.setattr(CallEngine, "_split_tail", timed)
    _, js = _run(tmp_path, trace=True)
    flushes = [(r["start"], r["end"]) for r in js["spans"]
               if r["name"] == "flush"]
    assert shipped
    for t0 in shipped:
        assert any(a <= t0 <= b for a, b in flushes), t0


@pytest.mark.parametrize("async_emit,decode_workers",
                         [(True, 2), (True, 0), (False, 2)])
def test_run_timers(tmp_path, capsys, async_emit, decode_workers):
    stats, js = _run(tmp_path, trace=True, async_emit=async_emit,
                     decode_workers=decode_workers)
    t = js["timers"]
    for k in OLD_KEYS + WORK:
        assert t[k] > 0, k
    assert set(CallEngine.SECONDS + CallEngine.COUNTS) <= set(t)
    assert 0 <= t["flush_wait"] <= t["flush"]
    # the CPU's results need no wait: resolve_wait reads 0 here
    assert 0 <= t["resolve_wait"] <= t["resolve"]
    for k in WORK:
        assert 0 <= t[k + "_cpu"] <= t[k] + SLACK, k
    if decode_workers:
        assert t["decode_wait"] > 0
    else:
        assert t["decode_wait"] == 0
    if not async_emit:
        assert t["dispatch_idle"] == t["resolve_idle"] == t["emit_idle"] \
            == t["flush_wait"] == 0
    assert t["pinned_new"] == 0            # no pinned memory on the CPU
    assert 0 < sum(stats[c] for c in FORCED["contexts"]) <= t["slots"]

    flushes = js["schedule"]["flushes"]
    by_flush: dict = {}
    for r in js["spans"]:
        assert 0 <= r["cpu"] <= r["end"] - r["start"] + SLACK
        if r["name"] in ("flush_wait", "resolve_wait"):
            assert r["parent"] == r["name"][:-len("_wait")]
        if r["flush"] is not None:
            by_flush.setdefault(r["flush"], set()).add(r["name"])
    stages = {"flush", "dispatch", "resolve", "mmbuild"} | (
        {"write", "flush_wait"} if async_emit else set())
    called = [k for k, names in by_flush.items() if "dispatch" in names]
    assert len(called) == flushes > 1
    for k in called:
        assert stages <= by_flush[k], (k, by_flush[k])
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("[engine timers]")]
    assert len(line) == 1 and f"slots={t['slots']}," in line[0]


def test_trace_off_keeps_no_record_and_reads_no_cpu(tmp_path, monkeypatch):
    reads = []

    def counted():
        reads.append(1)
        return time.thread_time()
    monkeypatch.setattr(spans_mod, "thread_time", counted)
    _, js = _run(tmp_path, "off")
    assert reads == [] and "spans" not in js
    assert not any(k.endswith("_cpu") for k in js["timers"])
    assert set(OLD_KEYS) <= set(js["timers"])
    _, js = _run(tmp_path, "on", trace=True)
    assert reads and js["spans"]


@pytest.mark.parametrize("gather_impl,devices", [
    ("pallas", None), ("fused", None), ("slice", None),
    ("pallas", ["cpu", "cpu"]), ("slice", ["cpu", "cpu"])])
def test_slots_count_the_programs_calls(tmp_path, monkeypatch, gather_impl,
                                        devices):
    calls = []
    real = BatchProgram.__call__

    def spy(self, plan, out):
        calls.append(self.out.numel())
        return real(self, plan, out)
    monkeypatch.setattr(BatchProgram, "__call__", spy)
    kw = dict(gather_impl=gather_impl)
    if gather_impl == "slice":
        kw["buffer_bases"] = 1 << 12      # slice flushes on a full buffer
    if devices:
        kw["data_parallel"] = True
    stats, js = _run(tmp_path, devices=devices, **kw)
    t = js["timers"]
    assert len(calls) == t["batches"] > 0
    assert sum(calls) == t["slots"]
    assert t["slots"] >= sum(stats[c] for c in FORCED["contexts"])


def test_pinned_pool_counts_new_buffers(monkeypatch):
    real = torch.empty

    def unpinned(*args, pin_memory=False, **kw):
        return real(*args, **kw)
    monkeypatch.setattr(engine_mod.torch, "empty", unpinned)
    rec = SpanRecorder()
    pool = engine_mod._PinnedPool(rec)
    buf, view = pool.take((5, 100), torch.uint8)
    assert view.shape == (5, 100) and rec.totals()["pinned_new"] == 1
    pool.give(buf)
    again, _ = pool.take((3, 100), torch.uint8)    # same 4 KiB size: reused
    assert again is buf and rec.totals()["pinned_new"] == 1
    pool.take((5, 100), torch.uint8)                # the one is taken
    assert rec.totals()["pinned_new"] == 2
