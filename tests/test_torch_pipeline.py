"""The port's asynchronous call pipeline on the CPU: decode prefetch,
segment-streamed planes, the segment-aligned flush cut, the flush ramp and
the dispatch/resolve/emit workers.

What is held (the port's counterparts of tests/test_call_e2e.py's pipeline
tests):
 - the async pipeline's records are byte-equal to the sync path's and in
   input order, on every per-site path, for any decode-worker count and
   queue depth;
 - a seeded fuzz of read mixes that forces buffer rollovers, segment cuts
   and carried tails gives byte-equal records to the sync path, to the
   uncut schedule and to the slice path, which has no flush schedule;
 - a worker's exception is raised on the caller's thread and every worker
   thread is joined (each such test runs under its own timeout);
 - the ramp's first step flushes below one segment, and a carried read's
   bases count toward the next flush;
 - on every gather route, one device and two, each flush's planes reach
   the devices only as the segments the packer shipped (`_ship`), which
   cover the flush's reads;
 - against the JAX engine's async run_call (pallas, interpret mode) on the
   same forced schedule, the parity contract holds: MM/MN byte-equal, ML
   within +-1 with at most 5% of ML bytes off (docs/PARITY.md).
Inputs are small (reads of 0.3-1.5 kb, a 8 Ki buffer of 1 Ki segments), so
one run takes well under a second.
"""
import threading

import numpy as np
import pytest

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu_torch.engine import call as engine_mod
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.io.bam import BamReader

from util import make_kinetics_read, write_bam

#: the forced schedule: 8 Ki buffer (1 Ki segments), 1 Ki flushes, 64-site
#: batches, reads from 250 bases called
FORCED = dict(buffer_bases=1 << 13, flush_bases=1024, site_batch=64,
              min_read_size=250, contexts=("CpG", "CHH"), device="cpu")
#: a run's wall-clock limit, seconds, in the error tests
TIMEOUT = 120


def _reads(seed, n=14):
    """Mixed reads: called ones of 300-1500 bases (up to 1.5 segments),
    short and kinetics-less passthroughs, some reverse-flagged."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        kind = rng.integers(0, 10)
        if kind == 0:
            recs.append(make_kinetics_read(rng, f"r{i}", 200))
            continue
        r = make_kinetics_read(rng, f"r{i}", int(rng.integers(300, 1500)),
                               flag=16 if kind == 2 else 4)
        if kind == 1:
            for tag in ("fi", "ri", "fp", "rp"):
                r.del_tag(tag)
        recs.append(r)
    return recs


def _bam(tmp_path, recs, name="in.bam"):
    path = str(tmp_path / name)
    write_bam(path, recs)
    return path


def _records(path):
    return [(r.qname, r.get_tag("MM"), r.get_tag("MN"),
             None if r.get_tag("ML") is None
             else bytes(np.asarray(r.get_tag("ML")[1][1], np.uint8)))
            for r in BamReader(path)]


def _run(tmp_path, bam, name, **kw):
    out = str(tmp_path / f"{name}.bam")
    run_call(bam, out, CallConfig(**{**FORCED, **kw}))
    return _records(out)


def _no_worker_threads():
    return not [t.name for t in threading.enumerate()
                if t.name.startswith("hifimeth-")]


@pytest.mark.parametrize("gather_impl", ["pallas", "fused", "slice"])
def test_async_matches_sync(tmp_path, gather_impl):
    recs = _reads(11)
    bam = _bam(tmp_path, recs)
    a = _run(tmp_path, bam, "async", gather_impl=gather_impl)
    s = _run(tmp_path, bam, "sync", gather_impl=gather_impl,
             async_emit=False)
    assert [r[0] for r in a] == [r.qname for r in recs]
    assert sum(r[1] is not None for r in a) >= 8
    assert a == s


@pytest.mark.parametrize("seed", [3, 29, 61])
def test_segment_cut_fuzz(tmp_path, seed, monkeypatch):
    """Forced rollovers and carried tails: byte-equal to the sync path, to
    the uncut schedule (segment_align=False) and to the slice path."""
    carried = []
    restore = CallEngine._restore_tail

    def counting_restore(self, carry):
        carried.append(len(carry[0]))
        restore(self, carry)

    monkeypatch.setattr(CallEngine, "_restore_tail", counting_restore)
    recs = _reads(seed, n=18)
    bam = _bam(tmp_path, recs)
    a = _run(tmp_path, bam, "async", decode_workers=3)
    assert sum(carried) > 0, "the schedule carried no read"
    s = _run(tmp_path, bam, "sync", async_emit=False)
    uncut = _run(tmp_path, bam, "uncut", segment_align=False)
    sl = _run(tmp_path, bam, "slice", gather_impl="slice")
    assert [r[0] for r in a] == [r.qname for r in recs]
    assert a == s == uncut == sl


def test_decode_workers_same_output_and_order(tmp_path):
    recs = _reads(21)
    bam = _bam(tmp_path, recs)
    outs = [_run(tmp_path, bam, f"w{n}", decode_workers=n) for n in (0, 1, 3)]
    assert [r[0] for r in outs[0]] == [r.qname for r in recs]
    assert outs[0] == outs[1] == outs[2]


def test_queue_depths_same_output(tmp_path):
    bam = _bam(tmp_path, _reads(7))
    assert (_run(tmp_path, bam, "d1", queue_depth=1)
            == _run(tmp_path, bam, "d4", queue_depth=4))
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="queue_depth"):
            CallEngine(CallConfig(device="cpu", queue_depth=bad))


def _raises_in_time(fn):
    """Run fn on a thread; return the exception it raised, failing the test
    if it runs past TIMEOUT or returns normally."""
    box = {}

    def target():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - inspected by the test
            box["exc"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), f"no result within {TIMEOUT} s"
    assert "exc" in box, "no exception raised"
    return box["exc"]


def test_sink_error_raised_on_caller(tmp_path):
    eng = CallEngine(CallConfig(**FORCED))

    def bad_sink(rec):
        raise RuntimeError("sink failed")

    eng.sink = bad_sink

    def feed():
        try:
            done = []
            for rec in BamReader(_bam(tmp_path, _reads(12))):
                eng.add_read(rec, done)
            eng.finalize(done)
        finally:
            eng.close()

    exc = _raises_in_time(feed)
    assert isinstance(exc, RuntimeError) and "sink failed" in str(exc)
    assert _no_worker_threads()


@pytest.mark.parametrize("async_emit", [True, False])
def test_dispatch_error_raised_on_caller(tmp_path, monkeypatch, async_emit):
    """A launch that fails (here: the gather + CNN call) makes run_call
    raise on the caller's thread, with no switch to another path."""
    def failing(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(engine_mod, "call_sites_group", failing)
    bam = _bam(tmp_path, _reads(13))
    exc = _raises_in_time(lambda: run_call(
        bam, str(tmp_path / "out.bam"),
        CallConfig(**FORCED, async_emit=async_emit)))
    assert isinstance(exc, RuntimeError) and "launch failed" in str(exc)
    assert _no_worker_threads()


def test_decode_error_raised_on_caller(tmp_path, monkeypatch):
    """A decode worker's exception reaches run_call's caller; every
    prefetch and pipeline thread is joined."""
    calls = []
    decode = engine_mod.decode_read

    def failing(rec):
        calls.append(rec.qname)
        if len(calls) == 4:
            raise RuntimeError("decode failed")
        return decode(rec)

    monkeypatch.setattr(engine_mod, "decode_read", failing)
    bam = _bam(tmp_path, _reads(14, n=30))
    exc = _raises_in_time(lambda: run_call(
        bam, str(tmp_path / "out.bam"), CallConfig(**FORCED,
                                                   decode_workers=3)))
    assert isinstance(exc, RuntimeError) and "decode failed" in str(exc)
    assert _no_worker_threads()


def _engine_after(reads, **kw):
    """A sync engine (no sink) fed `reads`; returns it and the flush count
    after each read."""
    eng = CallEngine(CallConfig(**{**FORCED, **kw}))
    counts, done = [], []
    for rec in reads:
        eng.add_read(rec, done)
        counts.append(eng.flushes)
    return eng, counts


def test_first_ramp_step_flushes_under_segment_cut():
    """With a first ramp step of half a segment, the second 700-base read
    triggers a flush while the first read still runs past the only
    finished segment.  The cut has nothing to keep; the ramp flush goes
    ahead with the segment in progress (the JAX engine waited for a
    segment boundary that a read clears)."""
    rng = np.random.default_rng(5)
    reads = [make_kinetics_read(rng, f"r{i}", 700) for i in range(3)]
    eng, counts = _engine_after(reads, flush_ramp=(512, 1024))
    assert eng._seg_size == 1024
    assert counts[:2] == [0, 1]
    _, counts2 = _engine_after(reads, flush_ramp=())
    assert counts2[1] == 0           # no ramp: the cut waits for a segment


def test_carried_bases_counted():
    """After a cut that carries reads, the next flush's packed count starts
    at the first carried read, so it counts the carried bases."""
    rng = np.random.default_rng(8)
    reads = [make_kinetics_read(rng, f"r{i}", int(rng.integers(600, 1400)))
             for i in range(12)]
    eng = CallEngine(CallConfig(**FORCED, flush_ramp=()))
    done, carries = [], 0
    for rec in reads:
        flushes = eng.flushes
        eng.add_read(rec, done)
        packed = [p for p in eng._pending if p.fwd_seq is not None]
        assert eng._last_flush_fill <= min(p.start for p in packed)
        assert eng._fill - eng._last_flush_fill >= sum(
            p.extent - p.start for p in packed)
        if eng.flushes > flushes and len(packed) > 1:
            carries += 1
            assert eng._last_flush_fill == packed[0].start
    assert carries > 0


@pytest.mark.parametrize("gather_impl,devices", [
    ("pallas", None), ("pallas", ["cpu", "cpu"]), ("fused", None),
    ("slice", None), ("slice", ["cpu", "cpu"]), ("folded", None),
    ("folded", ["cpu", "cpu"])])
def test_planes_reach_devices_as_shipped_segments(tmp_path, monkeypatch,
                                                  gather_impl, devices):
    """On every route each flush's planes reach each device only through
    _ship: the flush's payload is pieces _ship made, which start at the
    buffer's first column, follow one another and cover every site's read
    of the flush; no plane byte goes through _h2d."""
    shipped = {}                 # id(device tensor) -> (tensor, col, width)
    real_ship, real_h2d = CallEngine._ship, CallEngine._h2d
    real_work = CallEngine._dispatch_work
    flushes = []

    def ship(self, piece):
        col = (piece.__array_interface__["data"][0]
               - self._planes.__array_interface__["data"][0])
        out = real_ship(self, piece)
        for t, _ in out:
            shipped[id(t)] = (t, col, piece.shape[1])
        return out

    def h2d(self, a, hold, d=0):
        assert a.dtype != np.uint8, "plane bytes through _h2d"
        return real_h2d(self, a, hold, d)

    def work(self, w, flush):
        segments, sites = w
        for d in range(len(self.devices)):
            pieces = [shipped[id(seg[d][0])][1:] for seg in segments]
            cols = [col for col, _ in pieces]
            widths = [width for _, width in pieces]
            assert cols == [sum(widths[:i]) for i in range(len(widths))]
            assert sum(widths) <= self.cfg.buffer_bases
            for s in sites.values():
                assert all(r.max() <= sum(widths) for r in s["rend"] if
                           len(r))
        flushes.append(flush)
        return real_work(self, w, flush)

    monkeypatch.setattr(CallEngine, "_ship", ship)
    monkeypatch.setattr(CallEngine, "_h2d", h2d)
    monkeypatch.setattr(CallEngine, "_dispatch_work", work)
    recs = _reads(17, n=18)
    bam = _bam(tmp_path, recs)
    out = str(tmp_path / "out.bam")
    run_call(bam, out, CallConfig(**FORCED, gather_impl=gather_impl,
                                  data_parallel=devices is not None),
             devices=devices)
    assert len(flushes) > 1 and shipped
    assert sum(r[1] is not None for r in _records(out)) >= 8


def _jax_tags(path):
    out = []
    for r in BamReader(path):
        ml = r.get_tag("ML")
        out.append((r.qname, r.get_tag("MM"), r.get_tag("MN"),
                    None if ml is None else ml[1][1].astype(int)))
    return out


def test_async_matches_jax_engine_on_forced_schedule(tmp_path):
    recs = _reads(17, n=10)
    bam = _bam(tmp_path, recs)
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        gather_impl="pallas", **{k: v for k, v in FORCED.items()
                                 if k != "device"}))
    out = str(tmp_path / "torch.bam")
    run_call(bam, out, CallConfig(**FORCED, decode_workers=3))
    got, want = _jax_tags(out), _jax_tags(jax_out)
    assert [g[0] for g in got] == [r.qname for r in recs]
    assert [g[:3] for g in got] == [w[:3] for w in want]
    n_off = n_tot = 0
    for g, w in zip(got, want):
        if g[3] is not None:
            d = np.abs(g[3] - w[3])
            assert d.max() <= 1, g[0]
            n_off += int((d > 0).sum())
            n_tot += len(d)
    assert n_tot > 0 and n_off <= 0.05 * n_tot
