"""The port's per-flush pipeline trace (CallConfig.trace; the CLI sets it
from HIFIMETH_TRACE, the JAX engine's switch) on the CPU.

What is held:
 - the async pipeline prints one `[trace flush N]` line per flush, the
   flushes numbered 0.. in order, each with the seven stages in order and
   non-decreasing times, as many lines as the engine's `flushes`, on every
   per-site path and over a device list (one line per flush, not per
   device);
 - the traced records are byte-equal to the untraced ones;
 - with the trace off, and in sync mode, no trace line is printed;
 - on a schedule where both engines cut the same flushes, the port's
   `flush` events are as many as the JAX engine's on the same input and
   config.  That schedule is the pallas path with the segment-aligned cut
   off (JAX: HIFIMETH_NO_SEG_ALIGN=1; port: segment_align=False): the
   port's flush-ramp and carry repairs move its cuts only under the
   segment cut.
"""
import json
import re

import pytest

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu_torch.engine.call import CallConfig, run_call
from hifimeth_tpu_torch.io.bam import BamReader

from test_torch_pipeline import FORCED, _bam, _reads

STAGES = ["flush", "dispatch0", "dispatch1", "resolve0", "resolve1",
          "emit0", "emit1"]
ROW = re.compile(r"^\[trace flush (\d+)\] (.*)$")


def _rows(err: str) -> list:
    """stderr -> [(flush number, [(stage, seconds)])]."""
    rows = []
    for line in err.splitlines():
        m = ROW.match(line)
        if m:
            ev = [tuple(e.split("@")) for e in m.group(2).split()]
            rows.append((int(m.group(1)), [(s, float(t)) for s, t in ev]))
    return rows


def _records(path):
    return [r.to_bytes() for r in BamReader(path)]


def _call(tmp_path, capsys, bam, name, **kw):
    out = str(tmp_path / f"{name}.bam")
    stats = str(tmp_path / f"{name}.json")
    capsys.readouterr()
    run_call(bam, out, CallConfig(**{**FORCED, **kw}, stats_json=stats))
    with open(stats) as f:
        flushes = json.load(f)["schedule"]["flushes"]
    return _records(out), _rows(capsys.readouterr().err), flushes


def _check_rows(rows, flushes):
    assert flushes > 1
    assert [n for n, _ in rows] == list(range(flushes))
    for _, ev in rows:
        assert [s for s, _ in ev] == STAGES
        times = [t for _, t in ev]
        assert times == sorted(times) and times[0] >= 0


@pytest.mark.parametrize("gather_impl", ["pallas", "fused", "slice"])
def test_one_row_per_flush_and_records_equal(tmp_path, capsys, gather_impl):
    bam = _bam(tmp_path, _reads(3))
    kw = dict(gather_impl=gather_impl)
    if gather_impl == "slice":
        kw["buffer_bases"] = 1 << 12      # slice flushes on a full buffer
    plain, none, _ = _call(tmp_path, capsys, bam, "plain", **kw)
    traced, rows, flushes = _call(tmp_path, capsys, bam, "traced",
                                  trace=True, **kw)
    assert none == []
    assert traced == plain
    _check_rows(rows, flushes)


def test_one_row_per_flush_over_devices(tmp_path, capsys):
    bam = _bam(tmp_path, _reads(5))
    out = str(tmp_path / "dp.bam")
    stats = str(tmp_path / "dp.json")
    run_call(bam, out, CallConfig(**FORCED, trace=True, data_parallel=True,
                                  stats_json=stats),
             devices=["cpu"] * 3)
    with open(stats) as f:
        flushes = json.load(f)["schedule"]["flushes"]
    _check_rows(_rows(capsys.readouterr().err), flushes)


def test_sync_mode_traces_nothing(tmp_path, capsys):
    bam = _bam(tmp_path, _reads(7))
    _, rows, flushes = _call(tmp_path, capsys, bam, "sync", trace=True,
                             async_emit=False)
    assert flushes > 1 and rows == []


def test_cli_reads_hifimeth_trace(tmp_path, capsys, monkeypatch):
    from hifimeth_tpu_torch.cli import _parse_call, main
    monkeypatch.delenv("HIFIMETH_TRACE", raising=False)
    assert not _parse_call(["a.bam", "b.bam"])[0].trace
    monkeypatch.setenv("HIFIMETH_TRACE", "1")
    assert _parse_call(["a.bam", "b.bam"])[0].trace
    bam = _bam(tmp_path, _reads(11))
    stats = str(tmp_path / "cli.json")
    capsys.readouterr()
    assert main(["call", "--device", "cpu", "-s", "64", "-l", "250",
                 "--buffer-bases", "8192", "--flush-bases", "1024",
                 "--stats-json", stats, bam, str(tmp_path / "o.bam")]) == 0
    with open(stats) as f:
        flushes = json.load(f)["schedule"]["flushes"]
    _check_rows(_rows(capsys.readouterr().err), flushes)


def test_flush_events_equal_jax_engine(tmp_path, capsys, monkeypatch):
    """Pallas with the segment cut off: both engines flush on a full flush
    threshold or a full buffer only, so they cut the same flushes."""
    bam = _bam(tmp_path, _reads(17, n=40))
    monkeypatch.setenv("HIFIMETH_TRACE", "1")
    monkeypatch.setenv("HIFIMETH_NO_SEG_ALIGN", "1")
    capsys.readouterr()
    jax_run_call(bam, str(tmp_path / "jax.bam"), JaxCallConfig(
        gather_impl="pallas", **{k: v for k, v in FORCED.items()
                                 if k != "device"}))
    jax_err = capsys.readouterr().err
    jax_flushes = len(re.findall(r"\bflush@", jax_err))
    _, rows, flushes = _call(tmp_path, capsys, bam, "torch",
                             gather_impl="pallas", segment_align=False,
                             trace=True)
    _check_rows(rows, flushes)
    assert jax_flushes > 10
    assert len(rows) == jax_flushes
