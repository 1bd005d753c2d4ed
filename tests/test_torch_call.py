"""The port's `run_call` on the CPU against the JAX package's `run_call` and
the golden corpus.

Contract (tests/test_golden.py:31-81, docs/PARITY.md): MM and MN byte-equal,
ML u8 within +-1 with at most 5% of ML bytes off, records in input order,
short and kinetics-less reads passed through untouched, kinetics tags
stripped from called reads.  ML can move by one where float32 sums taken in
another order (PyTorch vs XLA convolutions) cross a u8 quantization step.
"""
import json
import os

import numpy as np
import pytest

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu_torch.engine.call import CallConfig, run_call
from hifimeth_tpu_torch.io.bam import BamReader

from util import make_kinetics_read, write_bam

DATA = os.path.join(os.path.dirname(__file__), "data")
KINETICS = ("fi", "ri", "fp", "rp")


def _tags(rec):
    mm, ml, mn = (rec.get_tag(t) for t in ("MM", "ML", "MN"))
    return (mm[1] if mm else None,
            ml[1][1].astype(int) if ml else None,
            mn[1] if mn else None)


def _assert_contract(got, want):
    """got/want: lists of (qname, MM, ML array|None, MN)."""
    assert [g[0] for g in got] == [w[0] for w in want]
    n_off = n_tot = 0
    for (name, mm, ml, mn), (_, wmm, wml, wmn) in zip(got, want):
        assert mm == wmm, name
        assert mn == wmn, name
        assert (ml is None) == (wml is None), name
        if ml is not None:
            assert len(ml) == len(wml), name
            assert np.abs(ml - wml).max() <= 1, name
            n_off += int((ml != wml).sum())
            n_tot += len(ml)
    assert n_tot > 0
    assert n_off <= 0.05 * n_tot, f"{n_off}/{n_tot} ML bytes off"


def test_call_matches_jax_across_flushes(tmp_path):
    """Synthetic reads against a 16 Ki buffer and 4 Ki flushes force buffer
    rollovers, fill-through flushes, partial batches and padded groups."""
    rng = np.random.default_rng(7)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(1500, 3000)),
                               flag=16 if i % 3 == 1 else 4)
            for i in range(7)]
    recs.insert(2, make_kinetics_read(rng, "short", 300))
    bare = make_kinetics_read(rng, "bare", 1500)
    for t in KINETICS:
        bare.del_tag(t)
    recs.insert(5, bare)
    recs.append(make_kinetics_read(rng, "raw", 1600, raw_frames=True))
    bam = str(tmp_path / "in.bam")
    write_bam(bam, recs)

    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        site_batch=128, gather_impl="pallas", buffer_bases=1 << 14))
    out = str(tmp_path / "torch.bam")
    stats = run_call(bam, out, CallConfig(
        site_batch=128, buffer_bases=1 << 14, flush_bases=4096, device="cpu"))

    got_recs = list(BamReader(out))
    want_recs = list(BamReader(jax_out))
    _assert_contract([(r.qname, *_tags(r)) for r in got_recs],
                     [(r.qname, *_tags(r)) for r in want_recs])
    assert stats["reads"] == len(recs) and stats["called_reads"] == 8
    by_name = {r.qname: r for r in got_recs}
    src = {r.qname: r for r in recs}
    for name in ("short", "bare"):
        r = by_name[name]
        assert r.get_tag("MM") is None and r.get_tag("ML") is None
        assert r.seq_nibbles == src[name].seq_nibbles
        assert [t[0] for t in r.tags] == [t[0] for t in src[name].tags]
    for name in ("r0", "r1", "raw"):
        assert all(by_name[name].get_tag(t) is None for t in KINETICS)


@pytest.mark.parametrize("keep_kinetics", [False, True])
def test_call_golden_corpus(tmp_path, keep_kinetics):
    """The pinned golden call tags hold for the port's engine."""
    out = str(tmp_path / "out.bam")
    run_call(os.path.join(DATA, "golden_call_in.bam"), out,
             CallConfig(site_batch=512, device="cpu",
                        keep_kinetics=keep_kinetics))
    got = list(BamReader(out))
    with open(os.path.join(DATA, "golden_call_tags.json")) as f:
        want = json.load(f)
    _assert_contract(
        [(r.qname, *_tags(r)) for r in got],
        [(w["qname"], w["MM"],
          None if w["ML"] is None else np.asarray(w["ML"], int), w["MN"])
         for w in want])
    called = [r for r in got if r.get_tag("MM") is not None]
    assert called
    for r in called:
        kept = [r.get_tag(t) is not None for t in KINETICS]
        assert all(kept) if keep_kinetics else not any(kept)


def test_cli_call_on_cpu_and_unported_commands(tmp_path, capsys):
    from hifimeth_tpu_torch.cli import main

    out = str(tmp_path / "cli.bam")
    assert main(["call", "--device", "cpu", "-s", "512", "-c", "cpg,chh",
                 os.path.join(DATA, "golden_call_in.bam"), out]) == 0
    recs = list(BamReader(out))
    assert len(recs) == 12
    assert any(r.get_tag("MM") is not None for r in recs)
    # every command of the JAX CLI is ported: train answers with its usage
    capsys.readouterr()
    with pytest.raises(SystemExit) as err:
        main(["train", "features", "out"])
    assert err.value.code == 2
    text = capsys.readouterr().err
    assert "usage: hifimeth-tpu-torch train" in text
    assert "--feature" in text and "not yet ported" not in text
    with pytest.raises(SystemExit):
        main(["call", "--device", "tpu", "a.bam", "b.bam"])


@pytest.mark.parametrize("async_emit", [True, False])
def test_call_flush_builder_matches_per_read_path(tmp_path, monkeypatch,
                                                  async_emit):
    """The engine's one native MM/ML build per flush writes the records the
    per-read fallback writes, byte for byte, async and with --sync-emit;
    `mmbuild_native` counts the called reads and `mmbuild_calls` the
    flushes, and both read 0 on the fallback."""
    from hifimeth_tpu_torch.io import native

    def run(name):
        out = str(tmp_path / f"{name}.bam")
        stats_json = str(tmp_path / f"{name}.json")
        # small flushes, so the golden reads spread over several
        stats = run_call(os.path.join(DATA, "golden_call_in.bam"), out,
                         CallConfig(site_batch=512, device="cpu",
                                    buffer_bases=1 << 14, flush_bases=4096,
                                    async_emit=async_emit,
                                    stats_json=stats_json))
        with open(stats_json) as f:
            js = json.load(f)
        return [r.to_bytes() for r in BamReader(out)], stats, js

    got, stats, js = run("native")
    assert js["schedule"]["flushes"] > 1
    assert js["timers"]["mmbuild_native"] == stats["called_reads"] > 0
    assert js["timers"]["mmbuild_calls"] == js["schedule"]["flushes"]
    monkeypatch.setattr(native, "_load_mmbuild", lambda: False)
    want, _, js = run("per_read")
    assert js["timers"]["mmbuild_native"] == js["timers"]["mmbuild_calls"] \
        == 0
    assert got == want
