"""The readers of the engine's spans and counts (metrics/batch_fill,
host_lock_share, decode_wait_s_per_msite, write_s_per_msite) on
synthetic runs: nothing without a run traced on the card or without the
keys they read (a program that records no such span), the number with
them."""
import pytest

from portbench import catalog

NAMES = ("batch_fill", "host_lock_share", "decode_wait_s_per_msite",
         "write_s_per_msite")

#: a traced run's timers: 2 M sites written in 2.5 M slots
TIMERS = {"decode": 3.0, "sites": 2.0, "pack": 1.0, "flush": 20.0,
          "dispatch": 4.0, "resolve": 30.0, "mmbuild": 5.0, "capture": 0.1,
          "decode_wait": 0.5, "flush_wait": 18.0, "resolve_wait": 28.0,
          "write": 1.0, "dispatch_idle": 1.0, "resolve_idle": 2.0,
          "emit_idle": 3.0, "slots": 2_500_000, "batches": 305,
          "pinned_new": 12,
          "decode_cpu": 2.0, "sites_cpu": 1.0, "pack_cpu": 0.5,
          "dispatch_cpu": 2.0, "resolve_cpu": 1.25, "resolve_wait_cpu": 0.25,
          "mmbuild_cpu": 4.0, "write_cpu": 0.25}
#: the parent's timers: no span this reader needs
OLD = {k: TIMERS[k] for k in ("decode", "sites", "pack", "flush",
                              "dispatch", "resolve", "mmbuild", "capture")}


def _run(timers, trace=object()):
    return {"n_sites": 2_000_000, "timers": timers, "trace": trace}


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    reader = catalog.metric(name)
    assert reader.MOVES == "sites_per_s"
    assert reader.read(_run(TIMERS, trace=None)) is None
    assert reader.read(_run(None)) is None
    assert reader.read(_run(OLD)) is None


def test_values():
    got = {n: catalog.metric(n).read(_run(TIMERS)) for n in NAMES}
    # work wall 3 + 2 + 1 + 4 + (30 - 28) + 5 + 1 = 18 s, CPU 2 + 1 + 0.5
    # + 2 + (1.25 - 0.25) + 4 + 0.25 = 10.75 s
    assert got == pytest.approx({
        "batch_fill": 80.0,
        "host_lock_share": 100.0 * (1 - 10.75 / 18),
        "decode_wait_s_per_msite": 0.25,
        "write_s_per_msite": 0.5})


def test_no_sites():
    run = _run(TIMERS)
    run["n_sites"] = 0
    assert catalog.metric("batch_fill").read(run) == 0.0
    assert catalog.metric("write_s_per_msite").read(run) is None
