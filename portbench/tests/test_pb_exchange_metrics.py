"""The readers of the exchange between cards (metrics/peer_copy_share,
card_busy_spread, to_primary_s_per_msite) on hand-made device traces and
timers: nothing without a trace or timers, and nothing for the span from
a program on more than one card that records no `to_primary`; 0 in a run
traced on one card, which brings nothing across cards; the number
otherwise."""
import pytest

from portbench import catalog
from portbench.devtrace import DeviceTrace

NAMES = ("peer_copy_share", "card_busy_spread", "to_primary_s_per_msite")
PEER = "Memcpy PtoP (Device -> Device)"

#: four cards over a 10 s window: peer copies 1.5 s on card 1 (0.5 s of
#: it before the window) and 0.5 s on card 2 overlapping card 1's; a copy
#: within card 3 is no peer copy
FOUR = {0: [(0.0, 8.0, "conv1d_relu_kernel")],
        1: [(0.0, 5.0, "conv1d_relu_kernel"), (-0.5, 1.0, PEER)],
        2: [(1.0, 7.0, "group_windows_t"), (0.75, 1.25, PEER)],
        3: [(2.0, 5.0, "conv1d_relu_kernel"),
            (5.0, 6.0, "Memcpy DtoD (Device -> Device)")]}
#: a traced run's timers over four cards: 2 M sites written
TIMERS = {"dispatch": 4.0, "to_primary": 0.5, "peer_bytes": 1_500_000,
          "ship_bytes": 40_000_000}


def _run(events=FOUR, timers=TIMERS, n_sites=2_000_000):
    trace = None if events is None else DeviceTrace(events, 0.0, 10.0)
    return {"n_sites": n_sites, "timers": timers, "trace": trace,
            "cards": len(events) if events else 1}


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    reader = catalog.metric(name)
    assert reader.MOVES == "sites_per_s"
    assert reader.read(_run(events=None, timers=None)) is None
    assert reader.read(_run(events={}, timers=None)) is None


@pytest.mark.parametrize("name", NAMES)
def test_one_card_reads_zero(name):
    """One card traced: no copy across cards, no spread, no exchange."""
    one_card = {0: FOUR[0]}
    assert catalog.metric(name).read(
        _run(events=one_card, timers={"dispatch": 4.0})) == 0.0
    assert catalog.metric(name).read(
        _run(events=None, timers={"dispatch": 4.0})) is None


def test_no_span_on_four_cards():
    """A program that records no `to_primary` over four cards: nothing."""
    assert catalog.metric("to_primary_s_per_msite").read(
        _run(timers={"dispatch": 4.0})) is None


def test_values():
    got = {n: catalog.metric(n).read(_run()) for n in NAMES}
    # peer copies: [0, 1] on card 1 (clipped to the window) and [0.75,
    # 1.25] on card 2: a union of 1.25 s of 10; busy 8, 5, 6.25 and 4 s
    # (the copy within card 3 counts as busy)
    assert got == pytest.approx({
        "peer_copy_share": 12.5,
        "card_busy_spread": 100.0 * (8 - 4) / 8,
        "to_primary_s_per_msite": 0.25})


def test_no_peer_copy_reads_zero():
    """Cards that copied nothing to each other: 0, not nothing."""
    events = {d: [e for e in evs if e[2] != PEER] for d, evs in FOUR.items()}
    assert catalog.metric("peer_copy_share").read(_run(events)) == 0.0


def test_no_sites():
    assert catalog.metric("to_primary_s_per_msite").read(
        _run(n_sites=0)) is None
