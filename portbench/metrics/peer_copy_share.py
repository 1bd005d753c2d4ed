"""The exchange between cards (engine/call.py _to_primary): the union of
the peer copies' intervals on every card (device copies named PtoP, one
card's memory to another's) over the traced window, in %.  Only in a run
traced on the card; 0 where the run copied nothing across cards, as on
one card."""
from portbench import devtrace

MOVES = "sites_per_s"


def is_peer_copy(name: str) -> bool:
    n = name.lower()
    return "memcpy" in n and ("ptop" in n or "peer" in n)


def read(run):
    tr = run["trace"]
    if tr is None or not tr.events:
        return None
    spans = [(max(a, tr.t0), min(b, tr.t1))
             for evs in tr.events.values() for a, b, name in evs
             if is_peer_copy(name) and b > tr.t0 and a < tr.t1]
    return 100.0 * devtrace.union_seconds(spans) / tr.window_s
