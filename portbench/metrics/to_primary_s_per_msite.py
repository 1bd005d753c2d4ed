"""The exchange between cards (engine/call.py _to_primary and the stack or
concatenation after it): the engine's `to_primary` wall seconds (--stats-json
timers, recorded over a device list only) per million sites written.  0 in
a run traced on one card, which brings nothing across cards; nothing on
more cards from a program that records no such span."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if not t or not run["n_sites"]:
        return None
    if "to_primary" in t:
        return t["to_primary"] / (run["n_sites"] / 1e6)
    if run["trace"] is not None and run.get("cards") == 1:
        return 0.0
    return None
