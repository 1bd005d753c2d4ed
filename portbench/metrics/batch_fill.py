"""Featurize, plan and launch (engine/call.py _call_context,
_decompose_batches, _run_programs, the one launch loop of every route):
the sites written as a share of the site slots the card computed
(the engine's `slots` count, bucket padding included), in %; only in a
run traced on the card."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if run["trace"] is None or not t or not t.get("slots"):
        return None
    return 100.0 * run["n_sites"] / t["slots"]
