"""Featurize, plan and launch (engine/call.py _dispatch_work,
engine/programs.py, features/windows.py, ops/gather.py): the engine's
dispatch thread-seconds per million sites written."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if not t or not run["n_sites"]:
        return None
    return t["dispatch"] / (run["n_sites"] / 1e6)
