"""Pack and segment ship (engine/call.py add_read, _ship): the engine's
pack thread-seconds per million sites written."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if not t or not run["n_sites"]:
        return None
    return t["pack"] / (run["n_sites"] / 1e6)
