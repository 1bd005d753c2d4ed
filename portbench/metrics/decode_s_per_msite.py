"""Decode and site scan (features/read_decode.py, features/sites.py,
io/bgzf.py, io/native.py, engine/call.py _DecodePrefetcher): the engine's
decode + sites thread-seconds (--stats-json timers) per million sites
written."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if not t or not run["n_sites"]:
        return None
    return (t["decode"] + t["sites"]) / (run["n_sites"] / 1e6)
