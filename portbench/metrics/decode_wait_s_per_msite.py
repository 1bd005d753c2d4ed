"""Decode and site scan (engine/call.py _DecodePrefetcher): the seconds
the packer waited for the next decoded read in order (the engine's
`decode_wait` timer) per million sites written; only in a run traced on
the card."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if run["trace"] is None or not t or "decode_wait" not in t \
            or not run["n_sites"]:
        return None
    return t["decode_wait"] / (run["n_sites"] / 1e6)
