"""Emit (io/mmtags.py, io/bam.py): the engine's mmbuild thread-seconds
(MM/ML construction) per million sites written."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if not t or not run["n_sites"]:
        return None
    return t["mmbuild"] / (run["n_sites"] / 1e6)
