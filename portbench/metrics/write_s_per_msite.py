"""Emit (io/bam.py BamWriter.write, engine/call.py _emit_worker): the
emit thread's seconds in the sink's record writes (the engine's `write`
timer: record serialisation and the BGZF hand-off) per million sites
written; only in a run traced on the card."""
MOVES = "sites_per_s"


def read(run):
    t = run["timers"]
    if run["trace"] is None or not t or "write" not in t \
            or not run["n_sites"]:
        return None
    return t["write"] / (run["n_sites"] / 1e6)
