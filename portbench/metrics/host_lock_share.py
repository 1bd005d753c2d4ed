"""Host stages (engine/call.py, its decode, dispatch, resolve and emit
threads): the share of the work spans' wall seconds their threads spent
off the CPU, 1 - CPU / wall over decode, sites, pack, dispatch, resolve
without its wait for the card, mmbuild and write (the engine's timers
with trace on), in %.  The explicit waits are left out, so what stays off
the CPU is mostly the interpreter lock; a CUDA call that spins counts as
CPU.  Only in a run traced on the card."""
MOVES = "sites_per_s"

WORK = ("decode", "sites", "pack", "dispatch", "resolve", "mmbuild",
        "write")


def read(run):
    t = run["timers"]
    if run["trace"] is None or not t:
        return None
    keys = WORK + ("resolve_wait",)
    if any(k not in t or k + "_cpu" not in t for k in keys):
        return None
    wall = sum(t[k] for k in WORK) - t["resolve_wait"]
    cpu = sum(t[k + "_cpu"] for k in WORK) - t["resolve_wait_cpu"]
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
