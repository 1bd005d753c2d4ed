"""The traced window's rate in the four-card cell: every site written
over the time from run_call's start to its return, as the end-to-end
sites_per_s reads it in a plain run.  There it is no end-to-end metric:
its runs spread too widely on a shared host for any bound (PERF.md §2)."""
MOVES = "peak_device_mib"


def read(run):
    if not run["n_sites"]:
        return None
    return run["n_sites"] / run["window_s"]
