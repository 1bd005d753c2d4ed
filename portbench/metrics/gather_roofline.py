"""Window-gather kernel (ops/csrc/group_windows.cu): its least time, the
bytes the window's sites need (roofline.gather_bytes) at the HBM peak,
as a share of its device time in the traced window, in %.  Only the
pallas route launches that kernel: the fused route gathers inside its one
kernel, slice and folded by indexing."""
from portbench import devtrace, roofline

MOVES = "sites_per_s"
ROUTES = ("pallas",)


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = tr.seconds_by(devtrace.kernel_class).get("gather kernel", 0.0)
    if t <= 0:
        return None
    return 100.0 * run["gather_bytes"] / roofline.PEAK_BYTES / t
