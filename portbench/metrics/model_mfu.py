"""The whole step: the model FLOPs of the sites written in the window,
over the window's seconds times the bf16 tensor-core peak times the
cards, in %."""
from portbench import roofline

MOVES = "sites_per_s"


def read(run):
    if run["trace"] is None or not run["n_sites"]:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * roofline.PEAK_FLOPS
                                   * run["cards"])
