"""CNN on the card (model/cnn.py: cuDNN convolutions, cuBLAS products,
elementwise kernels): the model FLOPs of the sites called at the bf16
tensor-core peak, as a share of the device time of every kernel but the
window gather and the copies, in %."""
from portbench import devtrace, roofline

MOVES = "sites_per_s"
_NOT_CNN = ("gather kernel", "memcpy/memset")


def read(run):
    tr = run["trace"]
    if tr is None or not run["n_sites"]:
        return None
    t = sum(s for c, s in tr.seconds_by(devtrace.kernel_class).items()
            if c not in _NOT_CNN)
    if t <= 0:
        return None
    return 100.0 * run["flops"] / roofline.PEAK_FLOPS / t
