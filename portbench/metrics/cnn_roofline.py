"""CNN on the card: the model FLOPs of the sites called at the bf16
tensor-core peak, as a share of the device time of every kernel but the
window-gather kernel and the copies, in %.  On the pallas route that time
is the `conv1d_relu` kernels (ops/csrc/conv1d_relu.cu, each conv with its
bias and ReLU), cuBLAS's two products (fc1, fc2) and the elementwise tail
(model/cnn.py, the u8 conversion) beside the table's featurize; on the
fused route it is the fused kernel (ops/csrc/fused_forward.cu), which
gathers and runs the whole net, beside the same featurize."""
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
