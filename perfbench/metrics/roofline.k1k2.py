"""K1/K2's share of their roofline: the least time of a step's products on
the hypercube operators (``counts.propagation_least_seconds``, positions
implicit) over the device time of the kernels named in ``KERNELS``."""

from perfbench.lib import counts

UNIT = "%"
LAYER = "kernels"
MOVES = "step_ms"
# The CUDA kernels of ops/hyper_kernels.py (csrc/hyper.cu), K1 and K2 alike.
KERNELS = ("hyper_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = counts.propagation_least_seconds(run.shape, 0, counts.peaks_for(run.device_kind))
    return 100.0 * least * run.trace.epochs / seconds
