"""The ELL kernels' share of their roofline: the least time of a step's
products on the ELL operators (``counts.propagation_least_seconds``, a
4-byte column index a nonzero) over the device time of the kernels named in
``KERNELS``."""

from perfbench.lib import counts

UNIT = "%"
LAYER = "kernels"
MOVES = "step_ms"
# The CUDA kernel behind ell_resident and ell_hbm (csrc/ell.cu).
KERNELS = ("ell_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = counts.propagation_least_seconds(run.shape, 4, counts.peaks_for(run.device_kind))
    return 100.0 * least * run.trace.epochs / seconds
