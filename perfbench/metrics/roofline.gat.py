"""The GAT attention kernels' share of their roofline: the least time of a
step's attention launches (``models/gat.py`` ``attention_least_seconds``:
per launch the larger of its bytes over the memory rate and its operations
over the peak) over the device time of the kernels named in ``KERNELS``."""

from perfbench.lib import counts

UNIT = "%"
LAYER = "kernels"
MOVES = "step_ms"
# The CUDA kernels behind ops/gat_kernels.py (csrc/gat.cu).
KERNELS = ("gat_softmax_kernel", "gat_aggregate_kernel", "gat_edge_grad_kernel")


def read(run):
    if run.trace is None:
        return None
    least_seconds = getattr(run.model, "attention_least_seconds", None)
    if least_seconds is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = least_seconds(run.shape, counts.peaks_for(run.device_kind))
    return 100.0 * least * run.trace.epochs / seconds
