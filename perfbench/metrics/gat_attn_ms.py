"""Device milliseconds a step of the GAT attention kernels (``KERNELS``,
``csrc/gat.cu``: the softmax, the aggregation both ways, the edge
gradient), from the traced window."""

UNIT = "ms"
LAYER = "kernels"
MOVES = "step_ms"
KERNELS = ("gat_softmax_kernel", "gat_aggregate_kernel", "gat_edge_grad_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.trace.epochs
