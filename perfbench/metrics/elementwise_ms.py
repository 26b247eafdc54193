"""Device milliseconds a step of the elementwise and reduction kernels
(``KERNELS``), from the traced window: ATen's (``elementwise_kernel`` also
names its ``vectorized_`` and ``unrolled_`` forms; ``reduce_kernel``) and
the DirectGCN layer tail's pair (``csrc/epilogue.cu``)."""

UNIT = "ms"
LAYER = "model step"
MOVES = "step_ms"
KERNELS = ("elementwise_kernel", "reduce_kernel", "epilogue_fwd_kernel", "epilogue_bwd_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.trace.epochs
