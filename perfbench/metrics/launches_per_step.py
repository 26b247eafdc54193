"""Device kernels a step in the traced window (copies and sets left out)."""

UNIT = "launches"
LAYER = "trainer loop and model step"
MOVES = "step_ms"


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_launches() / run.trace.epochs
