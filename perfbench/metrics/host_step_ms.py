"""The host's time to issue a step: the median, over the epochs recorded
under the traced run's profilers, of the ``step`` span (forward, backward
and the optimizer, issued without waiting for the card).  None where the
program recorded no such span."""

import statistics

UNIT = "ms"
LAYER = "trainer loop and model step"
MOVES = "step_ms"
SPAN = "step"


def read(run):
    if run.trace is None:
        return None
    from protgram_directgcn_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    found = [s.end_ns - s.start_ns for s in (spans() if spans else [])
             if s.name == SPAN and s.end_ns >= 0]
    if not found:
        return None
    return statistics.median(found) / 1e6
