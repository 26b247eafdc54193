"""The host blocked on the card a step: the median, over the epochs
recorded under the traced run's profilers, of the ``epoch.loss_read`` span
(the ``float(loss)`` read, which waits for the step's work); near 0 where
the host paces the card.  None where the program recorded no such span."""

import statistics

UNIT = "ms"
LAYER = "trainer loop and model step"
MOVES = "step_ms"
SPAN = "epoch.loss_read"


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
