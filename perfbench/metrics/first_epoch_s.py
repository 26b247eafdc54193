"""Seconds of the level's first epoch whole (the ``level.first_epoch`` span
that ``train_level`` records always): the first step with its first-use
costs (kernel builds, the allocator's first blocks), the loss read, the
log and the scheduler.  None where the program recorded no such span."""

UNIT = "s"
LAYER = "trainer, plan and operator build"
MOVES = "setup_s"
SPAN = "level.first_epoch"


def read(run):
    if run.trace is None:
        return None
    from protgram_directgcn_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    found = [s for s in (spans() if spans else []) if s.name == SPAN and s.end_ns >= 0]
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9
