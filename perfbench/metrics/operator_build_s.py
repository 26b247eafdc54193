"""Seconds of the level's operator build: the ``level.operators`` span that
``train_level`` records always, around the three scipy matrices
(``operators.transforms``) and the format's build with its copy to the card
(``operators.build``).  None where the program recorded no such span."""

UNIT = "s"
LAYER = "trainer, plan and operator build"
MOVES = "setup_s"
SPAN = "level.operators"


def read(run):
    if run.trace is None:
        return None
    from protgram_directgcn_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    found = [s for s in (spans() if spans else []) if s.name == SPAN and s.end_ns >= 0]
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9
