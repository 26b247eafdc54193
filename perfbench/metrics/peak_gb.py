"""The most device memory that the caching allocator held at once
(``torch.cuda.max_memory_allocated``), from the start of the level (the
trainer resets the counter) through the window: whether a level fits, and
which memory tier the plan takes."""

UNIT = "GB"
LAYER = "trainer, plan and operator build"
MOVES = "step_ms"


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 1e9
