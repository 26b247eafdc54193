"""Seconds from the call of ``HierarchicalTrainer.train_level`` to the end of
its first epoch (host clock): the plan, the operators' build and copy, the
parameters' initialisation and the first step with its first-use costs."""

UNIT = "s"
LAYER = "trainer, plan and operator build"
MOVES = "setup_s"


def read(run):
    return run.level_start_s
