"""The comparison that decides ``correct``: the program's first steps against
the reference's, on the same inputs, weights drawn alike and the same
dropout masks.

Three numbers, each with a limit of its own (``perfbench/limits/<cell>.json``):

- ``first_loss_gap``: the relative gap of the first step's loss.  The later
  steps' losses are read too (``loss_gap_all_steps`` in the notes) but not
  held to a limit: Adam's first, sign-like step flips elements whose
  gradient is nought to rounding, so any two float32 orders of the same sums
  (the reference against itself with its products summed in another order)
  part there by up to ~2e-5 on some seeds and by nothing on others;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient (the program's as its optimizer got it) measured against the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change over the checked steps,
  over the leaves whose reference gradient is at least ``GRAD_FLOOR`` of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by round-off alone).

A program whose leaves do not pair with the reference's one to one, or
whose optimizer took other than one step an epoch, reads ``inf`` on every
number.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

GRAD_FLOOR = 1e-3
NUMBERS = ("first_loss_gap", "grad_gap", "change_gap")


def _worst(prog: Sequence[Optional[float]], ref: Sequence[float], idx: Sequence[int]
           ) -> Tuple[float, int]:
    scale = statistics.median(ref[i] for i in idx)
    worst, at = 0.0, -1
    for i in idx:
        p = prog[i]
        gap = math.inf if p is None or not math.isfinite(p) else abs(p - ref[i]) / max(
            ref[i], scale)
        if gap > worst or at < 0:
            worst, at = gap, i
    return worst, at


def compare(prog: dict, ref: dict) -> Tuple[Dict[str, float], List[str]]:
    """(numbers, notes).  ``prog`` holds ``losses``, ``grad_norms``,
    ``change_norms``, ``numels`` and ``steps_at_checked``; ``ref`` what
    ``reference.model.train_steps`` returns."""
    notes: List[str] = []
    steps = len(ref["losses"])
    if prog.get("steps_at_checked") != list(range(1, steps + 1)):
        notes.append(f"optimizer steps at the checked epochs {prog.get('steps_at_checked')}, "
                     f"expected one an epoch")
    if prog.get("numels") != ref["numels"]:
        notes.append(f"the program's {len(prog.get('numels') or [])} leaves do not pair with "
                     f"the reference's {len(ref['numels'])} by size")
    if (len(prog.get("losses") or []) != steps or prog.get("grad_norms") is None
            or prog.get("change_norms") is None):
        notes.append("the program's first steps were not all read")
    if notes:
        return {k: math.inf for k in NUMBERS}, notes
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(prog["losses"], ref["losses"])]
    every = range(len(ref["grad_norms"]))
    grad_gap, gi = _worst(prog["grad_norms"], ref["grad_norms"], every)
    g_med = statistics.median(ref["grad_norms"])
    moving = [i for i in every if ref["grad_norms"][i] >= GRAD_FLOOR * g_med]
    change_gap, ci = _worst(prog["change_norms"], ref["change_norms"], moving)
    notes.append(f"loss_gap_all_steps {max(gaps)!r}; worst gradient leaf {ref['names'][gi]}, "
                 f"worst change leaf {ref['names'][ci]}; {len(every) - len(moving)} leaves "
                 f"below the gradient floor")
    return {"first_loss_gap": gaps[0], "grad_gap": grad_gap, "change_gap": change_gap}, notes
