"""A GAT step's share of the card's peak: the operations one step needs
(``models/gat.py`` ``step_flops``: projections, the attention logits'
products, the aggregations and the SDDMM, forward and backward) over the
traced step time times the published dense peak of the plan's compute
type."""

from perfbench.lib import counts

UNIT = "%"
LAYER = "model step"
MOVES = "step_ms"


def read(run):
    if run.trace is None:
        return None
    peak = counts.peaks_for(run.device_kind)[run.shape.dtype]
    return 100.0 * run.model.step_flops(run.shape) / (run.trace.step_s * peak)
