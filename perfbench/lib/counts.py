"""The yardstick's arithmetic: the chip's published peaks, and the operations
and bytes that one full-batch DirectGCN step needs, counted from the shapes of
the level and the model whatever implements them.

A step is one epoch of full-batch training: the forward pass, the backward
pass and the optimizer update.  What is counted:

- projections: per layer the three fused path projections ``x @ (W_main +
  W_shared)`` and, where the width changes, the residual projection; forward,
  the weight gradient, and after the first layer the input gradient (the
  level's input features take no gradient);
- propagations: per layer each of the three operators applied to its path's
  projection, forward and (the transpose product) backward;
- the decoder's two matrix products, forward, weight and input gradients.

Rows are the level's real nodes: rows a layout pads on (the hypercube's
absent n-grams) are work no step needs.  A sparse product needs its
operator's nonzeros, the input's rows read once and the output's written
once; an ELL product also reads one 4-byte column index a nonzero, while the
hypercube layout's positions are implicit.  Elementwise work, the loss and
the optimizer are left out, so ``mfu`` is a share of the matrix work alone.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
# sparsity) at its 700 W limit: float32 outside the tensor cores (the port
# turns TF32 off), bfloat16 on them, and the HBM3 rate.
PEAKS = {
    "H100": {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    """The peaks of the card named ``device_kind``
    (``torch.cuda.get_device_name``); raises for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in device_kind:
            return peaks
    raise ValueError(f"no published peaks for {device_kind!r}")


@dataclasses.dataclass(frozen=True)
class StepShape:
    """What one step's counts depend on."""

    rows: int  # real nodes of the level
    layer_dims: Tuple[int, ...]  # (input width, hidden widths...)
    num_classes: int
    nnz: Tuple[int, int, int]  # nonzeros of the in, out and undirected operators
    dtype: str  # the plan's compute type: "float32" or "bfloat16"

    @property
    def itemsize(self) -> int:
        return {"float32": 4, "bfloat16": 2}[self.dtype]


def _decoder_hidden(final_dim: int) -> int:
    return max(final_dim // 2 if final_dim > 1 else 1, 1)


def projection_flops(s: StepShape) -> int:
    total = 0
    for layer, (fi, fo) in enumerate(zip(s.layer_dims[:-1], s.layer_dims[1:])):
        mats = 3 + (1 if fi != fo else 0)
        passes = 2 if layer == 0 else 3  # forward, weight gradient, input gradient
        total += mats * passes * 2 * s.rows * fi * fo
    return total


def decoder_flops(s: StepShape) -> int:
    f = s.layer_dims[-1]
    h = _decoder_hidden(f)
    return 3 * 2 * s.rows * (f * h + h * s.num_classes)


def propagation_products(s: StepShape) -> Sequence[Tuple[int, int]]:
    """(width, nonzeros) of every sparse product of a step: each layer's
    three operators forward and their transposes backward."""
    return [(fo, nnz) for fo in s.layer_dims[1:] for nnz in s.nnz for _ in range(2)]


def propagation_flops(s: StepShape) -> int:
    return sum(2 * nnz * f for f, nnz in propagation_products(s))


def step_flops(s: StepShape) -> int:
    """Operations one step needs: projections, propagations, decoder."""
    return projection_flops(s) + propagation_flops(s) + decoder_flops(s)


def product_bytes(rows: int, width: int, nnz: int, itemsize: int, index_bytes: int) -> int:
    """One sparse product: input and output rows once, every nonzero's
    weight (float32) and, where the format stores one, its column index."""
    return 2 * rows * width * itemsize + nnz * (4 + index_bytes)


def propagation_least_seconds(s: StepShape, index_bytes: int, peaks: dict) -> float:
    """The least time of a step's sparse products on the card: per product
    the larger of its bytes over the memory rate and its operations over the
    compute type's peak, summed.  ``index_bytes``: 4 for ELL, 0 for the
    hypercube's implicit positions."""
    total = 0.0
    for width, nnz in propagation_products(s):
        b = product_bytes(s.rows, width, nnz, s.itemsize, index_bytes)
        total += max(b / peaks["bytes_per_s"], 2 * nnz * width / peaks[s.dtype])
    return total
