"""GAT (Velickovic et al., ICLR 2018) behind the interface that a
configuration's ``"model": "gat"`` selects (``lib/manifest.py`` ``model``):
its reference (``reference/gat.py``), the operations of its step, and the
bytes and operations of the attention kernels that ``roofline.gat`` reads.
The program trains it through ``HierarchicalTrainer.train_level`` under
``gcn.architecture = "gat"``.

What a step needs, counted from the shapes of the level and the model
whatever implements them (rows: the level's nodes; edges: its in-edges with
one self loop a node, E'):

- projections: per layer ``h @ W`` (and the skip's ``h @ W_res``), forward,
  the weight gradient and, past the first layer (the level's input takes no
  gradient), the input gradient; the attention logits' products of z with
  the heads' attention vectors (2H outputs), forward and both gradients;
- attention: per layer the aggregation ``sum_j alpha_ij z_j`` (2 E' H F),
  and in the backward the SDDMM ``<dout_i, z_j>`` and the transposed
  aggregation that gives dz (2 E' H F each).

Elementwise work (the softmax, LeakyReLU, ELU, the loss) and the optimizer
are left out, so ``mfu.gat`` is a share of the matrix work alone.

The attention kernels' least time (``attention_least_seconds``): per
launch the larger of its bytes over the memory rate and its operations over
the peak, each input read once and each output written once: 4 bytes an
edge for each of the ELL tables' index, mask and transpose-slot (``perm``)
arrays it reads (real slots only), 4 bytes an edge and head of the per-edge scalars
(alpha, dpre), 4 bytes a node and head of a_src, a_dst, lse and d_a_dst, and
the [N, H*F] arrays (z, the output, its gradient, dz).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

from perfbench.reference import gat as ref_gat
from perfbench.reference import level as ref_level


class StepShape(NamedTuple):
    rows: int  # real nodes of the level
    edges: int  # in-edges with one self loop a node
    in_dim: int
    layers: Tuple[Tuple[int, int, int, bool], ...]  # (in width, heads, width a head, skip)
    dtype: str  # the plan's compute type

    @property
    def itemsize(self) -> int:
        return {"float32": 4, "bfloat16": 2}[self.dtype]


def reference_level(level: ref_level.Level, cfg: dict, device) -> ref_gat.GatLevel:
    """The level's in-edges for attention; GAT runs on the vocabulary."""
    if cfg["node_space"] != "vocabulary":
        raise ValueError(f"a GAT level runs on the vocabulary, not {cfg['node_space']!r}")
    return ref_gat.attention_edges(level)


def step_shape(level: ref_gat.GatLevel, cfg: dict, mix: dict, dtype: str) -> StepShape:
    gcn = cfg["gcn"]
    specs = ref_gat.layers(mix["feat_dim"], gcn["hidden_layer_dims"], gcn["gat_heads"],
                           mix["num_classes"])
    return StepShape(rows=level.num_nodes, edges=level.num_edges, in_dim=mix["feat_dim"],
                     layers=tuple((s.in_dim, s.heads, s.width, s.residual) for s in specs),
                     dtype=dtype)


def projection_flops(s: StepShape) -> int:
    total = 0
    for i, (fin, h, f, skip) in enumerate(s.layers):
        passes = 2 if i == 0 else 3
        total += (1 + skip) * passes * 2 * s.rows * fin * h * f
        total += 3 * 2 * s.rows * h * f * 2 * h  # the logits: z @ [H*F, 2H]
    return total


def attention_flops(s: StepShape) -> int:
    return sum(3 * 2 * s.edges * h * f for _, h, f, _ in s.layers)


def step_flops(s: StepShape) -> int:
    """Operations one step needs: projections and attention."""
    return projection_flops(s) + attention_flops(s)


def attention_launches(s: StepShape) -> List[Tuple[str, int, int]]:
    """(kernel, bytes, operations) of every attention launch of a step:
    per layer the softmax and the aggregation forward, the edge gradient
    and the transposed aggregation backward."""
    n, e, b = s.rows, s.edges, s.itemsize
    out = []
    for _, h, f, _ in s.layers:
        table = n * h * f * b  # one [N, H*F] array
        stats = n * h * 4  # one [N, H] array
        scalars = e * h * 4  # one [E', H] array
        out += [("gat_softmax", 8 * e + 3 * stats + scalars, 0),
                ("gat_aggregate", 4 * e + scalars + 2 * table, 2 * e * h * f),
                ("gat_edge_grad", 12 * e + 3 * table + 4 * stats + 2 * scalars,
                 2 * e * h * f + 2 * n * h * f),
                ("gat_aggregate", 4 * e + scalars + 2 * table, 2 * e * h * f)]
    return out


def attention_least_seconds(s: StepShape, peaks: dict) -> float:
    """The least time of a step's attention launches on the card."""
    return sum(max(nbytes / peaks["bytes_per_s"], ops / peaks[s.dtype])
               for _, nbytes, ops in attention_launches(s))


first_steps = ref_gat.first_steps
