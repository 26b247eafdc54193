"""DirectGCN (ProtGram-DirectGCN) behind the interface that a configuration's
``"model": "directgcn"`` selects (``lib/manifest.py`` ``model``): its
reference operators and first steps (``reference/level.py``,
``reference/model.py``) and the operations of its step (``lib/counts.py``).
The program trains it through ``HierarchicalTrainer.train_level``."""

from __future__ import annotations

from perfbench.lib import counts
from perfbench.reference import level as ref_level


def reference_level(level: ref_level.Level, cfg: dict, device) -> ref_level.Level:
    """The in, out and undirected operators on the shared level's node space."""
    return ref_level.with_operators(level, cfg["propagation_epsilon"])


def step_shape(level: ref_level.Level, cfg: dict, mix: dict, dtype: str) -> counts.StepShape:
    dims = (mix["feat_dim"],) + tuple(cfg["gcn"]["hidden_layer_dims"])
    return counts.StepShape(rows=level.num_nodes, layer_dims=dims,
                            num_classes=mix["num_classes"], nnz=level.nnz, dtype=dtype)


first_steps = ref_level.first_steps
step_flops = counts.step_flops
