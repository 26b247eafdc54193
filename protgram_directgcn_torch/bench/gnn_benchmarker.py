"""GNN benchmark suite: DirectGCN against the zoo on node classification.

Port of protgram_directgcn_tpu/bench/gnn_benchmarker.py (reference:
src/benchmarks/gnn_benchmarker.py:34-424): per dataset and variant
(original, undirected), train every zoo model and the three DirectGCN rows
with masked cross-entropy under ``optax.chain(add_decayed_weights(wd),
adam(lr))`` (``OptaxAdam`` with ``weight_decay``), keep the test accuracy
at the best validation epoch (ties to the later epoch), and write node
embeddings (+PCA), the per-model history CSV, the per-dataset summary CSV,
the full summary CSV and the metric log.

The reference's composition is kept: DirectGCN's forward returns
log-softmax outputs and the loss applies cross-entropy (a second
log-softmax) on top (gnn_benchmarker.py:240-253 of the reference).  Each
epoch reads its loss and accuracies to the host (one transfer), as the JAX
package's ``float(acc_val)`` does.

The CSVs are written with the ``csv`` module, byte for byte as pandas'
``DataFrame(rows).to_csv(index=False)`` writes the same rows
(:func:`write_rows_csv`).  ``GNNBenchmarker.stats`` holds, per variant and
model, the wall seconds of its training, the steps taken, the seconds of
its history, embeddings and PCA writes, the operator formats and, under
``GNNBenchmarker.PROFILE``, the device's busy share (``utils/profiling``).
"""

from __future__ import annotations

import csv
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.bench.datasets import NodeClassificationDataset, load_dataset
from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.structure import DeviceGraph
from protgram_directgcn_torch.graph.transforms import (
    coalesce_coo,
    csr_to_coo_arrays,
    directgcn_propagation_matrix,
    undirected_normalized_matrix,
)
from protgram_directgcn_torch.models.directgcn import (
    DirectGCNConfig,
    directgcn_apply,
    init_directgcn_params,
    param_leaves,
)
from protgram_directgcn_torch.models.mlp import OptaxAdam
from protgram_directgcn_torch.models.zoo import ZOO_MODELS, BaseZooModel
from protgram_directgcn_torch.ops.spmm import (
    BucketedEllAdj,
    CooAdj,
    DenseAdj,
    EllAdj,
    build_adjacency,
)
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils import profiling
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import ensure_dir, logger, write_embeddings
from protgram_directgcn_torch.utils.metrics import MetricLogger

Device = Union[str, torch.device]
_FORMATS = ((DenseAdj, "dense"), (EllAdj, "ell"), (BucketedEllAdj, "bucketed"), (CooAdj, "coo"))


def seeded_split(n: int, ratios: Dict[str, float], seed: int):
    """10/10/80 seeded random split (reference: gnn_benchmarker.py:93-106)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(ratios["train"] * n)
    n_val = int(ratios["val"] * n)
    train = np.zeros(n, bool)
    val = np.zeros(n, bool)
    test = np.zeros(n, bool)
    train[perm[:n_train]] = True
    val[perm[n_train: n_train + n_val]] = True
    test[perm[n_train + n_val:]] = True
    return train, val, test


def _directgcn_device_graph(ds: NodeClassificationDataset, feat_dim: int,
                            normalized: bool = False, device: Device = "cuda") -> DeviceGraph:
    """DirectGCN adapter: ei_out = raw edges (unit weights), ei_in = reversed,
    undirected-norm edges (reference: gnn_benchmarker.py:296-306).
    ``normalized=True``: the sqrt-normalized 𝒜 operators of the n-gram
    pipeline (``directgcn_propagation_matrix``) in place of the raw edges."""
    n = ds.num_nodes
    src = ds.edge_index[0].astype(np.int32)
    tgt = ds.edge_index[1].astype(np.int32)
    ones = np.ones(len(src), np.float32)
    if normalized:
        a_out = coalesce_coo(src, tgt, ones, n)  # A[s, t] = 1 per raw edge
        m_out = directgcn_propagation_matrix(a_out)
        m_in = directgcn_propagation_matrix(a_out.T.tocsr())
        os_, ot, ow = csr_to_coo_arrays(m_out)
        is_, it, iw = csr_to_coo_arrays(m_in)
        p_out = build_adjacency(os_, ot, ow, n, feat_dim=feat_dim, device=device)
        p_in = build_adjacency(is_, it, iw, n, feat_dim=feat_dim, device=device)
    else:
        p_out = build_adjacency(src, tgt, ones, n, feat_dim=feat_dim, device=device)
        p_in = build_adjacency(tgt, src, ones, n, feat_dim=feat_dim, device=device)
    us, ut, uw = csr_to_coo_arrays(undirected_normalized_matrix(src, tgt, n))
    p_und = build_adjacency(us, ut, uw, n, feat_dim=feat_dim, device=device)
    return DeviceGraph(p_in=p_in, p_out=p_out, p_und=p_und, num_nodes=n)


def operator_formats(obj: Any) -> List[str]:
    """The formats of the propagation operators a zoo model or a
    ``DeviceGraph`` holds (GAT's edge lists: "edges")."""
    if isinstance(obj, DeviceGraph):
        ops = [obj.p_in, obj.p_out, obj.p_und]
    elif hasattr(obj, "fwd"):  # TongDiGCN
        ops = [obj.fwd.adj, obj.bwd.adj]
    elif hasattr(obj, "lap"):
        ops = [obj.lap]
    elif hasattr(obj, "adj"):
        ops = [obj.adj]
    else:
        return ["edges"]
    return sorted({next(name for cls, name in _FORMATS if isinstance(op, cls)) for op in ops})


def _map_tree(fn: Callable, tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


# ----------------------------------------------------------------------------
# CSV output (pandas' ``DataFrame(rows).to_csv(index=False)``, without pandas)
# ----------------------------------------------------------------------------


def _column_kind(values: list, missing: bool) -> str:
    """How pandas types a column built from ``values`` (missing cells are
    NaN): "int" (int64), "float" (float64) or "object"."""
    if all(isinstance(v, bool) for v in values):
        return "object" if missing else "bool"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
        if missing or any(isinstance(v, float) for v in values):
            return "float"
        return "int"
    return "object"


def _cell(value: Any, kind: str) -> str:
    if kind == "float":
        value = float(value)
        return "" if math.isnan(value) else repr(value)
    if isinstance(value, float) and math.isnan(value):
        return ""
    return str(value)


def write_rows_csv(rows: List[Dict[str, Any]], path: Union[str, os.PathLike]) -> None:
    """Write ``rows`` as pandas' ``DataFrame(rows).to_csv(path, index=False)``
    does: the columns' union in first-seen order, an empty cell where a row
    lacks a key, an int column with a missing cell written as floats
    (``1.0``), floats by their shortest repr, ``True``/``False``, lists by
    their repr, quoted where needed."""
    columns: List[str] = []
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    kinds = {c: _column_kind([r[c] for r in rows if c in r], any(c not in r for r in rows))
             for c in columns}
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_cell(row[c], kinds[c]) if c in row else "" for c in columns])


# ----------------------------------------------------------------------------
# The benchmark
# ----------------------------------------------------------------------------


class GNNBenchmarker:
    """``run()`` trains every model on every dataset variant on ``device``
    (the card unless the caller asks for the CPU).  Under ``PROFILE`` (set
    on the class by a program that runs the CLI, as chip_smoke.py does)
    each model's training runs under ``torch.profiler``, to read the
    device's busy share."""

    PROFILE = False

    def __init__(self, config: Optional[Config] = None, device: Device = "cuda"):
        self.config = config or Config()
        self.bench = self.config.benchmark
        self.device = resolve_device(device)
        self.stats: Dict[str, Dict[str, dict]] = {}

    # ------------------------------------------------------------------

    def _zoo_configs(self) -> Dict[str, Dict]:
        """Hyperparameters per model (reference: gnn_benchmarker.py:384-392)."""
        return {
            "GCN": dict(cls=ZOO_MODELS["GCN"], params=dict(hidden_dim=256, num_layers=2, dropout_rate=0.5)),
            "GAT": dict(cls=ZOO_MODELS["GAT"], params=dict(hidden_dim=32, heads=8, num_layers=2, dropout_rate=0.6)),
            "GraphSAGE": dict(cls=ZOO_MODELS["GraphSAGE"], params=dict(hidden_dim=256, num_layers=2, dropout_rate=0.5)),
            "GIN": dict(cls=ZOO_MODELS["GIN"], params=dict(hidden_dim=256, num_layers=2, dropout_rate=0.5)),
            "ChebNet": dict(cls=ZOO_MODELS["ChebNet"], params=dict(hidden_dim=256, K=3, num_layers=2, dropout_rate=0.5)),
            "RGCN_SR": dict(cls=ZOO_MODELS["RGCN"], params=dict(hidden_dim=256, num_relations=1, num_layers=2, dropout_rate=0.5)),
            "TongDiGCN": dict(cls=ZOO_MODELS["TongDiGCN"], params=dict(hidden_dim=128, num_layers=2, dropout_rate=0.5)),
        }

    def _to_device(self, params):
        return _map_tree(lambda t: t.to(self.device), params)

    # ------------------------------------------------------------------

    def train_and_evaluate(self, model_name, apply_fn, params, ds, masks, epochs, lr, wd, seed):
        """Masked-CE training with best-val test checkpointing (reference:
        gnn_benchmarker.py:225-286).  ``apply_fn(params, x, train, gen)``
        returns ``(logits, embeddings)``; ``params`` (on the device) are
        trained in place.  Returns ``(best_val, best_test, history,
        best_params)``, ``best_params`` a copy taken at the best epoch."""
        dev = self.device
        train_mask, val_mask, test_mask = (torch.from_numpy(np.asarray(m, np.float32)).to(dev)
                                           for m in masks)
        x = torch.from_numpy(ds.x).to(dev)
        y = torch.from_numpy(ds.y.astype(np.int64)).to(dev)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = OptaxAdam(leaves, lr=lr, weight_decay=wd)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # The masks are constants of the JAX package's jitted step, so XLA
        # turns its divisions by their counts into products with the float32
        # reciprocals; the same here, so accuracies come out bit-equal.
        inv_train, inv_val, inv_test = (torch.reciprocal(torch.clamp(m.sum(), min=1.0))
                                        for m in (train_mask, val_mask, test_mask))

        best_val, best_test = 0.0, 0.0
        best_params = _map_tree(lambda t: t.detach().clone(), params)
        history = []
        for epoch in range(epochs):
            logits, _ = apply_fn(params, x, True, gen)
            logp = F.log_softmax(logits, dim=-1)
            per = -logp.gather(1, y[:, None])[:, 0]
            loss = torch.sum(per * train_mask) * inv_train
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            with torch.no_grad():
                logits, _ = apply_fn(params, x, False, None)
                correct = (torch.argmax(logits, dim=-1) == y).float()
                acc_val = torch.sum(correct * val_mask) * inv_val
                acc_test = torch.sum(correct * test_mask) * inv_test
                loss_f, acc_val, acc_test = torch.stack(
                    [loss.detach(), acc_val, acc_test]).tolist()
            history.append({"epoch": epoch, "loss": loss_f, "val_accuracy": acc_val})
            if acc_val >= best_val:
                best_val = acc_val
                best_test = acc_test
                # The optimizer steps in place: keep a copy, not the leaves.
                best_params = _map_tree(lambda t: t.detach().clone(), params)
        return best_val, best_test, history, best_params

    # ------------------------------------------------------------------

    def _model_runs(self, ds: NodeClassificationDataset):
        """(name, apply_fn, init_fn(seed) -> parameters on the device, the
        operators' formats) for every zoo model and DirectGCN row."""
        num_classes = ds.num_classes
        runs = []
        for name, spec in self._zoo_configs().items():
            model: BaseZooModel = spec["cls"](
                edge_index=ds.edge_index, num_nodes=ds.num_nodes, in_dim=ds.x.shape[1],
                out_dim=num_classes, device=self.device, **spec["params"],
            )
            runs.append((name, model.apply, self._zoo_init(model), operator_formats(model)))

        # DirectGCN adapter (reference: gnn_benchmarker.py:312-335).
        gcn_cfg = self.config.gcn
        layer_dims = tuple([ds.x.shape[1]] + list(gcn_cfg.hidden_layer_dims) + [num_classes])
        common = dict(num_nodes=ds.num_nodes, num_classes=num_classes, n_gram_len=0,
                      one_gram_dim=0, max_pe_len=0, use_vector_coeffs=gcn_cfg.use_vector_coeffs)
        dgraph = _directgcn_device_graph(ds, feat_dim=max(layer_dims), device=self.device)
        rows = [("ProtGramDirectGCN",
                 DirectGCNConfig(layer_dims=layer_dims, dropout=gcn_cfg.dropout_rate, **common),
                 dgraph),
                # Context row: one hidden layer (the deep stack collapses on
                # the raw adjacency).
                ("ProtGramDirectGCN_shallow",
                 DirectGCNConfig(layer_dims=(ds.x.shape[1], 64, num_classes),
                                 dropout=gcn_cfg.dropout_rate, **common),
                 dgraph)]
        if self.bench.normalized_row:
            # Context row: the deep stack on the production 𝒜 operators
            # with a decoder width floor.
            rows.append(("ProtGramDirectGCN_norm",
                         DirectGCNConfig(layer_dims=layer_dims, dropout=self.bench.norm_row_dropout,
                                         decoder_hidden_floor=self.bench.norm_row_decoder_floor,
                                         **common),
                         _directgcn_device_graph(ds, feat_dim=max(layer_dims), normalized=True,
                                                 device=self.device)))
        for name, cfg, graph in rows:
            runs.append((name, self._directgcn_apply(cfg, graph), self._directgcn_init(cfg),
                         operator_formats(graph)))
        return runs

    def _zoo_init(self, model: BaseZooModel):
        # Drawn on the host from the seed, so that the card and the CPU
        # start from the same parameters.
        return lambda seed: self._to_device(model.init_params(torch.Generator().manual_seed(seed)))

    def _directgcn_init(self, cfg: DirectGCNConfig):
        return lambda seed: self._to_device(
            init_directgcn_params(torch.Generator().manual_seed(seed), cfg, device="cpu"))

    @staticmethod
    def _directgcn_apply(cfg: DirectGCNConfig, graph: DeviceGraph):
        # Log-softmax "logits": the loss applies cross-entropy on top, the
        # reference's double log-softmax.
        def apply_fn(p, x, train, gen):
            return directgcn_apply(p, graph, x, cfg, train=train, gen=gen)

        return apply_fn

    def run_on_dataset_variant(self, ds: NodeClassificationDataset, masks, suffix: str,
                               results_dir, epochs: int, seed: int, metrics=None,
                               n_seeds: int = 1) -> List[Dict]:
        """Train every model on one dataset variant.  ``n_seeds > 1`` runs
        each model under seeds ``seed .. seed+n_seeds-1`` (init and, where
        the dataset has no canonical masks, the split re-drawn) and reports
        the mean and std of the test accuracy."""
        results = []
        variant = f"{ds.name}{suffix}"
        stats = self.stats.setdefault(variant, {})
        for name, apply_fn, init_fn, formats in self._model_runs(ds):
            t0 = time.monotonic()
            vals, tests = [], []
            history, best_params = None, None
            prof = profiling.profiler(self.device) if self.PROFILE else None
            try:
                if prof is not None:
                    prof.start()
                for si in range(n_seeds):
                    seed_i = seed + si
                    masks_i = masks
                    if ds.train_mask is None and n_seeds > 1:
                        masks_i = seeded_split(ds.num_nodes, self.bench.split_ratios, seed_i)
                    bv, bt, hist, bp = self.train_and_evaluate(
                        name, apply_fn, init_fn(seed_i), ds, masks_i, epochs=epochs,
                        lr=self.bench.lr, wd=self.bench.weight_decay, seed=seed_i)
                    vals.append(bv)
                    tests.append(bt)
                    if si == 0:
                        history, best_params = hist, bp
            except Exception as e:  # parity with reference's per-model try/except
                logger.exception("model %s failed on %s: %s", name, variant, e)
                results.append({"dataset": variant, "model": name, "error": str(e),
                                "synthetic": bool(ds.synthetic)})
                stats[name] = {"error": str(e), "formats": formats}
                continue
            finally:
                if prof is not None:
                    prof.stop()
            seconds = time.monotonic() - t0
            stats[name] = {"seconds": seconds, "steps": epochs * n_seeds, "formats": formats}
            if prof is not None:
                stats[name]["busy"] = profiling.device_busy(prof, seconds)
            best_val = float(np.mean(vals))
            best_test = float(np.mean(tests))
            test_std = float(np.std(tests))
            logger.info("[%s] %s: best_val=%.4f test=%.4f±%.4f over %d seed(s) (%.1fs)",
                        variant, name, best_val, best_test, test_std, n_seeds, seconds)
            # ``synthetic`` rides every result row into the CSVs so stand-in
            # runs can never read as real-data evidence.
            results.append({
                "dataset": variant, "model": name,
                "best_val_accuracy": best_val, "test_accuracy": best_test,
                "test_accuracy_std": test_std, "n_seeds": n_seeds,
                "seed_test_accuracies": [round(float(t), 4) for t in tests],
                "synthetic": bool(ds.synthetic),
            })
            if metrics is not None:
                metrics.log_metrics({
                    "dataset": variant, "model": name, "best_val_accuracy": best_val,
                    "test_accuracy": best_test, "test_accuracy_std": test_std,
                    "n_seeds": n_seeds, "seconds": time.monotonic() - t0,
                    "synthetic": bool(ds.synthetic),
                })

            t_save = time.monotonic()
            var_dir = ensure_dir(os.path.join(str(results_dir), variant))
            write_rows_csv(history, os.path.join(str(var_dir), f"benchmark_{name}_history.csv"))
            if self.bench.save_embeddings:
                self._save_embeddings(name, apply_fn, best_params, ds, var_dir, seed)
            stats[name]["save_seconds"] = time.monotonic() - t_save
        return results

    def _save_embeddings(self, name, apply_fn, best_params, ds, var_dir, seed) -> None:
        with torch.no_grad():
            _, emb = apply_fn(best_params, torch.from_numpy(ds.x).to(self.device), False, None)
        emb = emb.float().cpu().numpy()
        emb_dict = {f"node_{i}": emb[i].astype(np.float16) for i in range(len(emb))}
        write_embeddings(os.path.join(str(var_dir), f"{name}_node_embeddings.h5"), emb_dict)
        if self.bench.apply_pca_to_embeddings:
            pca = emb_utils.apply_pca(emb_dict, self.bench.pca_target_dim, seed)
            if pca:
                write_embeddings(os.path.join(str(var_dir), f"{name}_node_embeddings_pca.h5"),
                                 pca)

    # ------------------------------------------------------------------

    def run(self, epochs: Optional[int] = None, datasets: Optional[List[str]] = None) -> List[Dict]:
        cfg = self.config
        seed = cfg.random_state
        results_dir = ensure_dir(cfg.paths.benchmarking_results_dir)
        epochs = epochs if epochs is not None else self.bench.epochs
        dataset_names = datasets if datasets is not None else self.bench.node_classification_datasets

        all_results: List[Dict] = []
        # One tracked run for the whole suite (reference: main.py:40-50).
        with MetricLogger(os.path.join(str(results_dir), "run_benchmark"), "gnn_benchmark") as metrics:
            metrics.log_params({
                "datasets": dataset_names, "epochs": epochs, "lr": self.bench.lr,
                "weight_decay": self.bench.weight_decay, "seed": seed,
                "test_on_undirected": self.bench.test_on_undirected,
            })
            for name in dataset_names:
                ds = load_dataset(name, self.bench.dataset_root, seed)
                if ds.train_mask is not None:
                    masks = (ds.train_mask, ds.val_mask, ds.test_mask)
                else:
                    masks = seeded_split(ds.num_nodes, self.bench.split_ratios, seed)
                n_seeds = self.bench.n_seeds if name in self.bench.seed_average_datasets else 1
                all_results += self.run_on_dataset_variant(
                    ds, masks, "_Original", results_dir, epochs, seed, metrics=metrics,
                    n_seeds=n_seeds,
                )
                if self.bench.test_on_undirected:
                    all_results += self.run_on_dataset_variant(
                        ds.undirected(), masks, "_Undirected", results_dir, epochs, seed,
                        metrics=metrics, n_seeds=n_seeds,
                    )
                per_ds = [r for r in all_results if r["dataset"].startswith(name)]
                csv_path = os.path.join(str(results_dir), f"benchmark_summary_{name}.csv")
                write_rows_csv(per_ds, csv_path)
                metrics.log_artifact(f"summary_{name}", csv_path)
            if all_results:
                full_path = os.path.join(str(results_dir), "gnn_benchmark_FULL_SUMMARY.csv")
                write_rows_csv(all_results, full_path)
                metrics.log_artifact("full_summary", full_path)
        return all_results
