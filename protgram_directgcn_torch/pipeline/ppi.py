"""PPI link-prediction evaluation: stratified k-fold CV of an MLP over each
embedding set, and the quick sanity check after GCN training.

Port of protgram_directgcn_tpu/pipeline/ppi.py:40-482 (reference:
src/pipeline/ppi_main.py).  The pairs, folds, batch orders, class weights,
early stopping, metrics and files are the JAX package's; sklearn's splits,
metrics and ROC curve are the port's numpy versions (``splits.py``,
``utils/results.py``).

Card-side layout: while an embedding set's vectors fit
``eval.max_in_memory_feature_bytes``, they go to the device once as one
float16 ``[P, D]`` table and the usable pairs become two index tensors;
each batch's edge features are gathered and combined on the device
(``embeddings.edge_features``) in the batch order of the numpy
``default_rng`` permutation the JAX package draws.  Above that budget the
vectors stay in the store behind a host LRU cache and each batch is built
on the host, as in the JAX package's streaming path, then moved to the
device.  Either way the numbers are those of the JAX package's float16
feature matrix.

Discovery reads ``.npz`` embedding files as well as ``.h5``: where h5py is
absent, as on the card's machine, the trainer and the Word2Vec stage write
``.npz``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.models.mlp import MLPConfig, MLPTrainer
from protgram_directgcn_torch.pipeline.splits import stratified_kfold, stratified_train_test_split
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils import io as uio
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import logger
from protgram_directgcn_torch.utils.metrics import MetricLogger
from protgram_directgcn_torch.utils.results import (
    EvaluationReporter,
    binary_classification_metrics,
    ranking_metrics,
    roc_curve,
)

Pair = Tuple[str, str, int]

# Files of the embeddings directories that hold no per-protein vectors.
_NOT_EMBEDDINGS = ("word2vec_model_",)


def create_dummy_data(out_dir: os.PathLike, num_proteins: int = 50, dim: int = 16,
                      num_pairs: int = 100, seed: int = 42):
    """Synthetic embeddings file + random pos/neg pairs (reference:
    ppi_main.py:40-65); returns (embeddings path, positive path, negative
    path).  The embeddings are ``.npz`` where h5py is absent."""
    rng = np.random.default_rng(seed)
    uio.ensure_dir(out_dir)
    ids = [f"DUMMY_P{i:04d}" for i in range(num_proteins)]
    emb_path = uio.write_embeddings(os.path.join(str(out_dir), "dummy_embeddings.h5"),
                                    {pid: rng.normal(size=dim).astype(np.float16) for pid in ids})
    paths = []
    for kind in ("positive", "negative"):
        path = os.path.join(str(out_dir), f"dummy_{kind}.csv")
        with open(path, "w") as f:
            for _ in range(num_pairs):
                a, b = rng.choice(ids, 2, replace=False)
                f.write(f"{a},{b}\n")
        paths.append(path)
    return emb_path, paths[0], paths[1]


class _LRUVectors:
    """Byte-bounded LRU cache over an open EmbeddingStore: vectors page in
    on a miss and the least recently used page out."""

    def __init__(self, store, capacity_bytes: int):
        self._store = store
        self._cap = max(1, int(capacity_bytes))
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0

    def __getitem__(self, pid: str) -> np.ndarray:
        v = self._cache.get(pid)
        if v is not None:
            self._cache.move_to_end(pid)
            return v
        v = self._store[pid]
        self._cache[pid] = v
        self._bytes += v.nbytes
        while self._bytes > self._cap and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._bytes -= old.nbytes
        return v

    def __contains__(self, pid: str) -> bool:
        return pid in self._cache or pid in self._store

    def get(self, pid: str, default=None):
        try:
            return self[pid]
        except KeyError:
            return default


def _device_table(store, ids: Sequence[str], device: torch.device) -> torch.Tensor:
    """The float16 vectors of ``ids``, in that order, as one ``[P, D]``
    tensor on ``device``."""
    return torch.from_numpy(np.stack([store[pid] for pid in ids])).to(device)


def _pair_index(pairs: Sequence[Pair], row: Dict[str, int], device: torch.device):
    """The two rows of each pair's proteins, as int64 tensors on ``device``."""
    ia = np.fromiter((row[a] for a, _, _ in pairs), np.int64, count=len(pairs))
    ib = np.fromiter((row[b] for _, b, _ in pairs), np.int64, count=len(pairs))
    return torch.from_numpy(ia).to(device), torch.from_numpy(ib).to(device)


class PPIPipeline:
    """``run`` evaluates every embedding set; ``stats[name]`` keeps each
    set's wall seconds, MLP steps and the seconds inside ``fit_epoch``."""

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.stats: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------

    def _discover_embedding_files(self) -> List[Dict[str, Any]]:
        """The embeddings files earlier stages wrote (``.h5`` or ``.npz``),
        when no explicit registry was configured (reference:
        config.py:143-148)."""
        paths = self.config.paths
        found: List[Dict[str, Any]] = []
        sources = [
            (paths.gcn_embeddings_dir, "ProtGramDirectGCN"),
            (paths.word2vec_embeddings_dir, "Word2Vec"),
            (paths.transformer_embeddings_dir, "Transformer"),
        ]
        taken = set()
        for directory, base_name in sources:
            if not directory.is_dir():
                continue
            files = sorted(p for pattern in ("*.h5", "*.npz") for p in directory.glob(pattern)
                           if not p.name.startswith(_NOT_EMBEDDINGS))
            for path in files:
                suffix = "_PCA" if "pca" in path.stem.lower() else ""
                name = f"{base_name}{suffix}"
                if name in taken:
                    name = f"{base_name}:{path.stem}"
                taken.add(name)
                found.append({"name": name, "path": path})
        if found:
            logger.info("auto-discovered %d embedding sets for PPI evaluation: %s",
                        len(found), [f["name"] for f in found])
        return found

    def _load_pairs(self, use_dummy_data: bool, dummy_dir: Optional[os.PathLike]
                    ) -> Tuple[List[Pair], List[Dict[str, Any]]]:
        cfg = self.config
        if use_dummy_data:
            emb, pos, neg = create_dummy_data(
                dummy_dir or (cfg.paths.base_output_dir / "dummy_ppi"), seed=cfg.random_state)
            embedding_files = [{"name": "DummyEmbeddings", "path": emb}]
            pos_pairs = uio.load_interaction_pairs(pos, 1)
            neg_pairs = uio.load_interaction_pairs(neg, 0)
        else:
            embedding_files = cfg.eval.embedding_files_to_evaluate
            if not embedding_files:
                embedding_files = self._discover_embedding_files()
            pos_pairs = []
            for batch in uio.stream_interaction_pairs(cfg.paths.interactions_positive, 1, 8192):
                pos_pairs.extend(batch)
            neg_pairs = []
            for batch in uio.stream_interaction_pairs(
                cfg.paths.interactions_negative, 0, 8192,
                sample_n=cfg.eval.sample_negative_pairs, random_state=cfg.random_state,
            ):
                neg_pairs.extend(batch)
        pairs = pos_pairs + neg_pairs
        rng = np.random.default_rng(cfg.random_state)
        rng.shuffle(pairs)
        return pairs, embedding_files

    # ------------------------------------------------------------------

    def _evaluate_embedding(self, name: str, path: os.PathLike, pairs: Sequence[Pair],
                            reporter: Optional[EvaluationReporter] = None,
                            metrics: Optional[MetricLogger] = None) -> Optional[Dict[str, Any]]:
        if self.config.eval.perform_h5_integrity_check and not uio.check_h5_integrity(path):
            logger.warning("[%s] H5 integrity check failed (%s)", name, path)
        needed = {p for a, b, _ in pairs for p in (a, b)}
        t0 = time.monotonic()
        with uio.EmbeddingStore(path) as store:
            result = self._evaluate_with_store(name, store, pairs, needed, reporter, metrics)
        self.stats.setdefault(name, {})["seconds"] = time.monotonic() - t0
        return result

    def _batch_source(self, name: str, store, usable: Sequence[Pair], available, dim: int,
                      feat_dim: int, labels: np.ndarray):
        """``batches_for(indices, shuffle_rng=None)``: (features float16,
        labels float32) device batches of ``usable[indices]``, permuted by
        ``shuffle_rng`` when given (ppi.py:211-257): gathered on the device
        from the vector table while the vectors fit the byte budget, else
        built on the host from the LRU-cached store."""
        ev, dev = self.config.eval, self.device
        bs, method = ev.batch_size, ev.edge_embedding_method
        vec_bytes = len(available) * dim * 2
        if vec_bytes <= ev.max_in_memory_feature_bytes:
            y_dev = torch.from_numpy(labels.astype(np.float32)).to(dev)
            ids = sorted(available)
            table = _device_table(store, ids, dev)
            ia, ib = _pair_index(usable, {pid: i for i, pid in enumerate(ids)}, dev)

            def batches_for(indices, shuffle_rng=None):
                idx = np.asarray(indices)
                if shuffle_rng is not None:
                    idx = shuffle_rng.permutation(idx)
                idx = torch.from_numpy(idx).to(dev)
                for i in range(0, len(idx), bs):
                    sel = idx[i : i + bs]
                    yield emb_utils.edge_features(table[ia[sel]], table[ib[sel]], method), y_dev[sel]

            return batches_for

        logger.info("[%s] vector store stays on disk (%d vectors x %d dims = %.2f GB exceeds "
                    "the %.1f GB budget); LRU-cached access", name, len(available), dim,
                    vec_bytes / 1e9, ev.max_in_memory_feature_bytes / 1e9)
        vectors = _LRUVectors(store, ev.max_in_memory_feature_bytes // 2)

        def batches_for(indices, shuffle_rng=None):
            idx = np.asarray(indices)
            if shuffle_rng is not None:
                idx = shuffle_rng.permutation(idx)
            for bx, by in emb_utils.generate_edge_features_batched(
                    [usable[i] for i in idx], vectors, method, bs, dim):
                yield (torch.from_numpy(bx).to(dev),
                       torch.from_numpy(by.astype(np.float32)).to(dev))

        return batches_for

    def _evaluate_with_store(self, name: str, store, pairs: Sequence[Pair], needed,
                             reporter: Optional[EvaluationReporter],
                             metrics: Optional[MetricLogger]) -> Optional[Dict[str, Any]]:
        cfg = self.config
        ev = cfg.eval
        available = store.get_keys() & needed
        usable = [p for p in pairs if p[0] in available and p[1] in available]
        logger.info("[%s] usable pairs: %d/%d", name, len(usable), len(pairs))
        if len(usable) < 10:
            logger.error("[%s] too few usable pairs; skipping", name)
            return None
        dim = store[next(iter(available))].shape[0]
        feat_dim = dim * 2 if ev.edge_embedding_method == "concatenate" else dim
        labels = np.fromiter((y for _, _, y in usable), dtype=np.int32, count=len(usable))
        batches_for = self._batch_source(name, store, usable, available, dim, feat_dim, labels)
        stats = self.stats.setdefault(name, {})
        stats.update(steps=0, fit_seconds=0.0)

        folds = stratified_kfold(labels, ev.n_folds, cfg.random_state)
        fold_metrics: List[Dict[str, float]] = []
        roc_repr = None
        rng = np.random.default_rng(cfg.random_state)
        # The history is only plotted: skip its per-epoch test-fold pass
        # where no plot can be drawn.
        plot_history = ev.plot_training_history and reporter is not None and reporter.can_plot()
        for fold_i, (tr, te) in enumerate(folds):
            if ev.standardize_features:
                # Train-fold mean/std in one pass (float64 sums), applied to
                # every batch of this fold (ppi.py:264-287).
                s = torch.zeros(feat_dim, dtype=torch.float64, device=self.device)
                ss = torch.zeros_like(s)
                cnt = 0
                for bx, _ in batches_for(tr):
                    b = bx.double()
                    s += b.sum(0)
                    ss += (b * b).sum(0)
                    cnt += len(b)
                mean = s / max(cnt, 1)
                mu = mean.float()
                sd = torch.sqrt(torch.clamp(ss / max(cnt, 1) - mean ** 2, min=0.0)).float()
                sd[sd < 1e-6] = 1.0

                def fold_batches(indices, shuffle_rng=None, _mu=mu, _sd=sd):
                    for bx, by in batches_for(indices, shuffle_rng):
                        yield (bx.float() - _mu) / _sd, by
            else:
                fold_batches = batches_for
            y_tr = labels[tr]
            # Class weights n / (2 * count_c), sklearn's 'balanced' (ppi_main.py:113-121).
            counts = np.bincount(y_tr, minlength=2)
            cw = {c: len(y_tr) / (2.0 * counts[c]) if counts[c] else 1.0 for c in (0, 1)}
            trainer = MLPTrainer(
                MLPConfig(input_dim=feat_dim, dense1_units=ev.mlp_dense1_units,
                          dropout1_rate=ev.mlp_dropout1_rate, dense2_units=ev.mlp_dense2_units,
                          dropout2_rate=ev.mlp_dropout2_rate, l2_reg=ev.mlp_l2_reg,
                          learning_rate=ev.learning_rate),
                seed=cfg.random_state + fold_i, device=self.device)
            best = float("inf")
            patience = 0
            history: Dict[str, List[float]] = {"loss": [], "val_accuracy": []}

            def predict_over(indices):
                probs = [trainer.predict_proba_tensor(b) for b, _ in fold_batches(indices)]
                return torch.cat(probs).cpu().numpy() if probs else np.zeros(0, np.float32)

            for _ in range(ev.epochs):
                t_fit = time.monotonic()
                loss = trainer.fit_epoch(fold_batches(tr, shuffle_rng=rng), cw)
                stats["fit_seconds"] += time.monotonic() - t_fit
                history["loss"].append(float(loss))
                if plot_history:
                    history["val_accuracy"].append(
                        float(((predict_over(te) >= 0.5) == labels[te]).mean()))
                if loss < best - 1e-6:
                    best, patience = loss, 0
                else:
                    patience += 1
                    if patience >= ev.early_stopping_patience:
                        break
            stats["steps"] += trainer.steps
            proba = predict_over(te)
            m = binary_classification_metrics(labels[te], proba)
            m.update(ranking_metrics(labels[te], proba, ev.k_values_for_table))
            fold_metrics.append(m)
            if fold_i == 0:
                fpr, tpr, _ = roc_curve(labels[te], proba)
                roc_repr = (fpr, tpr)
            logger.info("[%s] fold %d: auc=%.4f f1=%.4f", name, fold_i + 1, m["auc"], m["f1"])
            if metrics is not None:
                metrics.log_metrics({"embedding": name, "fold": fold_i + 1, **m})
            if plot_history:
                path = reporter.plot_training_history(history, f"{name}_fold{fold_i + 1}")
                if metrics is not None and path is not None:
                    metrics.log_artifact(f"history_{name}_fold{fold_i + 1}", path)

        result: Dict[str, Any] = {"embedding_name": name, "n_folds": len(fold_metrics)}
        for key in fold_metrics[0]:
            vals = np.array([m[key] for m in fold_metrics], dtype=np.float64)
            result[f"test_{key}"] = float(np.nanmean(vals))
            result[f"test_{key}_std"] = float(np.nanstd(vals))
        result["fold_auc_scores"] = [m["auc"] for m in fold_metrics]
        result["fold_f1_scores"] = [m["f1"] for m in fold_metrics]
        result["roc_data_representative"] = roc_repr
        return result

    # ------------------------------------------------------------------

    def run(self, use_dummy_data: bool = False, output_dir: Optional[os.PathLike] = None,
            dummy_dir: Optional[os.PathLike] = None) -> List[Dict[str, Any]]:
        """Evaluate every embedding set; write ``ppi_results.json``,
        ``evaluation_summary.txt``, the plots (where matplotlib imports) and
        the run log ``run_ppi/`` under ``output_dir``; return the results."""
        cfg = self.config
        t0 = time.monotonic()
        output_dir = uio.ensure_dir(output_dir or cfg.paths.evaluation_results_dir)
        pairs, embedding_files = self._load_pairs(use_dummy_data, dummy_dir)
        logger.info("PPI evaluation on %d pairs, %d embedding sets", len(pairs),
                    len(embedding_files))
        reporter = EvaluationReporter(output_dir, cfg.eval.k_values_for_table)
        results = []
        with MetricLogger(os.path.join(str(output_dir), "run_ppi"), "ppi_eval") as metrics:
            metrics.log_params({
                "n_pairs": len(pairs), "n_folds": cfg.eval.n_folds,
                "edge_embedding_method": cfg.eval.edge_embedding_method,
                "embedding_sets": [str(e["name"]) for e in embedding_files],
                "use_dummy_data": use_dummy_data,
            })
            for entry in embedding_files:
                name, path = entry["name"], entry["path"]
                if not os.path.exists(str(path)):
                    logger.warning("[%s] embedding file missing: %s", name, path)
                    continue
                res = self._evaluate_embedding(name, path, pairs, reporter=reporter,
                                               metrics=metrics)
                if res:
                    results.append(res)

            if results:
                main_name = (
                    cfg.eval.main_embedding_for_stats
                    if any(r["embedding_name"] == cfg.eval.main_embedding_for_stats for r in results)
                    else results[0]["embedding_name"]
                )
                reporter.write_summary_file(results, main_name, "test_auc",
                                            cfg.eval.statistical_test_alpha)
                reporter.plot_roc_curves(results)
                reporter.plot_comparison_charts(results)
                serializable = [{k: v for k, v in r.items() if k != "roc_data_representative"}
                                for r in results]
                json_path = os.path.join(str(output_dir), "ppi_results.json")
                with open(json_path, "w") as f:
                    json.dump(serializable, f, indent=2)
                metrics.log_artifact("ppi_results", json_path)
                metrics.log_artifact("plots_dir", reporter.plots_dir)
        if use_dummy_data and cfg.stages.cleanup_dummy_data:
            dummy_root = str(dummy_dir or (cfg.paths.base_output_dir / "dummy_ppi"))
            if os.path.isdir(dummy_root):
                shutil.rmtree(dummy_root, ignore_errors=True)
                logger.info("cleaned up dummy data at %s", dummy_root)
        logger.info("PPI evaluation finished in %.1fs", time.monotonic() - t0)
        return results


def run_sanity_check_ppi(config: Config, embedding_path: os.PathLike, device="cuda",
                         stats: Optional[Dict[str, float]] = None) -> Optional[Dict[str, float]]:
    """Quick post-training PPI check (reference:
    protgram_directgcn_trainer.py:428-486): the negatives sampled to the
    positives' count, one stratified split of ``gcn.sanity_check_test_split``,
    a [2D -> 64 -> 32 -> 1] MLP (dropout 0.5) trained
    ``gcn.sanity_check_epochs`` epochs on the concatenated pair vectors in
    the split's order; returns the test metrics, or None when skipped.
    ``stats``, when given, receives the pair counts, steps and seconds."""
    cfg = config
    t0 = time.monotonic()
    if embedding_path is None or not os.path.exists(str(embedding_path)):
        logger.info("sanity check skipped: embedding file missing")
        return None
    dev = resolve_device(device)
    pos = uio.load_interaction_pairs(cfg.paths.interactions_positive, 1)
    neg = uio.load_interaction_pairs(cfg.paths.interactions_negative, 0, sample_n=len(pos),
                                      random_state=cfg.random_state)
    pairs = pos + neg
    if not pairs:
        logger.info("sanity check skipped: no interaction pairs")
        return None
    rng = np.random.default_rng(cfg.random_state)
    rng.shuffle(pairs)
    with uio.EmbeddingStore(embedding_path) as store:
        usable = [p for p in pairs if p[0] in store and p[1] in store]
        if len(usable) < 10:
            logger.info("sanity check skipped: only %d usable pairs", len(usable))
            return None
        ids = sorted({pid for p in usable for pid in p[:2]})
        table = _device_table(store, ids, dev)
    ia, ib = _pair_index(usable, {pid: i for i, pid in enumerate(ids)}, dev)
    labels = np.array([p[2] for p in usable], dtype=np.int32)
    train, test = stratified_train_test_split(labels, cfg.gcn.sanity_check_test_split,
                                              cfg.random_state)
    dim = table.shape[1]
    trainer = MLPTrainer(
        MLPConfig(input_dim=dim * 2, dense1_units=64, dropout1_rate=0.5, dense2_units=32,
                  dropout2_rate=0.5, l2_reg=1e-5, learning_rate=cfg.eval.learning_rate),
        seed=cfg.random_state, device=dev)
    y = torch.from_numpy(labels.astype(np.float32)).to(dev)
    train_t = torch.from_numpy(train).to(dev)
    bs = cfg.eval.batch_size

    def features(sel):
        return emb_utils.edge_features(table[ia[sel]], table[ib[sel]], "concatenate")

    t_fit = time.monotonic()
    for _ in range(cfg.gcn.sanity_check_epochs):
        trainer.fit_epoch((features(train_t[i : i + bs]), y[train_t[i : i + bs]])
                          for i in range(0, len(train), bs))
    fit_seconds = time.monotonic() - t_fit
    proba = trainer.predict_proba(features(torch.from_numpy(test).to(dev)))
    metrics = binary_classification_metrics(labels[test], proba)
    logger.info("sanity-check PPI: AUC=%.4f F1=%.4f P=%.4f R=%.4f",
                metrics["auc"], metrics["f1"], metrics["precision"], metrics["recall"])
    if stats is not None:
        stats.update(pairs=len(usable), train_pairs=len(train), test_pairs=len(test),
                     steps=trainer.steps, fit_seconds=fit_seconds,
                     seconds=time.monotonic() - t0)
    return metrics
