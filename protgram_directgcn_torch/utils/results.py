"""Evaluation metrics and reporting: classification and ranking metrics, the
ROC curve, the plots, and the summary with its fold statistics.

Port of protgram_directgcn_tpu/utils/results.py (reference:
src/utils/results_utils.py:19-292).  The JAX package takes f1, precision,
recall, accuracy, ``roc_auc_score`` and ``roc_curve`` from sklearn, which
the card's machine lacks: here they are written in numpy as sklearn 1.9
computes them (binary labels, ``pos_label=1``, ``zero_division=0``; the
ROC curve with ``drop_intermediate=True``; the AUC its trapezoid, NaN when
``y_true`` holds one class).  Wilcoxon and Pearson come from
``scipy.stats``.  matplotlib is optional: where it does not import, each
plot logs once and returns None.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from protgram_directgcn_torch.utils.io import logger


def ranking_metrics(y_true: np.ndarray, y_score: np.ndarray,
                    k_list: Sequence[int]) -> Dict[str, float]:
    """Hits@k (recall@k) and NDCG@k (reference: results_utils.py:40-95)."""
    order = np.argsort(y_score)[::-1]
    sorted_true = np.asarray(y_true, dtype=np.float64)[order]
    metrics: Dict[str, float] = {}
    total_pos = float(np.sum(y_true))
    if total_pos == 0:
        for k in k_list:
            metrics[f"hits_at_{k}"] = 0.0
            metrics[f"ndcg_at_{k}"] = 0.0
        return metrics
    ideal = np.sort(np.asarray(y_true, dtype=np.float64))[::-1]
    for k in k_list:
        ak = min(k, len(sorted_true))
        if ak == 0:
            metrics[f"hits_at_{k}"] = 0.0
            metrics[f"ndcg_at_{k}"] = 0.0
            continue
        metrics[f"hits_at_{k}"] = float(np.sum(sorted_true[:ak]) / total_pos)
        discounts = np.log2(np.arange(1, ak + 1) + 1)
        dcg = float(np.sum(sorted_true[:ak] / discounts))
        idcg = float(np.sum(ideal[:ak] / discounts))
        metrics[f"ndcg_at_{k}"] = dcg / idcg if idcg > 0 else 0.0
    return metrics


def _divide(num: float, den: float) -> float:
    """sklearn's ``_prf_divide`` with ``zero_division=0``."""
    return float(num) / float(den) if den else 0.0


def roc_curve(y_true: np.ndarray, y_score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn 1.9's ``roc_curve(y_true, y_score)`` for labels {0, 1}
    (``drop_intermediate=True``): scores sorted descending (stable), one
    point per distinct score, the collinear points dropped, (0, 0) and an
    infinite threshold prepended; a rate is NaN where its class is absent."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.float64)
    y_score = np.asarray(y_score).ravel()
    if not np.isfinite(y_score).all():
        raise ValueError("Input y_score contains NaN or infinity.")
    n = y_true.size
    # Stable descending order: ties keep their input order.
    desc = (n - 1 - np.argsort(y_score[::-1], kind="stable"))[::-1]
    y_score, y_true = y_score[desc], y_true[desc]
    thresh_idx = np.r_[np.nonzero(np.diff(y_score))[0], n - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresh_idx]
    fps = 1 + thresh_idx.astype(np.float64) - tps
    thresholds = y_score[thresh_idx]
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn 1.9's binary ``roc_auc_score``: the trapezoid under
    :func:`roc_curve`; NaN when ``y_true`` holds one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))  # the trapezoid


def binary_classification_metrics(y_true: np.ndarray, y_proba: np.ndarray,
                                  threshold: float = 0.5) -> Dict[str, float]:
    """AUC / F1 / precision / recall / accuracy, predicting 1 where the
    probability is above ``threshold``."""
    y_true = np.asarray(y_true).ravel()
    y_pred = (np.asarray(y_proba) > threshold).astype(int).ravel()
    pos, pred_pos = y_true == 1, y_pred == 1
    tp = int(np.sum(pos & pred_pos))
    true_sum, pred_sum = int(np.sum(pos)), int(np.sum(pred_pos))
    return {
        "f1": _divide(2.0 * tp, float(true_sum) + float(pred_sum)),
        "precision": _divide(tp, pred_sum),
        "recall": _divide(tp, true_sum),
        "accuracy": float(np.average(y_true == y_pred)),
        "auc": roc_auc_score(y_true, y_proba),
    }


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib does
    not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


class EvaluationReporter:
    """Plots + summary text + fold statistics (reference: results_utils.py:19-292)."""

    def __init__(self, base_output_dir: os.PathLike, k_vals_table: Sequence[int]):
        self.base_output_dir = Path(base_output_dir)
        self.plots_dir = self.base_output_dir / "plots"
        self.plots_dir.mkdir(parents=True, exist_ok=True)
        self.k_vals_table = list(k_vals_table)
        self._told_no_plots = False

    def _plt(self):
        """pyplot, or None, logged once a reporter, where matplotlib is absent."""
        plt = _pyplot()
        if plt is None and not self._told_no_plots:
            logger.info("matplotlib is not installed: the evaluation plots are skipped")
            self._told_no_plots = True
        return plt

    def can_plot(self) -> bool:
        return self._plt() is not None

    # -- plots ---------------------------------------------------------

    def plot_training_history(self, history: Dict[str, List[float]],
                              model_name: str) -> Optional[Path]:
        plt = self._plt()
        if plt is None or not history:
            return None
        path = self.plots_dir / f"history_{model_name.replace(' ', '_')}.png"
        plt.figure(figsize=(12, 5))
        for i, (keys, title) in enumerate(((("loss", "val_loss"), "Loss"),
                                           (("accuracy", "val_accuracy"), "Accuracy"))):
            plt.subplot(1, 2, i + 1)
            for key in keys:
                if history.get(key):
                    plt.plot(history[key], label=key)
            plt.title(f"{title}: {model_name}")
            plt.xlabel("Epoch")
            plt.legend()
            plt.grid(True)
        plt.tight_layout()
        plt.savefig(path)
        plt.close()
        return path

    def plot_roc_curves(self, results_list: List[Dict[str, Any]]) -> Optional[Path]:
        plt = self._plt()
        if plt is None:
            return None
        path = self.plots_dir / "comparison_roc_curves.png"
        plt.figure(figsize=(10, 8))
        plotted = False
        for res in results_list:
            roc = res.get("roc_data_representative")
            if roc is not None and len(roc[0]):
                plt.plot(roc[0], roc[1], lw=2,
                         label=f"{res.get('embedding_name', '?')} (AUC={res.get('test_auc', 0):.4f})")
                plotted = True
        if not plotted:
            plt.close()
            return None
        plt.plot([0, 1], [0, 1], "k--", label="Random")
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.title("ROC Curves Comparison (first fold)")
        plt.legend(loc="lower right")
        plt.grid(True)
        plt.savefig(path)
        plt.close()
        return path

    def plot_comparison_charts(self, results_list: List[Dict[str, Any]]) -> Optional[Path]:
        plt = self._plt()
        if plt is None or not results_list:
            return None
        path = self.plots_dir / "comparison_metrics_barchart.png"
        metrics = {"AUC": "test_auc", "F1": "test_f1", "Precision": "test_precision",
                   "Recall": "test_recall"}
        for k in self.k_vals_table:
            metrics[f"Hits@{k}"] = f"test_hits_at_{k}"
            metrics[f"NDCG@{k}"] = f"test_ndcg_at_{k}"
        names = [r.get("embedding_name", "?") for r in results_list]
        cols = min(3, len(metrics))
        rows = math.ceil(len(metrics) / cols)
        plt.figure(figsize=(cols * 6, rows * 5))
        for i, (title, key) in enumerate(metrics.items()):
            plt.subplot(rows, cols, i + 1)
            plt.bar(names, [r.get(key, 0) for r in results_list])
            plt.title(title)
            plt.xticks(rotation=45, ha="right")
        plt.suptitle("Model Performance Comparison")
        plt.tight_layout()
        plt.savefig(path)
        plt.close()
        return path

    # -- summary -------------------------------------------------------

    def write_summary_file(self, results_list: List[Dict[str, Any]], main_emb_name: str,
                           test_metric: str, alpha: float) -> Optional[Path]:
        """Performance table + Wilcoxon/Pearson statistics
        (reference: results_utils.py:225-292)."""
        from scipy.stats import pearsonr, wilcoxon

        if not results_list:
            return None
        path = self.base_output_dir / "evaluation_summary.txt"
        with open(path, "w") as f:
            f.write("--- Overall Performance Comparison Table (Averaged over Folds) ---\n")
            headers = ["Embedding Name", "AUC", "F1", "Precision", "Recall"]
            for k in self.k_vals_table:
                headers += [f"Hits@{k}", f"NDCG@{k}"]
            headers += ["AUC StdDev", "F1 StdDev"]
            f.write(" | ".join(f"{h:>14}" for h in headers) + "\n")
            for res in results_list:
                row = [f"{res.get('embedding_name', 'N/A'):>14}"]
                for key in ("test_auc", "test_f1", "test_precision", "test_recall"):
                    row.append(f"{res.get(key, 0):>14.4f}")
                for k in self.k_vals_table:
                    row.append(f"{res.get(f'test_hits_at_{k}', 0):>14.4f}")
                    row.append(f"{res.get(f'test_ndcg_at_{k}', 0):>14.4f}")
                row.append(f"{res.get('test_auc_std', 0):>14.4f}")
                row.append(f"{res.get('test_f1_std', 0):>14.4f}")
                f.write(" | ".join(row) + "\n")
            f.write("\n")

            f.write(f"--- Statistical Comparison vs '{main_emb_name}' on '{test_metric}' "
                    f"(alpha={alpha}) ---\n")
            main = next((r for r in results_list if r.get("embedding_name") == main_emb_name),
                        None)
            scores_key = "fold_auc_scores" if test_metric == "test_auc" else "fold_f1_scores"
            if main and main.get(scores_key):
                main_scores = [s for s in main[scores_key] if not np.isnan(s)]
                for other in (r for r in results_list if r.get("embedding_name") != main_emb_name):
                    other_scores = [s for s in other.get(scores_key, []) if not np.isnan(s)]
                    if len(main_scores) == len(other_scores) and len(main_scores) > 1:
                        if np.allclose(main_scores, other_scores):
                            p_val, conclusion = 1.0, "Identical scores"
                        else:
                            _, p_val = wilcoxon(main_scores, other_scores)
                            conclusion = f"Yes (p < {alpha})" if p_val < alpha else "No"
                        if len(np.unique(main_scores)) > 1 and len(np.unique(other_scores)) > 1:
                            r_corr, _ = pearsonr(main_scores, other_scores)
                        else:
                            r_corr = float("nan")
                        f.write(f"{other.get('embedding_name', '?'):<30} | p={p_val:.4e} | "
                                f"{conclusion:<20} | r={r_corr:.4f}\n")
                    else:
                        f.write(f"{other.get('embedding_name', '?'):<30} | N/A (fold mismatch)\n")
            else:
                f.write(f"Could not perform stats: '{main_emb_name}' scores missing.\n")
        logger.info("summary saved to %s", path)
        return path
