"""Port parity: the evaluation metrics, the ROC curve, the splits and the
summary file (``protgram_directgcn_torch/utils/results.py``,
``pipeline/splits.py``).

- ``binary_classification_metrics`` and ``ranking_metrics`` against the JAX
  package's functions (sklearn underneath) on seeded scores with ties, one
  class and all-equal scores: equal to rtol 1e-12 (both float64; NaN where
  sklearn gives NaN).
- ``roc_curve`` against sklearn's, point for point (rtol 1e-12), and the
  thresholds equal.
- ``stratified_kfold`` and ``stratified_train_test_split`` index-equal to
  sklearn's ``StratifiedKFold(shuffle=True)`` and stratified
  ``train_test_split`` over seeds, sizes 10-5,000 and class ratios.
- ``write_summary_file`` byte-equal to the JAX package's on the same
  results, with a fold mismatch, identical scores and a missing main set.
"""

import warnings

import numpy as np
import pytest
from sklearn.metrics import roc_curve as sk_roc_curve
from sklearn.model_selection import StratifiedKFold, train_test_split

from protgram_directgcn_torch.pipeline import splits
from protgram_directgcn_torch.utils import results as t_res
from protgram_directgcn_tpu.utils import results as j_res


def _scores(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.int32)
    if kind == "ties":
        s = np.round(rng.random(n) * 8) / 8  # few distinct values
    elif kind == "one_class":
        y = np.zeros(n, np.int32)
        s = rng.random(n)
    elif kind == "one_class_pos":
        y = np.ones(n, np.int32)
        s = rng.random(n)
    elif kind == "equal":
        s = np.full(n, 0.5)
    elif kind == "separable":
        s = y + rng.random(n) * 0.5
    else:
        s = rng.random(n)
    return y, s.astype(np.float32)


KINDS = ["random", "ties", "one_class", "one_class_pos", "equal", "separable"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [7, 200, 3000])
def test_metrics_match_jax(kind, n):
    y, s = _scores(kind, n, seed=n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_res.binary_classification_metrics(y, s)
    got = t_res.binary_classification_metrics(y, s)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert t_res.ranking_metrics(y, s, [5, 50]) == j_res.ranking_metrics(y, s, [5, 50])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [2, 3, 50, 2000])
def test_roc_curve_matches_sklearn(kind, n):
    y, s = _scores(kind, n, seed=7 * n + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_roc_curve(y, s)
    got = t_res.roc_curve(y, s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 42, 2024])
@pytest.mark.parametrize("n", [10, 37, 500, 5000])
@pytest.mark.parametrize("ratio", [0.5, 0.3, 0.9])
def test_splits_index_equal_to_sklearn(seed, n, ratio):
    y = (np.random.default_rng(seed + n).random(n) < ratio).astype(np.int32)
    y[:2], y[2:4] = 0, 1  # at least two of each class
    if min(np.bincount(y)) >= 5:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = list(StratifiedKFold(5, shuffle=True, random_state=seed)
                        .split(np.zeros(n), y))
        got = splits.stratified_kfold(y, 5, seed)
        assert len(got) == len(want)
        for (g_tr, g_te), (w_tr, w_te) in zip(got, want):
            np.testing.assert_array_equal(g_tr, w_tr)
            np.testing.assert_array_equal(g_te, w_te)
    for test_size in (0.2, 0.33):
        w_tr, w_te = train_test_split(list(range(n)), test_size=test_size,
                                      random_state=seed, stratify=y)
        g_tr, g_te = splits.stratified_train_test_split(y, test_size, seed)
        assert list(g_tr) == list(w_tr) and list(g_te) == list(w_te)


def test_splits_on_string_labels_and_three_classes():
    y = np.array(list("abcabcabcaabbbcccaaabbb" * 3))
    want = list(StratifiedKFold(3, shuffle=True, random_state=5).split(np.zeros(len(y)), y))
    for (g_tr, g_te), (w_tr, w_te) in zip(splits.stratified_kfold(y, 3, 5), want):
        np.testing.assert_array_equal(g_tr, w_tr)
        np.testing.assert_array_equal(g_te, w_te)
    w_tr, w_te = train_test_split(list(range(len(y))), test_size=0.2, random_state=3, stratify=y)
    g_tr, g_te = splits.stratified_train_test_split(y, 0.2, 3)
    assert list(g_tr) == list(w_tr) and list(g_te) == list(w_te)


def test_splits_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError):
        splits.stratified_kfold(np.array([0, 1, 1]), 5, 0)
    with pytest.raises(ValueError):
        splits.stratified_train_test_split(np.array([0, 1, 1, 1, 1]), 0.2, 0)


def _results(rng, names, folds=5):
    out = []
    for name in names:
        aucs = list(rng.random(folds))
        res = {"embedding_name": name, "fold_auc_scores": aucs,
               "fold_f1_scores": list(rng.random(folds))}
        for key in ("auc", "f1", "precision", "recall", "hits_at_50", "ndcg_at_50",
                    "hits_at_100", "ndcg_at_100"):
            res[f"test_{key}"] = float(rng.random())
            res[f"test_{key}_std"] = float(rng.random())
        out.append(res)
    return out


@pytest.mark.parametrize("case", ["plain", "mismatch", "identical", "no_main", "nan"])
def test_summary_file_byte_equal(tmp_path, case):
    rng = np.random.default_rng(3)
    results = _results(rng, ["ProtGramDirectGCN", "ProtGramDirectGCN_PCA", "Word2Vec"])
    main = "ProtGramDirectGCN"
    if case == "mismatch":
        results[2]["fold_auc_scores"] = results[2]["fold_auc_scores"][:3]
    elif case == "identical":
        results[1]["fold_auc_scores"] = list(results[0]["fold_auc_scores"])
    elif case == "no_main":
        main = "Absent"
    elif case == "nan":
        results[1]["fold_auc_scores"][2] = float("nan")
        results[2]["fold_auc_scores"] = [0.5] * 5
    paths = []
    for mod, sub in ((t_res, "t"), (j_res, "j")):
        rep = mod.EvaluationReporter(tmp_path / sub, [50, 100])
        paths.append(rep.write_summary_file(results, main, "test_auc", 0.05))
    t_bytes, j_bytes = (p.read_bytes() for p in paths)
    assert t_bytes == j_bytes
    assert b"Statistical Comparison" in t_bytes


def test_plots_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib does not import, every plot returns None."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    rep = t_res.EvaluationReporter(tmp_path, [50])
    res = _results(np.random.default_rng(0), ["A"])
    res[0]["roc_data_representative"] = (np.array([0.0, 1.0]), np.array([0.0, 1.0]))
    assert not rep.can_plot()
    assert rep.plot_training_history({"loss": [1.0]}, "A") is None
    assert rep.plot_roc_curves(res) is None
    assert rep.plot_comparison_charts(res) is None
    assert rep.write_summary_file(res, "A", "test_auc", 0.05).exists()
