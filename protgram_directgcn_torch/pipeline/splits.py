"""Stratified k-fold and stratified train/test splits, as sklearn 1.9
computes them.

The JAX package's PPI evaluation calls sklearn's
``StratifiedKFold(n_splits, shuffle=True, random_state=seed)`` (ppi.py:60-64)
and ``train_test_split(..., stratify=labels)`` (ppi.py:451-454).  sklearn is
absent on the card's machine, and the fold contents decide every metric, so
these are sklearn's algorithms step for step in numpy, drawing from
``RandomState(seed)`` in sklearn's order: the same indices for the same
labels and seed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def stratified_kfold(y: Sequence, n_splits: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``list(StratifiedKFold(n_splits, shuffle=True, random_state=seed)
    .split(zeros, y))``: classes numbered by first appearance, each class's
    test-fold sizes dealt round robin over the sorted labels, and each
    class's block of fold numbers shuffled by one ``RandomState(seed)``."""
    y = np.asarray(y)
    rng = np.random.RandomState(seed)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.ravel()]
    n_classes = len(y_idx)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of samples: n_samples={len(y)}.")
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    return [(indices[test_folds != i], indices[test_folds == i]) for i in range(n_splits)]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: the floored shares, the remainder
    handed out by largest leftover, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(y: Sequence, test_size: float, seed: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """The (train, test) indices of ``train_test_split(range(len(y)),
    test_size=test_size, random_state=seed, stratify=y)`` (sklearn's
    ``StratifiedShuffleSplit``): ceil(test_size * n) test samples, per-class
    counts by :func:`_approximate_mode`, each class permuted, then both
    index lists permuted, all from one ``RandomState(seed)``."""
    y = np.asarray(y)
    n = len(y)
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size}, the resulting "
                         "train set will be empty.")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError("train and test sizes must each be at least the number of classes")
    class_indices = np.split(np.argsort(y_indices.ravel(), kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
