"""Stratified train/val/test split.

Port of the per-class branch of ``grandtpu/data/splits.py`` (reference
``utils/make_dataset.py:58-136``), with the identical RandomState call
order, so the same seed gives the same node splits as ``grandtpu``.
"""

from __future__ import annotations

import numpy as np


def sample_per_class(random_state: np.random.RandomState,
                     labels: np.ndarray, num_examples_per_class: int,
                     forbidden_indices=None) -> np.ndarray:
    """Draw ``num_examples_per_class`` node ids per class, skipping
    forbidden ones; candidates in (class, node-id) order."""
    forbidden = set() if forbidden_indices is None else set(
        np.asarray(forbidden_indices).tolist())
    picks = []
    for c in range(labels.shape[1]):
        members = np.nonzero(labels[:, c] > 0.0)[0]
        if forbidden:
            members = np.array(
                [m for m in members.tolist() if m not in forbidden],
                dtype=np.int64)
        picks.append(random_state.choice(
            members, num_examples_per_class, replace=False))
    return np.concatenate(picks)


def get_train_val_test_split(random_state: np.random.RandomState,
                             labels: np.ndarray,
                             train_examples_per_class: int,
                             val_examples_per_class: int):
    """Per-class train and val draws; every other node is test."""
    train = sample_per_class(random_state, labels, train_examples_per_class)
    val = sample_per_class(random_state, labels, val_examples_per_class,
                           forbidden_indices=train)
    test = np.setdiff1d(np.arange(labels.shape[0]),
                        np.concatenate((train, val)))
    for part, per_class in ((train, train_examples_per_class),
                            (val, val_examples_per_class)):
        if len(set(part.tolist())) != len(part) or np.unique(
                labels[part].sum(axis=0)).size != 1:
            raise ValueError("stratified split is not one draw per class "
                             f"of {per_class} distinct nodes")
    return train, val, test
