"""Train/val/test split generation.

Port of ``grandtpu/data/splits.py`` (reference
``utils/make_dataset.py:58-136``): the per-class (stratified) draws and the
size-based ones, with the identical RandomState call order, so the same
seed gives the same node splits as ``grandtpu``.
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
                             train_examples_per_class: int | None = None,
                             val_examples_per_class: int | None = None,
                             train_size: int | None = None,
                             val_size: int | None = None):
    """Per-class draws where ``*_examples_per_class`` is given, else
    ``*_size`` nodes drawn from those left; every other node is test."""
    num_samples = labels.shape[0]
    all_indices = np.arange(num_samples)
    if train_examples_per_class is not None:
        train = sample_per_class(random_state, labels,
                                 train_examples_per_class)
    else:
        train = random_state.choice(list(range(num_samples)), train_size,
                                    replace=False)
    if val_examples_per_class is not None:
        val = sample_per_class(random_state, labels, val_examples_per_class,
                               forbidden_indices=train)
    else:
        val = random_state.choice(np.setdiff1d(all_indices, train), val_size,
                                  replace=False)
    test = np.setdiff1d(all_indices, np.concatenate((train, val)))
    _check_split(labels, train, val, test,
                 (train_examples_per_class, val_examples_per_class))
    return train, val, test


def _check_split(labels, train, val, test, per_class) -> None:
    """grandtpu's split invariants (reference
    ``utils/make_dataset.py:89-116``), raised as ValueError: no duplicate
    and no shared ids, every node in a part, and the same count in every
    class of a per-class part (``per_class``: the train and val counts,
    None where the part was drawn by size)."""
    parts = (train, val, test)
    sets = [set(p.tolist()) for p in parts]
    if any(len(s) != len(p) for s, p in zip(sets, parts)):
        raise ValueError("split: duplicate ids in a part")
    if sets[0] & sets[1] or sets[0] & sets[2] or sets[1] & sets[2]:
        raise ValueError("split: the parts overlap")
    if sum(len(p) for p in parts) != labels.shape[0]:
        raise ValueError("split: the parts do not cover every node")
    for part, count in zip(parts, per_class):
        if count is not None and np.unique(
                labels[part].sum(axis=0)).size != 1:
            raise ValueError("stratified split is not one draw per class "
                             f"of {count} distinct nodes")
