"""A frozen copy of the port's `train/data.py`, the reference's own:
episode sampling for fine-tuning, and the scikit-learn splitters it needs.

Semantics anchor: reference `scripts_finetune_mm/training_utils/data_utils.py:16-232`
(and the JAX package's `multimodalpfn_tpu/train/data.py`): one training step
consumes one StratifiedKFold split of the whole train set, from an endless
reshuffled fold stream, with the test fold equalized to ``n // n_splits`` rows
so shapes are constant.

The port imports no scikit-learn (the machine with the card has none): the
splitters below are numpy copies of scikit-learn 1.9.0's
``StratifiedKFold`` (``shuffle=True``) and stratified ``train_test_split``
(``StratifiedShuffleSplit`` with ``_approximate_mode``), the classifier's
two. For the same
``random_state`` they give the same indices, draw for draw, so the port trains
on the episodes the JAX package trains on (`tests/test_torch_finetune.py`).
"""

from __future__ import annotations

from math import ceil
from typing import Iterator

import numpy as np

RANDOM_SEED = 4213


def _random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: an int seeds a new RandomState,
    a RandomState is used (and advanced) as it is."""
    if isinstance(seed, np.random.RandomState):
        return seed
    if seed is None:
        return np.random.mtrand._rand
    return np.random.RandomState(seed)


def stratified_kfold_split(
    y: np.ndarray, n_splits: int, random_state
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """``StratifiedKFold(n_splits, shuffle=True, random_state).split``: the
    classes are encoded in order of first appearance, each class's fold sizes
    come from a round robin over the sorted encoded labels, and each class's
    fold ids are shuffled by one RandomState (`_make_test_folds`)."""
    rng = _random_state(random_state)
    y = np.asarray(y).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)]
    )
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        test = test_folds == i
        yield indices[~test], indices[test]


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``_approximate_mode``: the floored proportional counts,
    then one more for the largest remainders, ties broken by ``rng``."""
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


def stratified_train_test_split(y: np.ndarray, test_size: float, random_state) -> tuple[np.ndarray, np.ndarray]:
    """The (train, test) indices of ``train_test_split(..., test_size,
    random_state, stratify=y)`` for a float ``test_size`` in (0, 1): one
    ``StratifiedShuffleSplit`` draw."""
    y = np.asarray(y)
    n = len(y)
    n_test = ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train and test sizes ({n_train}, {n_test}) must cover the {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = _random_state(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


class EpisodeSampler:
    """The endless fold stream of the JAX package's `train/data.py` for a
    classifier: each step takes the next fold of a
    ``StratifiedKFold(n_splits, shuffle=True)``
    whose ``random_state`` is drawn from ``RandomState(seed)`` per pass."""

    def __init__(
        self,
        *,
        X: np.ndarray | None,
        image: np.ndarray | None,
        y: np.ndarray,
        n_splits: int = 10,
        seed: int = RANDOM_SEED,
    ):
        assert X is not None or image is not None
        self.X, self.image, self.y = X, image, y
        self.n_splits = n_splits
        self._rng = np.random.RandomState(seed)
        self._stream = self._fold_stream()
        n = len(y)
        self.test_size = n // n_splits
        self.train_size = n - self.test_size

    def _fold_stream(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            state = int(self._rng.randint(0, np.iinfo(np.int32).max))
            yield from stratified_kfold_split(self.y, self.n_splits, state)

    def episode_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """Next fold, with the test fold equalized to ``test_size`` rows
        (reference `data_utils.py:127-136`)."""
        train_idx, test_idx = next(self._stream)
        if len(test_idx) != self.test_size:
            cut = len(test_idx) - self.test_size
            train_idx = np.concatenate([train_idx, test_idx[:cut]])
            test_idx = test_idx[cut:]
        return train_idx, test_idx
