"""Episode sampling for fine-tuning, and the scikit-learn splitters it needs.

Semantics anchor: reference `scripts_finetune_mm/training_utils/data_utils.py:16-232`
(and the JAX package's `multimodalpfn_tpu/train/data.py`): one training step
consumes one (Stratified)KFold split of the whole train set, from an endless
reshuffled fold stream, with the test fold equalized to ``n // n_splits`` rows
so shapes are constant.

The port imports no scikit-learn (the machine with the card has none): the
splitters below are numpy copies of scikit-learn 1.9.0's ``KFold``,
``StratifiedKFold`` (``shuffle=True``) and ``train_test_split``, stratified
(``StratifiedShuffleSplit`` with ``_approximate_mode``) or not
(``ShuffleSplit``). For the same
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


def kfold_split(n_samples: int, n_splits: int, random_state) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """``KFold(n_splits, shuffle=True, random_state).split``: shuffled indices
    cut into ``n_splits`` consecutive folds, the first ``n % n_splits`` one
    larger; each fold's test indices come back sorted."""
    if n_splits > n_samples:
        raise ValueError(f"n_splits={n_splits} is greater than the number of samples {n_samples}")
    indices = np.arange(n_samples)
    _random_state(random_state).shuffle(indices)
    sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    sizes[: n_samples % n_splits] += 1
    current = 0
    all_idx = np.arange(n_samples)
    for size in sizes:
        mask = np.zeros(n_samples, dtype=bool)
        mask[indices[current : current + size]] = True
        current += size
        yield all_idx[~mask], all_idx[mask]


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


def train_test_split_indices(n_samples: int, test_size: float, random_state) -> tuple[np.ndarray, np.ndarray]:
    """The (train, test) indices of ``train_test_split(..., test_size,
    random_state)`` without ``stratify``, for a float ``test_size`` in (0, 1):
    one ``ShuffleSplit`` draw, ``n_test = ceil(test_size · n)`` rows from the
    front of one permutation and the next ``n - n_test`` for training."""
    n_test = ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train < 1:
        raise ValueError(f"test_size={test_size} leaves no training rows of {n_samples}")
    permutation = _random_state(random_state).permutation(n_samples)
    return permutation[n_test : n_test + n_train], permutation[:n_test]


class EpisodeSampler:
    """The endless fold stream of the JAX package's `train/data.py`: each step
    takes the next fold of a ``(Stratified)KFold(n_splits, shuffle=True)``
    whose ``random_state`` is drawn from ``RandomState(seed)`` per pass."""

    def __init__(
        self,
        *,
        X: np.ndarray | None,
        image: np.ndarray | None,
        y: np.ndarray,
        is_classification: bool,
        n_splits: int = 10,
        seed: int = RANDOM_SEED,
    ):
        assert X is not None or image is not None
        self.X, self.image, self.y = X, image, y
        self.is_classification = is_classification
        self.n_splits = n_splits
        self._rng = np.random.RandomState(seed)
        self._stream = self._fold_stream()
        n = len(y)
        self.test_size = n // n_splits
        self.train_size = n - self.test_size

    def _fold_stream(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            state = int(self._rng.randint(0, np.iinfo(np.int32).max))
            if self.is_classification:
                yield from stratified_kfold_split(self.y, self.n_splits, state)
            else:
                yield from kfold_split(len(self.y), self.n_splits, state)

    def episode_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """Next fold, with the test fold equalized to ``test_size`` rows
        (reference `data_utils.py:127-136`)."""
        train_idx, test_idx = next(self._stream)
        if len(test_idx) != self.test_size:
            cut = len(test_idx) - self.test_size
            train_idx = np.concatenate([train_idx, test_idx[:cut]])
            test_idx = test_idx[cut:]
        return train_idx, test_idx

    def sample(self, batch_size: int = 1) -> dict[str, np.ndarray]:
        """``batch_size`` episodes' rows stacked on a leading axis, float32:
        ``y_train``, ``y_test``, and ``x_train``, ``x_test`` and
        ``image_train``, ``image_test`` where the sampler holds X and images."""
        idx = self.sample_indices(batch_size)
        out = {}
        for key, rows in (("y", self.y), ("x", self.X), ("image", self.image)):
            if rows is not None:
                out[f"{key}_train"] = rows[idx["train_idx"]].astype(np.float32)
                out[f"{key}_test"] = rows[idx["test_idx"]].astype(np.float32)
        return out

    def sample_indices(self, batch_size: int = 1) -> dict[str, np.ndarray]:
        """``batch_size`` episodes' row indices: int32 ``train_idx``
        ``(b, train_size)`` and ``test_idx`` ``(b, test_size)``, the next
        folds of the stream `episode_indices` and `sample` draw from."""
        eps = [self.episode_indices() for _ in range(batch_size)]
        return {"train_idx": np.stack([tr.astype(np.int32) for tr, _ in eps]),
                "test_idx": np.stack([te.astype(np.int32) for _, te in eps])}
