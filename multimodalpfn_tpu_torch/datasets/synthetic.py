"""Synthetic datasets for tests/benchmarks (the reference keeps similar helpers in
`scripts_finetune_mm/training_utils/dummy_data_utils.py:12-50`)."""

from __future__ import annotations

import numpy as np


def toy_classification(
    n: int = 120,
    n_features: int = 6,
    n_classes: int = 3,
    *,
    n_categorical: int = 2,
    nan_share: float = 0.05,
    seed: int = 0,
):
    """Numeric + categorical + NaN classification data with a learnable signal."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    y = rng.integers(0, n_classes, size=n)
    X = centers[y] + rng.normal(size=(n, n_features))
    for j in range(n_categorical):
        X[:, j] = np.round(np.clip(X[:, j], -2, 2))
    if nan_share > 0:
        X[rng.random(size=X.shape) < nan_share] = np.nan
    return X.astype(np.float64), y.astype(np.int64)


def toy_regression(
    n: int = 120, n_features: int = 6, *, nan_share: float = 0.05, seed: int = 0
):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_features))
    w = rng.normal(size=n_features)
    y = X @ w + 0.1 * rng.normal(size=n)
    if nan_share > 0:
        X[rng.random(size=X.shape) < nan_share] = np.nan
    return X.astype(np.float64), y.astype(np.float64)


def toy_multimodal_classification(
    n: int = 120,
    n_features: int = 6,
    n_classes: int = 3,
    *,
    n_tokens: int = 1,
    emb_dim: int = 768,
    seed: int = 0,
):
    """Tabular + frozen-encoder-style embedding data where the embedding carries
    class signal (like cached DINOv2/ELECTRA CLS embeddings)."""
    rng = np.random.default_rng(seed)
    X, y = toy_classification(n, n_features, n_classes, seed=seed)
    class_dirs = rng.normal(size=(n_classes, emb_dim))
    emb = class_dirs[y][:, None, :] + 0.5 * rng.normal(size=(n, n_tokens, emb_dim))
    return X, emb.astype(np.float32), y


def pad_ufes_like(seed: int = 0):
    """PAD-UFES-20-shaped data: 2298 rows, 21 clinical features (14 bool, 4
    ordinal-categorical, 3 numeric), 6 classes, 1 DINOv2 CLS token of width 768
    (reference `datasets/pad_ufes_20.py:17-118`)."""
    rng = np.random.default_rng(seed)
    n, n_classes = 2298, 6
    y = rng.integers(0, n_classes, size=n)
    centers = rng.normal(size=(n_classes, 21))
    X = centers[y] + rng.normal(size=(n, 21))
    X[:, :14] = (X[:, :14] > 0).astype(np.float64)  # boolean block
    for j in range(14, 18):
        X[:, j] = np.round(np.clip(X[:, j], -3, 3)) + 3  # ordinal cats
    X[rng.random(size=X.shape) < 0.02] = np.nan
    class_dirs = rng.normal(size=(n_classes, 768))
    emb = class_dirs[y][:, None, :] + 0.7 * rng.normal(size=(n, 1, 768))
    return X, emb.astype(np.float32), y
