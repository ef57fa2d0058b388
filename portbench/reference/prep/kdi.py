"""Kernel Density Integral (KDI) transform family.

The reference optionally imports the `kditransform` package (numba-based) and falls
back silently when absent (`mmpfn/models/mmpfn/model/preprocessing.py:39-44,105-125`).
This is a self-contained implementation of the same transform: per feature, the
smoothed empirical CDF

    F̂(x) = (1/n) Σ_i Φ((x − x_i) / h),   h = α · σ̂ · n^(−1/(4+d)), d=1

mapped to a uniform output (F̂) or a normal output (Φ⁻¹(F̂)). α=1 recovers the
classic KDE-CDF quantile transform; α interpolates smoothing strength
(`kdi_alpha_*` registry names). NaN handling mirrors `KDITransformerWithNaN`
(`preprocessing.py:47-81`): mean-impute for the KDE, reintroduce NaNs after.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

from portbench.reference.prep.numeric import QuantileTransformer

ALPHAS = (0.05, 0.1, 0.2, 0.25, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.5, 1.8, 2.0, 2.5, 3.0, 5.0)

_EPS = 1e-7


class KDITransformer:
    """Per-feature KDE-CDF transform with NaN pass-through."""

    def __init__(self, alpha: float = 1.0, output_distribution: str = "normal"):
        self.alpha = float(alpha)
        self.output_distribution = output_distribution

    def fit(self, X: np.ndarray, y=None):
        X = np.asarray(X, dtype=np.float64)
        col_means = np.nanmean(X, axis=0)
        col_means = np.nan_to_num(col_means, nan=0.0)
        X = np.where(np.isnan(X), col_means, X)
        self.train_ = X
        n = max(X.shape[0], 1)
        std = X.std(axis=0)
        std = np.where(std == 0, 1.0, std)
        self.bandwidth_ = np.maximum(self.alpha * std * n ** (-1.0 / 5.0), 1e-12)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        nan_mask = np.isnan(X)
        col_means = np.nanmean(X, axis=0)
        col_means = np.nan_to_num(col_means, nan=0.0)
        Xi = np.where(nan_mask, col_means, X)
        # (n_test, n_train, F) is small for tabular scales; chunk rows to bound memory
        out = np.empty_like(Xi)
        chunk = max(1, int(2e7) // max(self.train_.size, 1))
        for s in range(0, Xi.shape[0], chunk):
            block = Xi[s : s + chunk]  # (c, F)
            z = (block[:, None, :] - self.train_[None, :, :]) / self.bandwidth_
            out[s : s + chunk] = norm.cdf(z).mean(axis=1)
        if self.output_distribution == "normal":
            out = norm.ppf(np.clip(out, _EPS, 1 - _EPS))
        out = out.astype(np.float64)
        out[nan_mask] = np.nan
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


class _FeatureUnion:
    def __init__(self, transformers):
        self.transformers = transformers

    def fit(self, X, y=None):
        for t in self.transformers:
            t.fit(X)
        return self

    def transform(self, X):
        return np.concatenate([t.transform(X) for t in self.transformers], axis=1)

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


def make_kdi_transformer(name: str, num_examples: int, random_state):
    """Resolve the kdi registry names (reference `preprocessing.py:105-125,756-771`)."""
    if name == "norm_and_kdi":
        return _FeatureUnion(
            [
                QuantileTransformer(
                    output_distribution="normal",
                    n_quantiles=max(num_examples // 10, 2),
                    random_state=random_state,
                ),
                KDITransformer(alpha=1.0, output_distribution="uniform"),
            ]
        )
    if name == "kdi":
        return KDITransformer(alpha=1.0, output_distribution="normal")
    if name == "kdi_uni":
        return KDITransformer(alpha=1.0, output_distribution="uniform")
    if name.startswith("kdi_alpha_"):
        rest = name[len("kdi_alpha_") :]
        uni = rest.endswith("_uni")
        alpha = float(rest[: -len("_uni")] if uni else rest)
        return KDITransformer(
            alpha=alpha, output_distribution="uniform" if uni else "normal"
        )
    if name == "kdi_random_alpha" or name == "kdi_random_alpha_uni":
        rng = np.random.default_rng(random_state)
        alpha = float(rng.choice(ALPHAS))
        return KDITransformer(
            alpha=alpha,
            output_distribution="uniform" if name.endswith("_uni") else "normal",
        )
    raise ValueError(f"Unknown kdi transform {name}")
