"""Per-ensemble-member feature preprocessing steps (host side).

Behavioral contract mirrors the reference pipeline
(`mmpfn/models/mmpfn/model/preprocessing.py:47-1278`): every step consumes
``(X, categorical_indices)`` and produces the transformed X plus the categorical
indices after the transform. These run on host numpy (they are tiny relative to the
transformer forward and inherently data-dependent/dynamic-shape); the outputs are
stacked per member width-group and fed to the batched device forward.

Known deliberate divergence: `AddFingerprintFeaturesStep` uses a stable blake2b row
hash instead of Python's per-process-salted ``hash()`` (`preprocessing.py:476-479`);
the reference's fingerprint is not reproducible across processes, ours is. The
reference also salts test rows twice (`preprocessing.py:505-509`) — we reproduce
that quirk for distribution parity.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import NamedTuple

import numpy as np

from portbench.reference.prep import numeric
from portbench.reference.prep.safe_power import (
    make_safe_power_box_pipeline,
    make_safe_power_pipeline,
    make_safe_scaler,
)
from portbench.reference.prep.rng import infer_random_state


class TransformResult(NamedTuple):
    X: np.ndarray
    categorical_features: list[int]


class PreprocessingStep(ABC):
    """fit/transform with categorical-index bookkeeping
    (contract of reference `FeaturePreprocessingTransformerStep`)."""

    categorical_features_: list[int]

    @abstractmethod
    def _fit(self, X: np.ndarray, categorical_features: list[int]) -> list[int]: ...

    @abstractmethod
    def _transform(self, X: np.ndarray, *, is_test: bool) -> np.ndarray: ...

    def fit_transform(
        self, X: np.ndarray, categorical_features: list[int]
    ) -> TransformResult:
        self.categorical_features_ = self._fit(X, categorical_features)
        return TransformResult(self._transform(X, is_test=False), self.categorical_features_)

    def transform(self, X: np.ndarray) -> TransformResult:
        return TransformResult(self._transform(X, is_test=True), self.categorical_features_)


class SequentialFeatureTransformer:
    """Ordered step pipeline threading categorical indices
    (reference `preprocessing.py:371-440`)."""

    def __init__(self, steps: list[PreprocessingStep]):
        assert steps, "pipeline must have at least one step"
        self.steps = steps
        self.categorical_features_: list[int] | None = None

    def fit_transform(self, X: np.ndarray, categorical_features: list[int]) -> TransformResult:
        for step in self.steps:
            X, categorical_features = step.fit_transform(X, categorical_features)
        self.categorical_features_ = categorical_features
        return TransformResult(X, categorical_features)

    def fit(self, X: np.ndarray, categorical_features: list[int]):
        self.fit_transform(X, categorical_features)
        return self

    def transform(self, X: np.ndarray) -> TransformResult:
        assert self.categorical_features_ is not None, "fit first"
        cats: list[int] = []
        for step in self.steps:
            X, cats = step.transform(X)
        return TransformResult(X, cats)


# ---------------------------------------------------------------------------


class RemoveConstantFeaturesStep(PreprocessingStep):
    """Drop train-constant columns (reference `preprocessing.py:443-470`;
    NaN != NaN, so NaN-containing columns count as non-constant)."""

    def _fit(self, X, categorical_features):
        sel = (X[0:1, :] == X).mean(axis=0) < 1.0
        if not sel.any():
            raise ValueError(
                "All features are constant and would have been removed — unable to predict."
            )
        self.sel_ = sel
        kept = np.where(sel)[0]
        return [new for new, old in enumerate(kept) if old in categorical_features]

    def _transform(self, X, *, is_test=False):
        return X[:, self.sel_]


_HASH_CONSTANT = 10**12


def _stable_float_hash(row: np.ndarray) -> float:
    """Deterministic row hash -> [0, 1). Stable across processes (blake2b), unlike
    the reference's salted builtin hash (`preprocessing.py:476-479`)."""
    h = int.from_bytes(hashlib.blake2b(row.tobytes(), digest_size=8).digest(), "little")
    return h % _HASH_CONSTANT / _HASH_CONSTANT


class AddFingerprintFeaturesStep(PreprocessingStep):
    """Append a row-hash feature; de-collide on train by count-up rehash
    (reference `preprocessing.py:482-523`)."""

    def __init__(self, random_state=None):
        self.random_state = random_state

    def _fit(self, X, categorical_features):
        _, rng = infer_random_state(self.random_state)
        self.rnd_salt_ = int(rng.integers(0, 2**16))
        return [*categorical_features]

    def _transform(self, X, *, is_test=False):
        X_h = np.zeros(X.shape[0], dtype=X.dtype)
        salted = X + self.rnd_salt_
        if is_test:
            # reference quirk: test rows get the salt applied twice
            doubled = salted + self.rnd_salt_
            for i, row in enumerate(doubled):
                X_h[i] = _stable_float_hash(row)
        else:
            seen: set[float] = set()
            for i, row in enumerate(salted):
                h = _stable_float_hash(row)
                bump = 0
                while h in seen:
                    bump += 1
                    h = _stable_float_hash(row + bump)
                X_h[i] = h
                seen.add(h)
        return np.concatenate([X, X_h.reshape(-1, 1)], axis=1)


class ShuffleFeaturesStep(PreprocessingStep):
    """Rotate or shuffle feature order (reference `preprocessing.py:526-571`)."""

    def __init__(self, shuffle_method="rotate", shuffle_index=0, random_state=None):
        self.shuffle_method = shuffle_method
        self.shuffle_index = shuffle_index
        self.random_state = random_state

    def _fit(self, X, categorical_features):
        _, rng = infer_random_state(self.random_state)
        n = X.shape[1]
        if self.shuffle_method == "rotate":
            perm = np.roll(np.arange(n), self.shuffle_index)
        elif self.shuffle_method == "shuffle":
            perm = rng.permutation(n)
        elif self.shuffle_method is None:
            perm = np.arange(n)
        else:
            raise ValueError(f"Unknown shuffle method {self.shuffle_method}")
        self.index_permutation_ = perm
        return [new for new, old in enumerate(perm) if old in categorical_features]

    def _transform(self, X, *, is_test=False):
        assert len(self.index_permutation_) == X.shape[1]
        return X[:, self.index_permutation_]


class NanHandlingPolynomialFeaturesStep(PreprocessingStep):
    """Append random pairwise feature products (reference `preprocessing.py:1203-1278`)."""

    def __init__(self, *, max_features=None, random_state=None):
        self.max_poly_features = max_features
        self.random_state = random_state

    def _fit(self, X, categorical_features):
        _, rng = infer_random_state(self.random_state)
        n = X.shape[1]
        if X.shape[0] == 0 or n == 0:
            self.idx1_ = np.array([], dtype=int)
            self.idx2_ = np.array([], dtype=int)
            self.scale_ = np.ones(0)
            return [*categorical_features]
        n_poly = n * (n - 1) // 2 + n
        if self.max_poly_features:
            n_poly = min(self.max_poly_features, n_poly)
        # scale like StandardScaler(with_mean=False) fitted on train
        std = np.nanstd(X, axis=0)
        self.scale_ = np.where(std == 0, 1.0, std)
        idx1 = rng.choice(np.arange(n), size=n_poly, replace=True)
        idx2 = np.full_like(idx1, -1)
        for i in range(len(idx1)):
            while idx2[i] == -1:
                f1 = idx1[i]
                used = idx2[idx1 == f1]
                remaining = set(range(f1, n)) - set(used.tolist())
                if not remaining:
                    idx1[i] = rng.choice(np.arange(n), size=1)
                    continue
                idx2[i] = rng.choice(sorted(remaining), size=1)
        self.idx1_, self.idx2_ = idx1, idx2
        return [*categorical_features]

    def _transform(self, X, *, is_test=False):
        if X.shape[0] == 0 or X.shape[1] == 0:
            return X
        Xs = X / self.scale_
        poly = Xs[:, self.idx1_] * Xs[:, self.idx2_]
        return np.hstack([Xs, poly])


# ---------------------------------------------------------------------------
# categorical encoding
# ---------------------------------------------------------------------------


class EncodeCategoricalFeaturesStep(PreprocessingStep):
    """Ordinal / shuffled-ordinal / onehot / numeric categorical handling
    (reference `preprocessing.py:998-1200`).

    Output column order for ordinal modes: [encoded categoricals..., passthrough
    rest] (sklearn ColumnTransformer remainder semantics)."""

    def __init__(self, categorical_transform_name="ordinal", random_state=None):
        self.name = categorical_transform_name
        self.random_state = random_state

    def _select_columns(self, X, categorical_features):
        name = self.name
        if name.startswith("ordinal"):
            suffix = name[len("ordinal") :]
            if suffix.startswith("_common_categories"):
                return [
                    i
                    for i in categorical_features
                    if _least_common_count(X[:, i]) >= 10
                ]
            if suffix.startswith("_very_common_categories"):
                return [
                    i
                    for i in categorical_features
                    if _least_common_count(X[:, i]) >= 10
                    and len(np.unique(X[:, i])) < (len(X) // 10)
                ]
            assert suffix in ("", "_shuffled"), f"unknown categorical transform {name}"
        return list(categorical_features)

    def _fit(self, X, categorical_features):
        _, rng = infer_random_state(self.random_state)
        name = self.name
        if name in ("numeric", "none"):
            self.mode_ = "identity"
            return list(categorical_features)

        if name.startswith("ordinal"):
            cols = self._select_columns(X, categorical_features)
            self.cols_ = cols
            self.mode_ = "ordinal"
            # per-column sorted category list (NaN excluded; unseen -> NaN)
            self.categories_ = [
                np.unique(X[~np.isnan(X[:, c]), c]) for c in cols
            ]
            self.mappings_ = None
            if name.endswith("_shuffled"):
                self.mappings_ = [
                    rng.permutation(len(cats)) for cats in self.categories_
                ]
            return list(range(len(cols)))

        if name == "onehot":
            cols = list(categorical_features)
            self.cols_ = cols
            self.categories_ = [np.unique(X[~np.isnan(X[:, c]), c]) for c in cols]
            out_width = sum(
                1 if len(c) == 2 else len(c) for c in self.categories_
            )
            rest = X.shape[1] - len(cols)
            if (out_width + rest) * X.shape[0] >= 1_000_000:
                self.mode_ = "identity"  # reference bail-out `preprocessing.py:1116-1117`
                return list(categorical_features)
            self.mode_ = "onehot"
            return list(range(out_width))

        raise ValueError(f"Unknown categorical transform {name}")

    def _transform(self, X, *, is_test=False):
        if self.mode_ == "identity":
            return X
        rest_ix = [i for i in range(X.shape[1]) if i not in self.cols_]
        if self.mode_ == "ordinal":
            enc = np.empty((X.shape[0], len(self.cols_)), dtype=X.dtype)
            for j, (c, cats) in enumerate(zip(self.cols_, self.categories_)):
                col = X[:, c]
                idx = np.searchsorted(cats, col)
                idx_clip = np.clip(idx, 0, max(len(cats) - 1, 0))
                known = ~np.isnan(col)
                if len(cats):
                    known &= cats[idx_clip] == col
                code = np.where(known, idx_clip, np.nan).astype(X.dtype)
                if self.mappings_ is not None and len(cats):
                    m = self.mappings_[j]
                    ok = ~np.isnan(code)
                    code[ok] = m[code[ok].astype(int)].astype(X.dtype)
                enc[:, j] = code
            return np.concatenate([enc, X[:, rest_ix]], axis=1)
        # onehot
        blocks = []
        for c, cats in zip(self.cols_, self.categories_):
            col = X[:, c : c + 1]
            oh = (col == cats.reshape(1, -1)).astype(X.dtype)
            if len(cats) == 2:  # drop="if_binary"
                oh = oh[:, 1:]
            blocks.append(oh)
        blocks.append(X[:, rest_ix])
        return np.concatenate(blocks, axis=1)


def _identity_np(x):
    return x


def _least_common_count(col: np.ndarray) -> int:
    if len(col) == 0:
        return 0
    _, counts = np.unique(col, return_counts=True)
    return int(counts.min())


# ---------------------------------------------------------------------------
# distribution reshaping
# ---------------------------------------------------------------------------


class ReshapeFeatureDistributionsStep(PreprocessingStep):
    """Registry-driven per-feature distribution transforms with optional global SVD,
    append-original and feature-subsampling (reference `preprocessing.py:579-995`).

    The transformers are the numpy/scipy versions of scikit-learn's in
    `preprocess.numeric` (QuantileTransformer, PowerTransformer, RobustScaler,
    TruncatedSVD with ARPACK), which give scikit-learn's numbers; scikit-learn
    itself is never imported."""

    def __init__(
        self,
        *,
        transform_name: str = "safepower",
        apply_to_categorical: bool = False,
        append_to_original: bool = False,
        subsample_features: float = -1,
        global_transformer_name: str | None = None,
        random_state=None,
    ):
        self.transform_name = transform_name
        self.apply_to_categorical = apply_to_categorical
        self.append_to_original = append_to_original
        self.subsample_features = float(subsample_features)
        self.global_transformer_name = global_transformer_name
        self.random_state = random_state

    # -- registry -----------------------------------------------------------
    @staticmethod
    def make_transformer(name: str, num_examples: int, random_state: int | None):
        quantiles = {
            "quantile_uni_coarse": ("uniform", max(num_examples // 10, 2)),
            "quantile_norm_coarse": ("normal", max(num_examples // 10, 2)),
            "quantile_uni": ("uniform", max(num_examples // 5, 2)),
            "quantile_norm": ("normal", max(num_examples // 5, 2)),
            "quantile_uni_fine": ("uniform", num_examples),
            "quantile_norm_fine": ("normal", num_examples),
        }
        if name in quantiles:
            dist, nq = quantiles[name]
            return numeric.QuantileTransformer(
                output_distribution=dist, n_quantiles=nq, random_state=random_state
            )
        if name in ("power", "safepower"):
            return make_safe_power_pipeline(safe=name == "safepower")
        if name in ("power_box", "safepower_box"):
            return make_safe_power_box_pipeline(safe=name == "safepower_box")
        if name == "robust":
            return numeric.RobustScaler()
        if name == "none":
            return numeric.FunctionTransformer(_identity_np)
        if name == "log":
            return numeric.FunctionTransformer(np.log)
        if name == "1_plus_log":
            return numeric.FunctionTransformer(np.log1p)
        if name == "exp":
            return numeric.FunctionTransformer(np.exp)
        if name.startswith("kdi") or name == "norm_and_kdi":
            from portbench.reference.prep.kdi import make_kdi_transformer

            return make_kdi_transformer(name, num_examples, random_state)
        raise ValueError(f"Unknown transform {name}")

    # ------------------------------------------------------------------------
    def _plan(self, n_samples, n_features, categorical_features):
        static_seed, rng = infer_random_state(self.random_state)
        if "adaptive" in self.transform_name:
            raise NotImplementedError("Adaptive preprocessing raw removed.")

        self.use_global_ = (
            self.global_transformer_name is not None
            and self.global_transformer_name != "None"
            and not (self.global_transformer_name == "svd" and n_features < 2)
        )
        self.global_seed_ = static_seed
        self.global_n_ = (n_samples, n_features)

        if self.subsample_features > 0:
            k = int(self.subsample_features * n_features) + 1
            self.subsampled_features_ = rng.choice(
                list(range(n_features)), k, replace=k > n_features
            )
            categorical_features = [
                new
                for new, old in enumerate(self.subsampled_features_)
                if old in categorical_features
            ]
            n_features = k
        else:
            self.subsampled_features_ = np.arange(n_features)

        numerical = [i for i in range(n_features) if i not in categorical_features]
        app, cat = self.append_to_original, self.apply_to_categorical
        # Four branches of reference `preprocessing.py:894-925`; each defines the
        # output layout [prefix passthrough?, transformed trans_ixs] and cat_ix.
        if app and cat:
            self.passthrough_ = list(range(n_features))
            self.trans_ixs_ = categorical_features + numerical
            cat_ix = list(categorical_features)
        elif app and not cat:
            self.passthrough_ = list(range(n_features))
            self.trans_ixs_ = numerical
            cat_ix = list(categorical_features)
        elif not app and cat:
            self.passthrough_ = []
            self.trans_ixs_ = categorical_features + numerical
            cat_ix = []
        else:
            self.passthrough_ = list(categorical_features)
            self.trans_ixs_ = numerical
            cat_ix = list(range(len(categorical_features)))

        self.per_feature_ = self.transform_name == "per_feature"
        if self.per_feature_:
            names = _PER_FEATURE_POOL
            self.transformers_ = [
                ReshapeFeatureDistributionsStep.make_transformer(
                    str(rng.choice(names)), n_samples, static_seed
                )
                for _ in self.trans_ixs_
            ]
        else:
            self.transformers_ = [
                ReshapeFeatureDistributionsStep.make_transformer(
                    self.transform_name, n_samples, static_seed
                )
            ]
        return cat_ix

    def _fit(self, X, categorical_features):
        n_samples, n_features = X.shape
        cat_ix = self._plan(n_samples, n_features, categorical_features)
        Xs = X[:, self.subsampled_features_]
        if self.per_feature_:
            for t, ix in zip(self.transformers_, self.trans_ixs_):
                t.fit(Xs[:, [ix]])
        elif self.trans_ixs_:
            self.transformers_[0].fit(Xs[:, self.trans_ixs_])
        if self.use_global_:
            base = self._transform_local(Xs)
            self._fit_global(base)
        return cat_ix

    def _transform_local(self, Xs):
        parts = []
        if self.passthrough_:
            parts.append(Xs[:, self.passthrough_])
        if self.trans_ixs_:
            if self.per_feature_:
                parts.append(
                    np.concatenate(
                        [
                            t.transform(Xs[:, [ix]])
                            for t, ix in zip(self.transformers_, self.trans_ixs_)
                        ],
                        axis=1,
                    )
                )
            else:
                parts.append(
                    np.asarray(self.transformers_[0].transform(Xs[:, self.trans_ixs_]))
                )
        return np.concatenate(parts, axis=1) if parts else Xs[:, :0]

    def _fit_global(self, base):
        n_samples, n_features = self.global_n_
        if self.global_transformer_name == "scaler":
            self.global_ = ("scaler", make_safe_scaler().fit(base))
            return
        # "svd": FeatureUnion[passthrough, scale(no-mean)->TruncatedSVD(arpack)]
        # (reference `preprocessing.py:790-822`)
        n_components = max(1, min(n_samples // 10 + 1, n_features // 2))
        scaler = make_safe_scaler(with_mean=False).fit(base)
        svd = numeric.TruncatedSVD(n_components=n_components, random_state=self.global_seed_)
        svd.fit(scaler.transform(base))
        self.global_ = ("svd", (scaler, svd))

    def _transform(self, X, *, is_test=False):
        Xs = X[:, self.subsampled_features_]
        base = self._transform_local(Xs)
        if not self.use_global_:
            return base
        kind, obj = self.global_
        if kind == "scaler":
            return np.asarray(obj.transform(base))
        scaler, svd = obj
        return np.concatenate([base, svd.transform(scaler.transform(base))], axis=1)


_PER_FEATURE_POOL = [
    "power",
    "safepower",
    "quantile_uni_coarse",
    "quantile_norm_coarse",
    "quantile_uni",
    "quantile_norm",
    "quantile_uni_fine",
    "quantile_norm_fine",
    "robust",
    "none",
]
