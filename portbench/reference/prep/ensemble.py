"""Ensemble member configuration + preprocessing execution.

Reference semantics: `mmpfn/models/mmpfn/preprocessing.py:50-633`. The RNG protocol
(one numpy Generator threading feature shifts, class permutations, subsamples, and
per-member pipeline seeds) is reproduced draw-for-draw so a given ``random_state``
yields the same ensemble as the reference.

Batched-device difference: `fit_preprocessing` returns member results eagerly (host numpy
work is tiny and the env is single-core — the reference's joblib layer is pinned to
n_jobs=1 anyway, `preprocessing.py:619-623`); downstream, members are *stacked by
width group* and run as one batched forward instead of a per-member loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain, repeat
from typing import Iterable, Literal, Sequence, TypeVar

import numpy as np

from portbench.reference.prep.steps import (
    AddFingerprintFeaturesStep,
    EncodeCategoricalFeaturesStep,
    NanHandlingPolynomialFeaturesStep,
    RemoveConstantFeaturesStep,
    ReshapeFeatureDistributionsStep,
    SequentialFeatureTransformer,
    ShuffleFeaturesStep,
)
from portbench.reference.prep.rng import infer_random_state

MAXIMUM_FEATURE_SHIFT = 1_000
CLASS_SHUFFLE_OVERESTIMATE_FACTOR = 3

T = TypeVar("T")


def _balance(x: Iterable[T], n: int) -> list[T]:
    return list(chain.from_iterable(repeat(elem, n) for elem in x))


@dataclass
class PreprocessorConfig:
    """One member's preprocessing recipe (reference `preprocessing.py:50-138`)."""

    name: str
    categorical_name: Literal[
        "none",
        "numeric",
        "onehot",
        "ordinal",
        "ordinal_shuffled",
        "ordinal_very_common_categories_shuffled",
    ] = "none"
    append_original: bool = False
    subsample_features: float = -1
    global_transformer_name: str | None = None

    def __str__(self) -> str:
        return (
            f"{self.name}_cat:{self.categorical_name}"
            + ("_and_none" if self.append_original else "")
            + (
                f"_subsample_feats_{self.subsample_features}"
                if self.subsample_features > 0
                else ""
            )
            + (
                f"_global_transformer_{self.global_transformer_name}"
                if self.global_transformer_name is not None
                else ""
            )
        )


def default_classifier_preprocessor_configs() -> list[PreprocessorConfig]:
    # reference `preprocessing.py:141-156`
    return [
        PreprocessorConfig(
            "quantile_uni_coarse",
            append_original=True,
            categorical_name="ordinal_very_common_categories_shuffled",
            global_transformer_name="svd",
            subsample_features=-1,
        ),
        PreprocessorConfig("none", categorical_name="numeric", subsample_features=-1),
    ]


def generate_index_permutations(
    n: int, *, max_index: int, subsample: int | float, random_state
) -> list[np.ndarray]:
    """Row-subsample index draws (reference `preprocessing.py:172-206`)."""
    _, rng = infer_random_state(random_state)
    if isinstance(subsample, int) and not isinstance(subsample, bool):
        if not 1 <= subsample <= max_index:
            raise ValueError(f"{subsample=} must be in [1, {max_index}] if int")
        return [rng.permutation(max_index)[:subsample] for _ in range(n)]
    if isinstance(subsample, float):
        if not 0 < subsample < 1:
            raise ValueError(f"{subsample=} must be in (0, 1) if float")
        k = int(subsample * max_index) + 1
        return [rng.permutation(max_index)[:k] for _ in range(n)]
    raise ValueError(f"{subsample=} must be int or float.")


@dataclass
class EnsembleConfig:
    """One ensemble member (reference `preprocessing.py:209-478`)."""

    preprocess_config: PreprocessorConfig
    add_fingerprint_feature: bool
    polynomial_features: Literal["no", "all"] | int
    feature_shift_count: int
    feature_shift_decoder: Literal["shuffle", "rotate"] | None
    subsample_ix: np.ndarray | None

    @staticmethod
    def _shared_draws(n, rng):
        start = rng.integers(0, MAXIMUM_FEATURE_SHIFT)
        featshifts = np.arange(start, start + n)
        return rng.choice(featshifts, size=n, replace=False)

    @classmethod
    def generate_for_classification(
        cls,
        *,
        n: int,
        subsample_size,
        max_index: int,
        add_fingerprint_feature: bool,
        polynomial_features,
        feature_shift_decoder,
        preprocessor_configs: Sequence[PreprocessorConfig],
        class_shift_method,
        n_classes: int,
        random_state,
    ) -> list["ClassifierEnsembleConfig"]:
        static_seed, rng = infer_random_state(random_state)
        featshifts = cls._shared_draws(n, rng)

        if class_shift_method == "rotate":
            arange = np.arange(0, n_classes)
            shifts = rng.permutation(n_classes).tolist()
            perms = [np.roll(arange, s) for s in shifts]
            class_permutations = [perms[c] for c in rng.choice(n_classes, n)]
        elif class_shift_method == "shuffle":
            noise = rng.random((n * CLASS_SHUFFLE_OVERESTIMATE_FACTOR, n_classes))
            shufflings = np.argsort(noise, axis=1)
            uniqs = np.unique(shufflings, axis=0)
            class_permutations = _balance(uniqs, n // len(uniqs))
            rand_count = n % len(uniqs)
            if rand_count > 0:
                class_permutations += [
                    uniqs[i] for i in rng.choice(len(uniqs), size=rand_count)
                ]
        elif class_shift_method is None:
            class_permutations = [None] * n
        else:
            raise ValueError(f"Unknown {class_shift_method=}")

        subsamples = cls._subsamples(n, subsample_size, max_index, static_seed)
        configs_ = _balance(preprocessor_configs, n // len(preprocessor_configs))
        leftover = n - len(configs_)
        if leftover > 0:
            picks = rng.choice(len(preprocessor_configs), size=leftover, replace=True)
            configs_.extend(preprocessor_configs[i] for i in picks)

        return [
            ClassifierEnsembleConfig(
                preprocess_config=pc,
                feature_shift_count=int(shift),
                add_fingerprint_feature=add_fingerprint_feature,
                polynomial_features=polynomial_features,
                feature_shift_decoder=feature_shift_decoder,
                subsample_ix=sub,
                class_permutation=perm,
            )
            for shift, pc, sub, perm in zip(
                featshifts, configs_, subsamples, class_permutations
            )
        ]

    @staticmethod
    def _subsamples(n, subsample_size, max_index, static_seed):
        if isinstance(subsample_size, (int, float)) and not isinstance(
            subsample_size, bool
        ):
            return generate_index_permutations(
                n=n, max_index=max_index, subsample=subsample_size, random_state=static_seed
            )
        if subsample_size is None:
            return [None] * n
        raise ValueError(f"Invalid subsample_samples: {subsample_size}")

    def to_pipeline(self, *, random_state) -> SequentialFeatureTransformer:
        """Materialize the member's step list (reference `preprocessing.py:417-478`)."""
        steps: list = []
        if isinstance(self.polynomial_features, int) and not isinstance(
            self.polynomial_features, bool
        ):
            assert self.polynomial_features > 0
            steps.append(
                NanHandlingPolynomialFeaturesStep(
                    max_features=self.polynomial_features, random_state=random_state
                )
            )
        elif self.polynomial_features == "all":
            steps.append(
                NanHandlingPolynomialFeaturesStep(
                    max_features=None, random_state=random_state
                )
            )
        elif self.polynomial_features != "no":
            raise ValueError(f"Invalid polynomial_features: {self.polynomial_features}")

        pc = self.preprocess_config
        steps += [
            RemoveConstantFeaturesStep(),
            ReshapeFeatureDistributionsStep(
                transform_name=pc.name,
                append_to_original=pc.append_original,
                subsample_features=pc.subsample_features,
                global_transformer_name=pc.global_transformer_name,
                apply_to_categorical=pc.categorical_name == "numeric",
                random_state=random_state,
            ),
            EncodeCategoricalFeaturesStep(pc.categorical_name, random_state=random_state),
        ]
        if self.add_fingerprint_feature:
            steps.append(AddFingerprintFeaturesStep(random_state=random_state))
        steps.append(
            ShuffleFeaturesStep(
                shuffle_method=self.feature_shift_decoder,
                shuffle_index=self.feature_shift_count,
                random_state=random_state,
            )
        )
        return SequentialFeatureTransformer(steps)


@dataclass
class ClassifierEnsembleConfig(EnsembleConfig):
    class_permutation: np.ndarray | None



def fit_preprocessing_one(
    config: EnsembleConfig,
    X_train: np.ndarray | None,
    y_train: np.ndarray,
    random_state=None,
    *,
    cat_ix: list[int],
):
    """Fit one member's pipeline (reference `preprocessing.py:501-559`), including
    the X=None image-only short-circuit (`preprocessing.py:544-546`)."""
    if not isinstance(config, ClassifierEnsembleConfig):
        raise ValueError(f"Invalid ensemble config type: {type(config)}")
    if config.class_permutation is not None:
        y_train = config.class_permutation[y_train]

    if X_train is None:
        return config, None, None, y_train, None

    static_seed, _ = infer_random_state(random_state)
    if config.subsample_ix is not None:
        X_train = X_train[config.subsample_ix].copy()
        y_train = y_train[config.subsample_ix].copy()
    else:
        X_train = X_train.copy()
        y_train = y_train.copy()

    preprocessor = config.to_pipeline(random_state=static_seed)
    res = preprocessor.fit_transform(X_train, cat_ix)
    return config, preprocessor, res.X, y_train, res.categorical_features


def fit_preprocessing(
    configs: Sequence[EnsembleConfig],
    X_train: np.ndarray | None,
    y_train: np.ndarray,
    *,
    random_state,
    cat_ix: list[int],
) -> list[tuple]:
    """Fit all member pipelines. Per-member seeds are drawn from the shared rng
    exactly like the reference (`preprocessing.py:627`)."""
    _, rng = infer_random_state(random_state)
    seeds = rng.integers(0, np.iinfo(np.int32).max, len(configs))
    return [
        fit_preprocessing_one(config, X_train, y_train, int(seed), cat_ix=cat_ix)
        for config, seed in zip(configs, seeds)
    ]
