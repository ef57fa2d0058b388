"""MMPFNClassifier — sklearn-style multimodal in-context classifier.

API parity anchor: reference `mmpfn/models/mmpfn/classifier.py:57-576`
(`fit(X, image, y)`, `predict(X, X_image)`, `predict_proba(X, image_test)`),
with `TabPFNClassifier` exposing the vanilla two-argument tabular API. The same
constructor, fit and predict as the JAX package's classifier
(`multimodalpfn_tpu/estimator/classifier.py`), plus a ``device``.

scikit-learn is never imported, and on a numeric ``np.ndarray`` pandas is not
either; labels are encoded with ``np.unique``, which is ``LabelEncoder``'s
mapping. The estimator contract that the JAX classifiers inherit from
``ClassifierMixin, BaseEstimator`` (``get_params``, ``set_params``, so
``sklearn.base.clone``; ``score``; the tags) is written out here; only
``__sklearn_tags__``, which only scikit-learn calls, imports it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Literal, Sequence

import numpy as np
import torch

from multimodalpfn_tpu_torch.estimator.base import (
    EstimatorBase,
    determine_precision,
    initialize_model,
    pipeline_requests,
    resolve_device,
)
from multimodalpfn_tpu_torch.estimator.data_utils import (
    infer_categorical_features,
    validate_X_predict,
    validate_Xy_fit,
)
from multimodalpfn_tpu_torch.estimator.inference import create_inference_engine
from multimodalpfn_tpu_torch.estimator.interface_config import (
    PROBABILITY_EPSILON_ROUND_ZERO,
    SKLEARN_16_DECIMAL_PRECISION,
    ModelInterfaceConfig,
)
from multimodalpfn_tpu_torch.preprocess.ensemble import (
    EnsembleConfig,
    default_classifier_preprocessor_configs,
)
from multimodalpfn_tpu_torch.utils.rng import infer_random_state


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


class MMPFNClassifier(EstimatorBase):
    """Multimodal TabPFN-v2 classifier on PyTorch (CUDA kernels on a GPU)."""

    _estimator_type = "classifier"

    def __init__(
        self,
        *,
        mixer_type: str = "MGM+CAP",
        mgm_heads: int = 8,
        cap_heads: int = 8,
        features_per_group: int = 1,
        n_estimators: int = 4,
        categorical_features_indices: Sequence[int] | None = None,
        softmax_temperature: float = 0.9,
        balance_probabilities: bool = False,
        average_before_softmax: bool = False,
        model_path: str | Path | Literal["auto"] = "auto",
        device: str | torch.device = "cuda",
        ignore_pretraining_limits: bool = False,
        inference_precision: str | Literal["autocast", "auto"] = "auto",
        fit_mode: Literal["low_memory", "fit_preprocessors", "fit_with_cache"] = "fit_preprocessors",
        memory_saving_mode: bool | Literal["auto"] | float | int = "auto",
        random_state: int | np.random.RandomState | np.random.Generator | None = 0,
        n_jobs: int = -1,
        inference_config: dict | ModelInterfaceConfig | None = None,
    ) -> None:
        self.n_estimators = n_estimators
        self.categorical_features_indices = categorical_features_indices
        self.softmax_temperature = softmax_temperature
        self.balance_probabilities = balance_probabilities
        self.average_before_softmax = average_before_softmax
        self.model_path = model_path
        self.device = device
        self.ignore_pretraining_limits = ignore_pretraining_limits
        self.inference_precision = inference_precision
        self.fit_mode = fit_mode
        self.memory_saving_mode = memory_saving_mode
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.inference_config = inference_config
        self.mixer_type = mixer_type
        self.mgm_heads = mgm_heads
        self.cap_heads = cap_heads
        self.features_per_group = features_per_group

    # the rest of the estimator contract (scikit-learn's ClassifierMixin)
    def score(self, X, y, sample_weight=None) -> float:
        """Mean accuracy of ``self.predict(X)`` against ``y``, weighted by
        ``sample_weight`` (``ClassifierMixin.score``)."""
        return float(np.average(np.asarray(self.predict(X)) == np.asarray(y), weights=sample_weight))

    def _more_tags(self):
        return {"allow_nan": True, "multilabel": False}

    def __sklearn_tags__(self):
        from sklearn.utils import ClassifierTags, InputTags, Tags, TargetTags

        return Tags(
            estimator_type="classifier",
            target_tags=TargetTags(required=True),
            classifier_tags=ClassifierTags(),
            input_tags=InputTags(allow_nan=True),
        )

    def fit(self, X, image: np.ndarray | None, y) -> "MMPFNClassifier":
        """Load weights, encode labels, build ensemble configs, fit member
        preprocessing, and prepare the batched inference engine. No model
        forward happens here (reference `classifier.py:364-502`)."""
        static_seed, rng = infer_random_state(self.random_state)
        self.device_ = resolve_device(self.device)

        loaded = initialize_model(
            model_path=self.model_path,
            static_seed=static_seed,
            mixer_type=self.mixer_type if image is not None else "none",
            mgm_heads=self.mgm_heads,
            cap_heads=self.cap_heads,
            features_per_group=self.features_per_group,
            device=self.device_,
        )
        self.use_autocast_, forced = determine_precision(self.inference_precision, self.device_)
        if forced is not None:
            self.use_autocast_ = forced == "bfloat16"

        self.interface_config_ = ModelInterfaceConfig.from_user_input(
            inference_config=self.inference_config
        )
        icfg = self.interface_config_

        outlier_std = icfg.OUTLIER_REMOVAL_STD
        if outlier_std == "auto":
            outlier_std = icfg._CLASSIFICATION_DEFAULT_OUTLIER_REMOVAL_STD
        self.config_ = dataclasses.replace(
            loaded.config,
            remove_outliers=outlier_std is not None and outlier_std > 0,
            remove_outliers_sigma=float(outlier_std) if outlier_std else 12.0,
        )
        self.params_ = loaded.params

        if X is not None:
            X, y, feature_names_in, n_features_in = validate_Xy_fit(
                X,
                y,
                estimator=self,
                max_num_samples=icfg.MAX_NUMBER_OF_SAMPLES,
                max_num_features=icfg.MAX_NUMBER_OF_FEATURES,
                ignore_pretraining_limits=self.ignore_pretraining_limits,
            )
            if feature_names_in is not None:
                self.feature_names_in_ = feature_names_in
            self.n_features_in_ = n_features_in

        # LabelEncoder semantics: sorted unique labels, codes are their indices
        self.classes_, y, counts = np.unique(y, return_inverse=True, return_counts=True)
        self.class_counts_ = counts
        self.n_classes_ = len(self.classes_)
        if self.n_classes_ > icfg.MAX_NUMBER_OF_CLASSES:
            raise ValueError(
                f"Number of classes {self.n_classes_} exceeds the maximum "
                f"{icfg.MAX_NUMBER_OF_CLASSES} supported by the model; reduce the "
                "number of classes (e.g. OneVsRest)."
            )

        if X is not None:
            X = self._encode_X(X, fit=True)
            self.inferred_categorical_indices_ = infer_categorical_features(
                X,
                provided=self.categorical_features_indices,
                min_samples_for_inference=icfg.MIN_NUMBER_SAMPLES_FOR_CATEGORICAL_INFERENCE,
                max_unique_for_category=icfg.MAX_UNIQUE_FOR_CATEGORICAL_FEATURES,
                min_unique_for_numerical=icfg.MIN_UNIQUE_FOR_NUMERICAL_FEATURES,
            )
            max_index = len(X)
        else:
            self.inferred_categorical_indices_ = []
            max_index = len(image)

        preprocess_transforms = icfg.PREPROCESS_TRANSFORMS
        ensemble_configs = EnsembleConfig.generate_for_classification(
            n=self.n_estimators,
            subsample_size=icfg.SUBSAMPLE_SAMPLES,
            add_fingerprint_feature=icfg.FINGERPRINT_FEATURE,
            feature_shift_decoder=icfg.FEATURE_SHIFT_METHOD,
            polynomial_features=icfg.POLYNOMIAL_FEATURES,
            max_index=max_index,
            preprocessor_configs=(
                preprocess_transforms
                if preprocess_transforms is not None
                else default_classifier_preprocessor_configs()
            ),
            class_shift_method=icfg.CLASS_SHIFT_METHOD,
            n_classes=self.n_classes_,
            random_state=rng,
        )
        assert len(ensemble_configs) == self.n_estimators

        self.executor_ = create_inference_engine(
            X_train=X,
            y_train=y,
            image_train=image,
            params=self.params_,
            cfg=self.config_,
            ensemble_configs=ensemble_configs,
            cat_ix=self.inferred_categorical_indices_,
            fit_mode=self.fit_mode,
            rng=rng,
            autocast=self.use_autocast_,
            device=self.device_,
        )
        return self

    def predict(self, X, X_image: np.ndarray | None = None) -> np.ndarray:
        proba = self._predict_proba_impl(X, X_image)
        return self.classes_[np.argmax(proba, axis=1)]

    def predict_proba(self, X, image_test: np.ndarray | None = None) -> np.ndarray:
        return self._predict_proba_impl(X, image_test)

    def predict_proba_many(
        self, Xs, image_tests=None, *, max_in_flight: int = 2
    ) -> list[np.ndarray]:
        """``predict_proba`` over a stream of requests, pipelined: the host
        work of request N+1 (validation, member transforms, uploads, kernel
        launches) overlaps the card's work on request N, since PyTorch
        launches return before the card finishes. ``max_in_flight`` bounds
        the dispatched requests awaiting their host sync. The results are
        exactly ``[predict_proba(X, img) for X, img in zip(Xs, image_tests)]``;
        only the ``fit_with_cache`` engine defers device work, the others
        compute each request in its dispatch (JAX package
        `classifier.py:225-248`)."""
        return pipeline_requests(
            self._dispatch_predict, self._finalize_predict, Xs, image_tests, max_in_flight
        )

    def _predict_proba_impl(self, X, image_test: np.ndarray | None) -> np.ndarray:
        return self._finalize_predict(self._dispatch_predict(X, image_test))

    def _dispatch_predict(self, X, image_test: np.ndarray | None):
        """Validation, encoding and the engine's dispatch (no host sync)."""
        self._check_fitted()
        if X is not None:
            X = self._encode_X(validate_X_predict(X, self), fit=False)
        return self.executor_.dispatch_outputs(X, image_test)

    def _finalize_predict(self, handle) -> np.ndarray:
        """Member logits -> temperature -> reverse class permutation -> softmax/
        average -> balance -> renormalize (reference `classifier.py:517-576`)."""
        outputs = []
        for output, config in self.executor_.finalize_outputs(handle):
            output = np.asarray(output, dtype=np.float64)
            if self.softmax_temperature != 1:
                output = output[:, : self.n_classes_] / self.softmax_temperature
            if config.class_permutation is not None:
                output = output[..., config.class_permutation]
            outputs.append(output)

        if self.average_before_softmax:
            proba = _softmax(np.stack(outputs).mean(axis=0), axis=1)
        else:
            proba = np.stack([_softmax(o, axis=1) for o in outputs]).mean(axis=0)

        if self.balance_probabilities:
            prior = self.class_counts_ / self.class_counts_.sum()
            proba = proba * prior
            proba = proba / proba.sum(axis=-1, keepdims=True)

        if self.interface_config_.USE_SKLEARN_16_DECIMAL_PRECISION:
            proba = np.around(proba, decimals=SKLEARN_16_DECIMAL_PRECISION)
            proba = np.where(proba < PROBABILITY_EPSILON_ROUND_ZERO, 0.0, proba)

        return proba / proba.sum(axis=1, keepdims=True)


class TabPFNClassifier(MMPFNClassifier):
    """Vanilla tabular-only TabPFN-v2 API: ``fit(X, y)`` / ``predict(X)``."""

    def __init__(self, **kwargs):
        kwargs.setdefault("mixer_type", "none")
        super().__init__(**kwargs)

    @classmethod
    def _get_param_names(cls) -> list[str]:
        # the constructor forwards **kwargs to the parent's
        return MMPFNClassifier._get_param_names()

    def fit(self, X, y):  # type: ignore[override]
        return super().fit(X, None, y)

    def predict(self, X):  # type: ignore[override]
        return super().predict(X, None)

    def predict_proba(self, X):  # type: ignore[override]
        return super().predict_proba(X, None)
