"""MMPFNRegressor — sklearn-style multimodal in-context regressor.

API parity anchor: reference `mmpfn/models/mmpfn/regressor.py:84-765`
(`fit(X, image, y)`, `predict(X, image_test, output_type=...)`), with
`TabPFNRegressor` exposing the vanilla tabular API. The same constructor, fit
and predict as the JAX package's regressor
(`multimodalpfn_tpu/estimator/regressor.py:48-355`), plus a ``device``.

The members run through the same inference engines, and so the same kernels,
as the classifier's; what is the regressor's own is the host finalize: each
member's borders pushed through its inverse target transform
(`estimator/borders.py`), its probabilities translated onto the standardized
borders, the average, and the statistics of the bar distribution over the
borders mapped back to the raw target (float32 on the CPU, as the JAX
package computes them with x64 off). scikit-learn is never imported.
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
from multimodalpfn_tpu_torch.estimator.borders import (
    transform_borders_one,
    translate_probs_across_borders,
)
from multimodalpfn_tpu_torch.estimator.data_utils import (
    infer_categorical_features,
    validate_Xy_fit,
)
from multimodalpfn_tpu_torch.estimator.inference import create_inference_engine
from multimodalpfn_tpu_torch.estimator.interface_config import ModelInterfaceConfig
from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution
from multimodalpfn_tpu_torch.preprocess.ensemble import (
    EnsembleConfig,
    default_regressor_preprocessor_configs,
)
from multimodalpfn_tpu_torch.preprocess.steps import ReshapeFeatureDistributionsStep
from multimodalpfn_tpu_torch.train.metrics import r2_score
from multimodalpfn_tpu_torch.utils.profiling import span
from multimodalpfn_tpu_torch.utils.rng import infer_random_state

_OUTPUT_TYPES = ("mean", "median", "mode", "quantiles")
_USABLE_OUTPUT_TYPES = (*_OUTPUT_TYPES, "full", "main")
DEFAULT_QUANTILES = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]


class MMPFNRegressor(EstimatorBase):
    """Multimodal TabPFN-v2 regressor on PyTorch (bar-distribution head; CUDA
    kernels on a GPU)."""

    _estimator_type = "regressor"

    def __init__(
        self,
        *,
        mixer_type: str = "MGM+CAP",
        mgm_heads: int = 8,
        cap_heads: int = 8,
        features_per_group: int = 1,
        n_estimators: int = 8,
        categorical_features_indices: Sequence[int] | None = None,
        softmax_temperature: float = 0.9,
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

    # the rest of the estimator contract (scikit-learn's RegressorMixin)
    def score(self, X, y, sample_weight=None) -> float:
        """R² of ``self.predict(X)`` against ``y`` (scikit-learn's ``r2_score``)."""
        return r2_score(y, self.predict(X), sample_weight=sample_weight)

    def _more_tags(self):
        return {"allow_nan": True}

    def __sklearn_tags__(self):
        from sklearn.utils import InputTags, RegressorTags, Tags, TargetTags

        return Tags(
            estimator_type="regressor",
            target_tags=TargetTags(required=True),
            regressor_tags=RegressorTags(),
            input_tags=InputTags(allow_nan=True),
        )

    def fit(self, X, image: np.ndarray | None, y) -> "MMPFNRegressor":
        """Load weights and borders, build the ensemble configs with their
        target transforms, standardize y and fit the member preprocessing
        (reference `regressor.py:390-538`). No model forward happens here,
        except the KV cache's prime in ``fit_with_cache``."""
        with span("mmpfn.fit"):
            static_seed, rng = infer_random_state(self.random_state)
            self.device_ = resolve_device(self.device)

            loaded = initialize_model(
                model_path=self.model_path,
                which="regressor",
                static_seed=static_seed,
                mixer_type=self.mixer_type if image is not None else "none",
                mgm_heads=self.mgm_heads,
                cap_heads=self.cap_heads,
                features_per_group=self.features_per_group,
                device=self.device_,
            )
            if loaded.criterion_borders is None:
                raise ValueError(f"{self.model_path!r} is not a regression model: it has no borders")
            self.bardist_ = FullSupportBarDistribution(np.asarray(loaded.criterion_borders, np.float32))
            self.use_autocast_, forced = determine_precision(self.inference_precision, self.device_)
            if forced is not None:
                self.use_autocast_ = forced == "bfloat16"

            self.interface_config_ = ModelInterfaceConfig.from_user_input(
                inference_config=self.inference_config
            )
            icfg = self.interface_config_

            outlier_std = icfg.OUTLIER_REMOVAL_STD
            if outlier_std == "auto":
                outlier_std = icfg._REGRESSION_DEFAULT_OUTLIER_REMOVAL_STD
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
                    classification=False,
                )
                if feature_names_in is not None:
                    self.feature_names_in_ = feature_names_in
                self.n_features_in_ = n_features_in
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

            y = np.asarray(y, dtype=np.float64)

            # per-member target transforms (reference `regressor.py:477-493`)
            target_preprocessors = [
                None if name is None else ReshapeFeatureDistributionsStep.make_transformer(
                    name, num_examples=y.shape[0], random_state=static_seed)
                for name in icfg.REGRESSION_Y_PREPROCESS_TRANSFORMS or (None,)
            ]
            preprocess_transforms = icfg.PREPROCESS_TRANSFORMS
            ensemble_configs = EnsembleConfig.generate_for_regression(
                n=self.n_estimators,
                subsample_size=icfg.SUBSAMPLE_SAMPLES,
                add_fingerprint_feature=icfg.FINGERPRINT_FEATURE,
                feature_shift_decoder=icfg.FEATURE_SHIFT_METHOD,
                polynomial_features=icfg.POLYNOMIAL_FEATURES,
                max_index=max_index,
                preprocessor_configs=(
                    preprocess_transforms
                    if preprocess_transforms is not None
                    else default_regressor_preprocessor_configs()
                ),
                target_transforms=target_preprocessors,
                random_state=rng,
            )
            assert len(ensemble_configs) == self.n_estimators

            # standardize y; the renormalized criterion maps back to raw-y space
            # (reference `regressor.py:510-518`). Its borders are float32, each
            # operation rounded as the JAX package's (float32 borders times a
            # Python float, plus a Python float)
            mean, std = float(np.mean(y)), float(np.std(y))
            self.y_train_std_ = std + 1e-20
            self.y_train_mean_ = mean
            y = (y - self.y_train_mean_) / self.y_train_std_
            borders32 = self.bardist_.borders.numpy()
            self.renormalized_criterion_ = FullSupportBarDistribution(
                torch.from_numpy(borders32 * np.float32(self.y_train_std_) + np.float32(self.y_train_mean_))
            )

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

    def predict(
        self,
        X,
        image_test: np.ndarray | None = None,
        *,
        output_type: Literal["mean", "median", "mode", "quantiles", "full", "main"] = "mean",
        quantiles: list[float] | None = None,
    ):
        """Member logits -> border transform -> probability translation ->
        average -> distribution statistics (reference `regressor.py:577-765`)."""
        return self._finalize_predict(
            self._dispatch_predict(X, image_test), output_type=output_type, quantiles=quantiles
        )

    def predict_many(
        self,
        Xs,
        image_tests=None,
        *,
        output_type: Literal["mean", "median", "mode", "quantiles", "full", "main"] = "mean",
        quantiles: list[float] | None = None,
        max_in_flight: int = 2,
    ) -> list:
        """``predict`` over a stream of requests, pipelined as
        `MMPFNClassifier.predict_proba_many` is: request N+1 is dispatched
        before request N is finalized. The results are exactly the
        sequential predicts."""
        return pipeline_requests(
            self._dispatch_predict,
            lambda h: self._finalize_predict(h, output_type=output_type, quantiles=quantiles),
            Xs,
            image_tests,
            max_in_flight,
        )

    def _finalize_predict(self, handle, *, output_type: str = "mean", quantiles=None):
        """The engine's member logits (the host sync), then the host finalize."""
        with span("mmpfn.predict.finalize"):
            return self.predict_from_outputs(
                self.executor_.finalize_outputs(handle), output_type=output_type, quantiles=quantiles
            )

    def predict_from_outputs(self, member_outputs, *, output_type: str = "mean", quantiles=None):
        """The host finalize of a predict from the members' (logits, config)
        pairs: temperature, each member's borders through its inverse target
        transform (broken borders' logits cancelled), the translation of every
        member onto the standardized borders, the average (of probabilities,
        or of log-probabilities with ``average_before_softmax``), and the
        statistics over the renormalized borders."""
        if quantiles is None:
            quantiles = DEFAULT_QUANTILES
        else:
            assert all(isinstance(q, float) and 0 <= q <= 1 for q in quantiles)
        if output_type not in _USABLE_OUTPUT_TYPES:
            raise ValueError(f"Invalid output type: {output_type}")

        std_borders = self.bardist_.borders.numpy().astype(np.float64)
        translated = []
        for output, config in member_outputs:
            output = np.asarray(output, dtype=np.float64)
            if self.softmax_temperature != 1:
                output = output / self.softmax_temperature
            if config.target_transform is None:
                borders_t, logit_cancel_mask = std_borders.copy(), None
            else:
                logit_cancel_mask, _, borders_t = transform_borders_one(
                    std_borders,
                    target_transform=config.target_transform,
                    repair_nan_borders_after_transform=(
                        self.interface_config_.FIX_NAN_BORDERS_AFTER_TARGET_TRANSFORM
                    ),
                )
            if logit_cancel_mask is not None:
                output = output.copy()
                output[..., logit_cancel_mask] = -np.inf
            translated.append(
                translate_probs_across_borders(output, frm=np.asarray(borders_t), to=std_borders)
            )
        stacked = np.stack(translated, axis=0)
        if self.average_before_softmax:
            logs = np.log(np.clip(stacked, 1e-300, None)).mean(axis=0)
            probs = np.exp(logs - logs.max(axis=-1, keepdims=True))
            probs = probs / probs.sum(axis=-1, keepdims=True)
        else:
            probs = stacked.mean(axis=0)
        logits = torch.from_numpy(np.log(np.clip(probs, 1e-300, None)).astype(np.float32))

        crit = self.renormalized_criterion_

        def to_output(kind):
            if kind == "quantiles":
                return [crit.icdf(logits, q).numpy() for q in quantiles]
            return getattr(crit, kind)(logits).numpy()

        if output_type in ("full", "main"):
            out = {k: to_output(k) for k in _OUTPUT_TYPES}
            if output_type == "full":
                out = {"criterion": crit, "logits": logits.numpy(), **out}
            return out
        return to_output(output_type)


class TabPFNRegressor(MMPFNRegressor):
    """Vanilla tabular-only TabPFN-v2 regressor API: ``fit(X, y)`` / ``predict(X)``."""

    def __init__(self, **kwargs):
        kwargs.setdefault("mixer_type", "none")
        super().__init__(**kwargs)

    @classmethod
    def _get_param_names(cls) -> list[str]:
        # the constructor forwards **kwargs to the parent's
        return MMPFNRegressor._get_param_names()

    def fit(self, X, y):  # type: ignore[override]
        return super().fit(X, None, y)

    def predict(self, X, **kw):  # type: ignore[override]
        return super().predict(X, None, **kw)
