"""Model initialization + precision policy for the estimators.

Reference semantics: `mmpfn/models/mmpfn/base.py:59-257` and `utils.py:98-190`.
"""

from __future__ import annotations

import inspect
import os
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from multimodalpfn_tpu_torch.estimator.data_utils import OrdinalEncoder, fix_dtypes, validate_X_predict
from multimodalpfn_tpu_torch.models.download import ensure_model, resolve_model_path
from multimodalpfn_tpu_torch.models.loading import (
    DEFAULT_CLASSIFIER_CONFIG,
    DEFAULT_REGRESSOR_CONFIG,
    LoadedModel,
    load_model,
)
from multimodalpfn_tpu_torch.utils.profiling import span


class NotFittedError(ValueError, AttributeError):
    """Raised by a predict before ``fit``: a ``ValueError`` and an
    ``AttributeError``, as scikit-learn's ``NotFittedError`` is."""


class EstimatorBase:
    """What the two estimators share: the estimator contract the JAX
    package's inherit from scikit-learn's ``BaseEstimator`` (``get_params``,
    ``set_params``, so ``sklearn.base.clone``), written out so that
    scikit-learn is never imported; the fitted check; and the encoding of X."""

    @classmethod
    def _get_param_names(cls) -> list[str]:
        """The constructor's parameter names, sorted."""
        params = inspect.signature(cls.__init__).parameters.values()
        return sorted(p.name for p in params if p.name != "self" and p.kind != p.VAR_KEYWORD)

    def get_params(self, deep: bool = True) -> dict:
        """The constructor's parameters; none holds an estimator, so ``deep``
        changes nothing."""
        return {key: getattr(self, key) for key in self._get_param_names()}

    def set_params(self, **params):
        names = self._get_param_names()
        for key, value in params.items():
            if key not in names:
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator {type(self).__name__}. "
                    f"Valid parameters are: {names!r}."
                )
            setattr(self, key, value)
        return self

    def _check_fitted(self) -> None:
        if not hasattr(self, "executor_"):
            raise NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet. Call 'fit' with "
                "appropriate arguments before using this estimator."
            )

    def _encode_X(self, X, *, fit: bool) -> np.ndarray:
        """Dtype fixing + ordinal encoding of categorical/string columns. A
        numeric array without categorical indices passes through as float64
        (the ordinal encoder selects no column of it)."""
        X = fix_dtypes(X, cat_indices=self.categorical_features_indices)
        if fit:
            self.preprocessor_ = None if isinstance(X, np.ndarray) else OrdinalEncoder()
            if self.preprocessor_ is not None:
                return np.asarray(self.preprocessor_.fit_transform(X))
        elif self.preprocessor_ is not None:
            return np.asarray(self.preprocessor_.transform(X))
        return np.asarray(X)

    def _dispatch_predict(self, X, image_test: np.ndarray | None):
        """Validation, encoding and the engine's dispatch (no host sync)."""
        self._check_fitted()
        with span("mmpfn.predict.dispatch"):
            if X is not None:
                with span("mmpfn.preprocess.validate"):
                    X = self._encode_X(validate_X_predict(X, self), fit=False)
            return self.executor_.dispatch_outputs(X, image_test)


def _cache_dir() -> Path:
    env = os.environ.get("TABPFN_MODEL_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "multimodalpfn_tpu"


def default_model_config(which: Literal["classifier", "regressor"]) -> dict:
    """The published TabPFN-v2 architecture (reference `model/config.py:25-84`,
    `loading.py:492-495`): a copy of `models/loading.py`'s dict for the
    classifier, else the regressor's."""
    return dict(DEFAULT_CLASSIFIER_CONFIG if which == "classifier" else DEFAULT_REGRESSOR_CONFIG)


def resolve_auto_checkpoint(which: Literal["classifier", "regressor"] = "classifier") -> Path:
    """The published checkpoint for ``model_path="auto"``
    (``tabpfn-v2-classifier.ckpt`` or ``tabpfn-v2-regressor.ckpt``), found as
    the JAX package's `estimator/base.py:initialize_model` finds it: first in
    the legacy ``_cache_dir()``, then through `models.download.ensure_model`,
    which looks in ``$TABPFN_MODEL_CACHE_DIR``, or else in
    ``$XDG_CACHE_HOME/tabpfn`` or ``~/.cache/tabpfn`` where the reference
    caches it, and downloads it there when it is missing."""
    path, _, name = resolve_model_path("auto", which)
    legacy = _cache_dir() / name
    if legacy.exists():
        return legacy
    try:
        return ensure_model("auto", which)
    except (RuntimeError, ValueError) as e:
        raise FileNotFoundError(
            f"No checkpoint named {name} in {legacy.parent}, in "
            f"$TABPFN_MODEL_CACHE_DIR ({os.environ.get('TABPFN_MODEL_CACHE_DIR') or 'unset'}) or in "
            f"the user cache dir ($XDG_CACHE_HOME/tabpfn or ~/.cache/tabpfn: {path.parent}), and "
            f"the download failed (no egress?). Place the published {name} in one of them, pass "
            "model_path=..., or use model_path='random:<seed>' for an untrained model."
        ) from e


def resolve_device(device: str | torch.device) -> torch.device:
    """The device the estimator runs on. A CUDA device is never replaced by
    the CPU: without CUDA it raises, and the caller asks for the CPU
    explicitly with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            'pass device="cpu" to run on the CPU'
        )
    return device


def initialize_model(
    *,
    model_path: str | Path | Literal["auto"],
    static_seed: int,
    mixer_type: str,
    mgm_heads: int,
    cap_heads: int,
    features_per_group: int | None,
    device: torch.device,
    which: Literal["classifier", "regressor"] = "classifier",
) -> LoadedModel:
    """Load (or synthesize) the ``which`` model onto ``device``.

    - ``"auto"``: the published checkpoint from the model cache dirs
      (`resolve_auto_checkpoint`), downloaded there when it is missing.
    - an existing path: a reference-format torch checkpoint, or an ``.npz``
      written by `models.loading.save_npz`.
    - ``"random"`` / ``"random:<seed>"``: fresh random initialization with the
      published architecture — for benchmarking/testing without weights (a
      regressor's with the borders ``linspace(-12, 12, 5001)``).
    """
    if model_path == "auto":
        model_path = resolve_auto_checkpoint(which)
    return load_model(
        model_path,
        which=which,
        model_seed=static_seed,
        mixer_type=mixer_type,
        mgm_heads=mgm_heads,
        cap_heads=cap_heads,
        features_per_group=features_per_group,
        device=device,
    )


def determine_precision(inference_precision, device: torch.device) -> tuple[bool, str | None]:
    """Map the user precision knob to (autocast, forced_dtype)
    (reference `base.py:126-165`, `utils.py:150-190`): "auto" computes in
    bfloat16 on a CUDA device and in float32 on the CPU; an explicit dtype
    forces it."""
    if inference_precision == "autocast":
        return True, None
    if inference_precision == "auto":
        return device.type == "cuda", None
    if inference_precision in ("float32", np.float32, torch.float32, "f32"):
        return False, "float32"
    if inference_precision in ("bfloat16", torch.bfloat16, "bf16"):
        return True, "bfloat16"
    raise ValueError(f"Invalid inference_precision: {inference_precision}")


def pipeline_requests(dispatch, finalize, Xs, image_tests, max_in_flight: int) -> list:
    """The scheduling loop of a pipelined request stream
    (`MMPFNClassifier.predict_proba_many`): request N+1 is dispatched (host
    transforms, uploads and enqueued device work) before request N is
    finalized, so host and device overlap; at most ``max_in_flight``
    dispatched requests wait to be finalized. The results are exactly
    ``[finalize(dispatch(X, img)) for X, img in zip(Xs, image_tests)]``."""
    if max_in_flight < 1:
        raise ValueError("max_in_flight must be >= 1")
    if image_tests is None:
        image_tests = [None] * len(Xs)
    if len(image_tests) != len(Xs):
        raise ValueError(f"got {len(Xs)} X requests but {len(image_tests)} image requests")
    results: list = [None] * len(Xs)
    in_flight: list[tuple[int, object]] = []
    for i, (X, img) in enumerate(zip(Xs, image_tests)):
        in_flight.append((i, dispatch(X, img)))
        if len(in_flight) > max_in_flight:
            j, handle = in_flight.pop(0)
            results[j] = finalize(handle)
    for j, handle in in_flight:
        results[j] = finalize(handle)
    return results
