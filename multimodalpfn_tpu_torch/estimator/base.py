"""Model initialization + precision policy for the estimators.

Reference semantics: `mmpfn/models/mmpfn/base.py:59-257` and `utils.py:98-190`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from multimodalpfn_tpu_torch.models.download import CLASSIFIER_CKPT, cached_classifier_path
from multimodalpfn_tpu_torch.models.loading import LoadedModel, load_model


class NotFittedError(ValueError, AttributeError):
    """Raised by a predict before ``fit``: a ``ValueError`` and an
    ``AttributeError``, as scikit-learn's ``NotFittedError`` is."""


def _cache_dir() -> Path:
    env = os.environ.get("TABPFN_MODEL_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "multimodalpfn_tpu"


def resolve_auto_checkpoint() -> Path:
    """The published classifier checkpoint for ``model_path="auto"``, looked
    for where the JAX package looks (its `estimator/base.py:initialize_model`):
    first the legacy ``_cache_dir()``, then ``$TABPFN_MODEL_CACHE_DIR``, or
    else ``$XDG_CACHE_HOME/tabpfn`` or ``~/.cache/tabpfn``, where the
    reference caches it. There is no download."""
    legacy = _cache_dir() / CLASSIFIER_CKPT
    if legacy.exists():
        return legacy
    path = cached_classifier_path()
    if path.exists():
        return path
    raise FileNotFoundError(
        f"No checkpoint named {CLASSIFIER_CKPT} in {legacy.parent}, in "
        f"$TABPFN_MODEL_CACHE_DIR ({os.environ.get('TABPFN_MODEL_CACHE_DIR') or 'unset'}) or in "
        f"the user cache dir ($XDG_CACHE_HOME/tabpfn or ~/.cache/tabpfn: {path.parent}). "
        f"Place the published {CLASSIFIER_CKPT} in one of them, pass model_path=..., or use "
        "model_path='random:<seed>' for an untrained model."
    )


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
) -> LoadedModel:
    """Load (or synthesize) the model onto ``device``.

    - ``"auto"``: the published checkpoint from the model cache dirs
      (`resolve_auto_checkpoint`); there is no download path.
    - an existing path: a reference-format torch checkpoint, or an ``.npz``
      written by `models.loading.save_npz`.
    - ``"random"`` / ``"random:<seed>"``: fresh random initialization with the
      published architecture — for benchmarking/testing without weights.
    """
    if model_path == "auto":
        model_path = resolve_auto_checkpoint()
    return load_model(
        model_path,
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
