"""Expert-user interface knobs.

Mirrors the reference `ModelInterfaceConfig` (`mmpfn/models/mmpfn/constants.py:34-211`)
including the key-by-key validation of user-supplied overrides."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Union

from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

SKLEARN_16_DECIMAL_PRECISION = 16
PROBABILITY_EPSILON_ROUND_ZERO = 1e-3
REGRESSION_NAN_BORDER_LIMIT_UPPER = 1e3
REGRESSION_NAN_BORDER_LIMIT_LOWER = -1e3


@dataclass
class ModelInterfaceConfig:
    MAX_UNIQUE_FOR_CATEGORICAL_FEATURES: int = 30
    MIN_UNIQUE_FOR_NUMERICAL_FEATURES: int = 4
    MIN_NUMBER_SAMPLES_FOR_CATEGORICAL_INFERENCE: int = 100

    OUTLIER_REMOVAL_STD: Union[float, None, Literal["auto"]] = "auto"
    """None = no outlier squash; float = sigma; "auto" = 12.0 clf / None reg."""
    _CLASSIFICATION_DEFAULT_OUTLIER_REMOVAL_STD: float = 12.0
    _REGRESSION_DEFAULT_OUTLIER_REMOVAL_STD: Union[float, None] = None

    FEATURE_SHIFT_METHOD: Union[Literal["shuffle", "rotate"], None] = "shuffle"
    CLASS_SHIFT_METHOD: Union[Literal["rotate", "shuffle"], None] = "shuffle"
    FINGERPRINT_FEATURE: bool = True
    POLYNOMIAL_FEATURES: Union[Literal["no", "all"], int] = "no"
    SUBSAMPLE_SAMPLES: Union[int, float, None] = None
    PREPROCESS_TRANSFORMS: Union[list[PreprocessorConfig], None] = None
    REGRESSION_Y_PREPROCESS_TRANSFORMS: Union[tuple, None] = (None, "safepower")

    MAX_NUMBER_OF_CLASSES: int = 10
    MAX_NUMBER_OF_FEATURES: int = 500
    MAX_NUMBER_OF_SAMPLES: int = 10_000

    FIX_NAN_BORDERS_AFTER_TARGET_TRANSFORM: bool = True
    USE_SKLEARN_16_DECIMAL_PRECISION: bool = False

    @classmethod
    def from_user_input(cls, *, inference_config) -> "ModelInterfaceConfig":
        if inference_config is None:
            return cls()
        if isinstance(inference_config, cls):
            return dataclasses.replace(inference_config)
        if isinstance(inference_config, dict):
            config = cls()
            valid = {f.name for f in dataclasses.fields(cls)}
            for k, v in inference_config.items():
                if k not in valid:
                    raise ValueError(
                        f"Unknown ModelInterfaceConfig key: {k!r}. Valid keys: {sorted(valid)}"
                    )
                setattr(config, k, v)
            return config
        raise TypeError(f"Invalid inference_config: {type(inference_config)}")
