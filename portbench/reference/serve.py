"""The reference classifier: the estimator's host pipeline on the frozen
copy of the preprocessing (`portbench/reference/prep`), and each ensemble
member's forward through `model.forward`, one member at a time, with no
grouping, merging or bucket padding (too-z/MultiModalPFN `classifier.py`:
``fit`` and ``predict_proba``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model
from portbench.reference.prep.ensemble import EnsembleConfig, default_classifier_preprocessor_configs, \
    fit_preprocessing
from portbench.reference.prep.rng import infer_random_state


def infer_categorical_features(X: np.ndarray, min_samples: int = 100, min_unique_numerical: int = 4):
    """Columns with fewer than ``min_unique_numerical`` distinct values, on
    more than ``min_samples`` rows (`utils.py:infer_categorical_features`)."""
    if X.shape[0] <= min_samples:
        return []
    return [j for j in range(X.shape[1]) if len(np.unique(X[:, j])) < min_unique_numerical]


class Members:
    """The fitted ensemble: each member's preprocessed train rows, its
    train targets (class-permuted), its pipeline and its configuration."""

    def __init__(self, X_train: np.ndarray, y_train: np.ndarray, estimator: dict):
        static_seed, rng = infer_random_state(estimator["random_state"])
        X = np.asarray(X_train, dtype=np.float64)
        self.classes, y = np.unique(y_train, return_inverse=True)
        self.n_classes = len(self.classes)
        cat_ix = infer_categorical_features(X)
        configs = EnsembleConfig.generate_for_classification(
            n=estimator["n_estimators"], subsample_size=None, add_fingerprint_feature=True,
            feature_shift_decoder="shuffle", polynomial_features="no", max_index=len(X),
            preprocessor_configs=default_classifier_preprocessor_configs(),
            class_shift_method="shuffle", n_classes=self.n_classes, random_state=rng,
        )
        self.fitted = fit_preprocessing(configs, X, y, random_state=rng, cat_ix=cat_ix)
        self.temperature = estimator["softmax_temperature"]

    def widths(self) -> list[int]:
        return [Xm.shape[1] for _, _, Xm, _, _ in self.fitted]

    @torch.no_grad()
    def predict_proba(self, weights: dict, arch: dict, image_train: np.ndarray, X_test: np.ndarray,
                      image_test: np.ndarray, device, precision: str = "float32",
                      outlier_sigma: float | None = 12.0) -> np.ndarray:
        """The ensemble's probabilities of the test rows, float64."""
        img = torch.as_tensor(np.concatenate([image_train, image_test]), dtype=torch.float32,
                              device=device)
        probs = []
        for config, pipe, X_m, y_m, _ in self.fitted:
            X_te = pipe.transform(np.asarray(X_test, dtype=np.float64)).X
            x = torch.as_tensor(np.concatenate([X_m, X_te]), dtype=torch.float32, device=device)
            y = torch.as_tensor(y_m, dtype=torch.float32, device=device)
            logits = model.forward(weights, arch, x, y, img, outlier_sigma=outlier_sigma,
                                   precision=precision)
            out = logits.double().cpu().numpy()[:, :self.n_classes] / self.temperature
            if config.class_permutation is not None:
                out = out[..., config.class_permutation]
            out = np.exp(out - out.max(axis=1, keepdims=True))
            probs.append(out / out.sum(axis=1, keepdims=True))
        p = np.mean(probs, axis=0)
        return p / p.sum(axis=1, keepdims=True)
