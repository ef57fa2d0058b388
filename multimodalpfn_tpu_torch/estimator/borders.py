"""Regression border transforms and probability translation (host numpy).

The port's own copy of the JAX package's `estimator/borders.py`, which
follows the reference (`mmpfn/models/mmpfn/utils.py:42-95,648-700,748-794`).
Each ensemble member's target transform warps the bar-distribution borders;
broken (NaN or extreme) borders are repaired, and the member's probabilities
are re-expressed over the shared standardized borders before averaging.

`_cdf` keeps the reference's precedence quirk ``ys - borders[b] / widths[b]``
(`utils.py:648-676`): translating a distribution onto its own borders is
therefore not the identity, and every member is translated, whether or not
it has a target transform.
"""

from __future__ import annotations

import numpy as np

from multimodalpfn_tpu_torch.estimator.interface_config import (
    REGRESSION_NAN_BORDER_LIMIT_LOWER,
    REGRESSION_NAN_BORDER_LIMIT_UPPER,
)


def repair_borders(borders: np.ndarray) -> None:
    """In-place repair of extreme/NaN borders (reference `utils.py:42-65`)."""
    if np.isnan(borders[-1]):
        nans = np.isnan(borders)
        largest = borders[~nans].max()
        borders[nans] = largest
        borders[-1] = borders[-1] * 2
    if borders[-1] - borders[-2] < 1e-6:
        borders[-1] = borders[-1] * 1.1
    if borders[0] == borders[1]:
        borders[0] -= np.abs(borders[0] * 0.1)


def cancel_nan_borders(
    *, borders: np.ndarray, broken_mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Collapse contiguous broken border runs at either end and emit the logit
    mask (reference `utils.py:68-95`)."""
    borders = borders.copy()
    num_right = int((broken_mask[:-1] > broken_mask[1:]).sum())
    num_left = int((broken_mask[1:] > broken_mask[:-1]).sum())
    assert num_left <= 1 and num_right <= 1
    if num_right:
        assert bool(broken_mask[0])
        rightmost = np.where(broken_mask[:-1] > broken_mask[1:])[0][0] + 1
        borders[:rightmost] = borders[rightmost]
        borders[0] = borders[1] - 1.0
    if num_left:
        assert bool(broken_mask[-1])
        leftmost = np.where(broken_mask[1:] > broken_mask[:-1])[0][0]
        borders[leftmost + 1 :] = borders[leftmost]
        borders[-1] = borders[-2] + 1.0
    logit_cancel_mask = broken_mask[1:] | broken_mask[:-1]
    return borders, logit_cancel_mask


def transform_borders_one(
    borders: np.ndarray,
    target_transform,
    *,
    repair_nan_borders_after_transform: bool,
) -> tuple[np.ndarray | None, bool, np.ndarray]:
    """Push the standardized borders through a member's inverse target
    transform (reference `_transform_borders_one`, `utils.py:748-794`).
    Returns (logit cancel mask or None, whether the borders came out
    descending, the borders in ascending order)."""
    borders_t = np.asarray(
        target_transform.inverse_transform(borders.reshape(-1, 1))
    ).squeeze()
    logit_cancel_mask = None
    if repair_nan_borders_after_transform:
        broken = (
            ~np.isfinite(borders_t)
            | (borders_t > REGRESSION_NAN_BORDER_LIMIT_UPPER)
            | (borders_t < REGRESSION_NAN_BORDER_LIMIT_LOWER)
        )
        if broken.any():
            borders_t, logit_cancel_mask = cancel_nan_borders(
                borders=borders_t, broken_mask=broken
            )
    repair_borders(borders_t)
    descending = bool(
        (np.argsort(borders_t) == np.arange(len(borders_t) - 1, -1, -1)).all()
    )
    if descending:
        borders_t = borders_t[::-1]
        logit_cancel_mask = (
            logit_cancel_mask[::-1] if logit_cancel_mask is not None else None
        )
    return logit_cancel_mask, descending, borders_t


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _map_to_bucket_ix(y, borders):
    ix = np.searchsorted(borders, y) - 1
    ix[y == borders[0]] = 0
    ix[y == borders[-1]] = len(borders) - 2
    return ix


def _cdf(logits: np.ndarray, borders: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """CDF evaluation used for border translation: the reference's formula,
    including its share-of-bucket expression (`utils.py:648-676`, whose
    ``ys - borders[b] / widths[b]`` precedence quirk is kept for parity)."""
    ys = np.broadcast_to(ys, logits.shape[:-1] + ys.shape[-1:]).copy()
    n_bars = len(borders) - 1
    buckets = np.clip(_map_to_bucket_ix(ys, borders), 0, n_bars - 1)
    probs = _softmax(logits, axis=-1)
    prob_so_far = np.cumsum(probs, axis=-1) - probs
    prob_left = np.take_along_axis(prob_so_far, buckets, axis=-1)
    widths = borders[1:] - borders[:-1]
    share = np.clip(ys - borders[buckets] / widths[buckets], 0.0, 1.0)
    prob_in = np.take_along_axis(probs, buckets, axis=-1) * share
    out = prob_left + prob_in
    out[ys <= borders[0]] = 0.0
    out[ys >= borders[-1]] = 1.0
    return np.clip(out, 0.0, 1.0)


def translate_probs_across_borders(
    logits: np.ndarray, *, frm: np.ndarray, to: np.ndarray
) -> np.ndarray:
    """Probabilities over ``frm`` borders re-binned onto ``to`` borders
    (reference `utils.py:678-700`)."""
    prob_left = _cdf(logits, frm, to)
    prob_left[..., 0] = 0.0
    prob_left[..., -1] = 1.0
    return np.clip(prob_left[..., 1:] - prob_left[..., :-1], 0.0, None)
