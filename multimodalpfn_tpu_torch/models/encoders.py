"""Input and target tokenizers as plain functions on tensors.

Re-expresses the reference's `SequentialEncoder` step pipeline
(`mmpfn/models/mmpfn/model/encoders.py:17-974`) as the JAX package does
(`multimodalpfn_tpu/models/encoders.py`): every step is re-fit on each forward,
so the whole pipeline is a pure function of ``(x, single_eval_pos)``. Feature
removal is masking plus stable left-compaction within each feature group, which
reproduces the reference's ``select_features`` batch>1 semantics
(`encoders.py:102-130`).
"""

from __future__ import annotations

import torch

from multimodalpfn_tpu_torch.models.config import ModelConfig

# NaN/inf indicator codes (reference `encoders.py:431-433`)
NAN_INDICATOR = -2.0
INF_INDICATOR = 2.0
NEG_INF_INDICATOR = 4.0


def torch_nanmean(x: torch.Tensor, dim: int, clip_num: bool = True) -> torch.Tensor:
    """`torch_nanmean` parity (`encoders.py:17-34`): NaN-aware mean; infs count."""
    nan_mask = torch.isnan(x)
    num = (~nan_mask).sum(dim=dim).to(x.dtype)
    value = torch.where(nan_mask, torch.zeros_like(x), x).sum(dim=dim)
    if clip_num:
        num = num.clamp(min=1.0)
    return value / num


def torch_nanstd(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`torch_nanstd` parity (`encoders.py:37-50`): unbiased, NaN-aware."""
    nan_mask = torch.isnan(x)
    num = (~nan_mask).sum(dim=dim).to(x.dtype)
    value = torch.where(nan_mask, torch.zeros_like(x), x).sum(dim=dim)
    mean = value / num  # NaN if num == 0, matching torch
    diff2 = torch.square(mean.unsqueeze(dim) - x)
    ss = torch.where(nan_mask, torch.zeros_like(diff2), diff2).sum(dim=dim)
    return torch.sqrt(ss / (num - 1.0))


def _constant_column_mask(x: torch.Tensor) -> torch.Tensor:
    """sel = column varies (reference `encoders.py:515,615`): computed over the FULL
    sequence with torch equality semantics (NaN != NaN)."""
    eq = (x[:, 1:] == x[:, :1]).sum(dim=1)
    return eq != (x.shape[1] - 1)


def remove_empty_features(x: torch.Tensor) -> torch.Tensor:
    """Zero out constant columns, left-compacting within each feature group.
    x: ``(b, s, f, n)`` (`encoders.py:102-130,496-527`)."""
    sel = _constant_column_mask(x)  # (b, f, n) bool
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if x.shape[-1] == 1:
        return torch.where(sel[:, None], x, zero)
    order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)  # kept first
    xg = torch.gather(x, -1, order[:, None].expand_as(x))
    selg = torch.gather(sel, -1, order)
    return torch.where(selg[:, None], xg, zero)


def nan_handling(x: torch.Tensor, sep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NaN/inf replacement by train means + indicator channels
    (`NanHandlingEncoderStep`, `encoders.py:428-493`). Stats over axis 1 of
    ``x[:, :sep]``; means include infs (``torch.nanmean``)."""
    isnan = torch.isnan(x)
    isinf = torch.isinf(x)
    indicators = (
        isnan * NAN_INDICATOR
        + (isinf & (x > 0)) * INF_INDICATOR
        + (isinf & (x < 0)) * NEG_INF_INDICATOR
    ).to(x.dtype)
    train = x[:, :sep]
    train_nan = torch.isnan(train)
    cnt = (~train_nan).sum(dim=1).to(x.dtype)
    means = torch.where(train_nan, torch.zeros_like(train), train).sum(dim=1) / cnt
    x = torch.where(isnan | isinf, means[:, None].expand_as(x), x)
    return x, indicators


def outlier_squash(x: torch.Tensor, sep: int, n_sigma: float) -> torch.Tensor:
    """Two-pass soft outlier squashing (reference `remove_outliers`,
    `encoders.py:133-162`)."""
    data = x[:, :sep]
    mean1 = torch_nanmean(data, dim=1)
    std1 = torch_nanstd(data, dim=1)
    cut = std1 * n_sigma
    lower1, upper1 = mean1 - cut, mean1 + cut
    clean = torch.where(
        (data > upper1[:, None]) | (data < lower1[:, None]),
        torch.full_like(data, float("nan")),
        data,
    )
    mean2 = torch_nanmean(clean, dim=1)
    std2 = torch_nanstd(clean, dim=1)
    cut2 = std2 * n_sigma
    lower, upper = (mean2 - cut2)[:, None], (mean2 + cut2)[:, None]
    x = torch.maximum(-torch.log1p(torch.abs(x)) + lower, x)
    return torch.minimum(torch.log1p(torch.abs(x)) + upper, x)


def normalize_by_train_stats(x: torch.Tensor, sep: int, seq_len: int) -> torch.Tensor:
    """Train-stat z-normalization with ±100 clipping (`normalize_data`,
    `encoders.py:53-99`)."""
    train = x[:, :sep]
    mean = torch_nanmean(train, dim=1)
    std = torch_nanstd(train, dim=1) + 1e-20
    if seq_len == 1 or sep == 1:
        std = torch.ones_like(std)
    x = (x - mean[:, None]) / std[:, None]
    return torch.clamp(x, -100, 100)


def variance_rescale(x: torch.Tensor) -> torch.Tensor:
    """`VariableNumFeaturesEncoderStep` (`encoders.py:579-655`): multiply by
    sqrt(n_features / n_used), n_used = non-constant columns of the FULL
    sequence per feature group."""
    sel = _constant_column_mask(x)  # (b, f, n)
    used = sel.sum(dim=-1, keepdim=True).to(x.dtype).clamp(min=1.0)
    n = x.shape[-1]
    return x * torch.sqrt(n / used)[:, None]


def encode_x(params_enc: dict, cfg: ModelConfig, x: torch.Tensor, sep: int) -> torch.Tensor:
    """Full input-encoder pipeline on grouped input ``(b, s, f, n)`` (may hold
    NaN/inf). Step order mirrors reference `loading.py:308-371`: RemoveEmpty ->
    NanHandling -> InputNormalization -> VariableNumFeatures -> Linear
    (bias-free, ``params_enc["w"]`` is ``(2*fpg, emsize)``)."""
    if cfg.remove_empty_features:
        x = remove_empty_features(x)
    if cfg.nan_handling_enabled:
        x, indicators = nan_handling(x, sep)
    else:
        indicators = torch.zeros_like(x)
    if cfg.remove_outliers:
        x = outlier_squash(x, sep, cfg.remove_outliers_sigma)
    if cfg.normalize_x:
        x = normalize_by_train_stats(x, sep, x.shape[1])
    if cfg.normalize_by_used_features:
        x = variance_rescale(x)
    feats = torch.cat([x, indicators], dim=-1)
    return feats.to(params_enc["w"].dtype) @ params_enc["w"]


def flatten_targets(y: torch.Tensor, sep: int) -> torch.Tensor:
    """`MulticlassClassificationTargetEncoder` parity (`encoders.py:949-974`):
    map each y to the count of *distinct* train-y values strictly below it."""
    t, _ = torch.sort(y[:, :sep], dim=1)
    is_first = torch.cat(
        [torch.ones_like(t[:, :1], dtype=torch.bool), t[:, 1:] != t[:, :-1]], dim=1
    )
    below = (t[:, None, :] < y[:, :, None]) & is_first[:, None, :]
    return below.sum(dim=-1).to(y.dtype)


def encode_y(params_y: dict, cfg: ModelConfig, y: torch.Tensor, sep: int) -> torch.Tensor:
    """Target encoder: NanHandling -> (classification) target flattening ->
    Linear. y: ``(b, s)`` float with NaN at test positions. Returns
    ``(b, s, emsize)`` (`get_y_encoder`, `loading.py:374-398`)."""
    if cfg.nan_handling_y_encoder:
        y, indicators = nan_handling(y, sep)
    else:
        indicators = torch.zeros_like(y)
    if cfg.max_num_classes >= 2:
        y = flatten_targets(y, sep)
    feats = torch.stack([y, indicators], dim=-1)
    return feats.to(params_y["w"].dtype) @ params_y["w"] + params_y["b"]
