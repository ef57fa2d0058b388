"""KV-cached inference: prime on the train rows once, then predict test rows
against the cache (the counterpart of `multimodalpfn_tpu/models/cached.py`).

A prime forward over the train rows records, per layer, the item-attention K
and V of KV head 0 (the only head test queries use in multiquery mode,
reference `layer.py:344-358`) together with the encoder statistics fitted on
the train rows; a predict then runs only the test rows through the stack,
cross-attending to the cached K/V, and skips the train self-attention
(reference `mmpfn/models/mmpfn/inference.py:354-513`).

Cached-mode encoder statistics are fitted on the train rows only, whereas the
full forward computes its constant-column masks over the whole sequence
(`encoders.py:515,615`): the two agree exactly whenever the train rows alone
determine those masks.

The layers are sample-major ``(b, s, t, e)``, as in the JAX package. With
``cfg.fused_ops`` feature attention is K5 (K6b for a cross-width group, whose
members mask their padded feature tokens) and the MLP K3; with
``cfg.use_flash`` the train self-attention in `prime_cache` and the
multiquery test attention in `forward_cached` run K4.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.encoders import (
    _constant_column_mask,
    torch_nanmean,
    torch_nanstd,
)
from multimodalpfn_tpu_torch.models.mixers import apply_mixer
from multimodalpfn_tpu_torch.models.transformer import (
    DTYPES,
    _group_features,
    _layer,
    _mlp,
    positional_embedding,
    residual_ln,
)
from multimodalpfn_tpu_torch.ops.attention import mha, self_attention
from multimodalpfn_tpu_torch.ops.flash import flash_attention
from multimodalpfn_tpu_torch.ops.fused import (
    MAX_FUSED_ATTN_TOKENS,
    fused_feature_attention_ln,
    fused_mlp_ln,
    ln_rows,
)


class EncoderStats(NamedTuple):
    """Train-fitted statistics of the on-device encoder steps."""

    sel: torch.Tensor | None  # (b, f, n) non-constant mask (RemoveEmpty)
    order: torch.Tensor | None  # (b, f, n) left-compaction order (n > 1)
    nan_means: torch.Tensor | None  # (b, f, n)
    out_lower: torch.Tensor | None  # (b, 1, f, n)
    out_upper: torch.Tensor | None
    norm_mean: torch.Tensor | None  # (b, f, n)
    norm_std: torch.Tensor | None
    used: torch.Tensor | None  # (b, f, 1)
    y_mean: torch.Tensor  # (b,)
    y_sorted: torch.Tensor  # (b, S_tr) sorted train targets
    y_is_first: torch.Tensor  # (b, S_tr)


class TrainsetCache(NamedTuple):
    stats: EncoderStats
    # (L, b, t, 2, S_tr, d): per layer the item-attention K and V of head 0
    kv0: torch.Tensor
    # cross-width batching: the (b, t) per-member feature-attention key mask
    # and the (b, t_x, k) per-member subspace-noise tables the prime used,
    # which every predict reuses (None for a group of one width)
    token_valid: torch.Tensor | None = None
    feat_pos_noise: torch.Tensor | None = None


def slice_members(cache: TrainsetCache, sl: slice) -> TrainsetCache:
    """The cache of members ``sl`` (views, no copy)."""
    stats = EncoderStats(*(None if f is None else f[sl] for f in cache.stats))
    tv, noise = (None if f is None else f[sl] for f in (cache.token_valid, cache.feat_pos_noise))
    return TrainsetCache(stats, cache.kv0[:, sl], tv, noise)


def _compact(xg: torch.Tensor, sel: torch.Tensor, order: torch.Tensor | None) -> torch.Tensor:
    """Zero the constant columns of xg ``(b, s, f, n)``, left-compacting the
    kept ones within each group by ``order``."""
    zero = torch.zeros((), dtype=xg.dtype, device=xg.device)
    if order is None:
        return torch.where(sel[:, None], xg, zero)
    x = torch.gather(xg, -1, order[:, None].expand_as(xg))
    return torch.where(torch.gather(sel, -1, order)[:, None], x, zero)


def fit_encoder_stats(
    cfg: ModelConfig, xg: torch.Tensor | None, y_train: torch.Tensor
) -> EncoderStats:
    """Fit the encoder pipeline's statistics on the train rows (the
    reference's SeqEncStep._fit with cache_trainset_representation,
    `encoders.py:349-379`)."""
    sel = order = nan_means = out_lo = out_hi = norm_mean = norm_std = used = None
    if xg is not None:
        sep = xg.shape[1]
        sel = _constant_column_mask(xg)
        if xg.shape[-1] > 1:
            # kept columns first, stably (jnp.argsort(~sel, stable=True))
            order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)
        x = _compact(xg, sel, order)
        isnan = torch.isnan(x)
        cnt = (~isnan).sum(dim=1).to(x.dtype)
        nan_means = torch.where(isnan, torch.zeros_like(x), x).sum(dim=1) / cnt
        x = torch.where(isnan | torch.isinf(x), nan_means[:, None].expand_as(x), x)
        if cfg.remove_outliers:
            # bounds from the two-pass train estimate; the train rows are
            # squashed so the statistics below match the full forward's
            sig = cfg.remove_outliers_sigma
            m1, s1 = torch_nanmean(x, dim=1), torch_nanstd(x, dim=1)
            clean = torch.where(
                (x > (m1 + s1 * sig)[:, None]) | (x < (m1 - s1 * sig)[:, None]),
                torch.full_like(x, float("nan")),
                x,
            )
            m2, s2 = torch_nanmean(clean, dim=1), torch_nanstd(clean, dim=1)
            out_lo = (m2 - s2 * sig)[:, None]
            out_hi = (m2 + s2 * sig)[:, None]
            x = torch.maximum(-torch.log1p(torch.abs(x)) + out_lo, x)
            x = torch.minimum(torch.log1p(torch.abs(x)) + out_hi, x)
        norm_mean = torch_nanmean(x, dim=1)
        norm_std = torch_nanstd(x, dim=1) + 1e-20
        if sep == 1:
            norm_std = torch.ones_like(norm_std)
        xn = torch.clamp((x - norm_mean[:, None]) / norm_std[:, None], -100, 100)
        used = _constant_column_mask(xn).sum(dim=-1, keepdim=True).to(x.dtype).clamp(min=1.0)
    y = y_train.float()
    isnan_y = torch.isnan(y)
    cnt_y = (~isnan_y).sum(dim=1).float()
    y_mean = torch.where(isnan_y, torch.zeros_like(y), y).sum(dim=1) / cnt_y
    y_filled = torch.where(isnan_y | torch.isinf(y), y_mean[:, None].expand_as(y), y)
    y_sorted, _ = torch.sort(y_filled, dim=1)
    y_is_first = torch.cat(
        [torch.ones_like(y_sorted[:, :1], dtype=torch.bool), y_sorted[:, 1:] != y_sorted[:, :-1]],
        dim=1,
    )
    return EncoderStats(
        sel, order, nan_means, out_lo, out_hi, norm_mean, norm_std, used,
        y_mean, y_sorted, y_is_first,
    )


def _indicators(x: torch.Tensor) -> torch.Tensor:
    isnan, isinf = torch.isnan(x), torch.isinf(x)
    return (isnan * -2.0 + (isinf & (x > 0)) * 2.0 + (isinf & (x < 0)) * 4.0).to(x.dtype)


def apply_encoder(
    params_enc: dict, cfg: ModelConfig, stats: EncoderStats, xg: torch.Tensor
) -> torch.Tensor:
    """Encode any rows ``(b, s, f, n)`` with the fitted statistics ->
    ``(b, s, f, emsize)``."""
    x = _compact(xg, stats.sel, stats.order)
    indicators = _indicators(x)
    x = torch.where(torch.isnan(x) | torch.isinf(x), stats.nan_means[:, None].expand_as(x), x)
    if stats.out_lower is not None:
        x = torch.maximum(-torch.log1p(torch.abs(x)) + stats.out_lower, x)
        x = torch.minimum(torch.log1p(torch.abs(x)) + stats.out_upper, x)
    x = torch.clamp((x - stats.norm_mean[:, None]) / stats.norm_std[:, None], -100, 100)
    x = x * torch.sqrt(x.shape[-1] / stats.used)[:, None]
    feats = torch.cat([x, indicators], dim=-1)
    return feats.to(params_enc["w"].dtype) @ params_enc["w"]


def apply_y_encoder(
    params_y: dict, cfg: ModelConfig, stats: EncoderStats, y: torch.Tensor
) -> torch.Tensor:
    """Encode targets ``(b, s)`` (NaN for test rows) with the fitted
    statistics -> ``(b, s, emsize)``."""
    indicators = _indicators(y).float()
    y = y.float()
    y = torch.where(torch.isnan(y) | torch.isinf(y), stats.y_mean[:, None].expand_as(y), y)
    if cfg.max_num_classes >= 2:
        below = (stats.y_sorted[:, None, :] < y[:, :, None]) & stats.y_is_first[:, None, :]
        y = below.sum(dim=-1).float()
    feats = torch.stack([y, indicators], dim=-1)
    return feats.to(params_y["w"].dtype) @ params_y["w"] + params_y["b"]


def _embed(params, cfg, stats, x, image, b, n_feature_tokens=None, feat_pos_noise=None) -> torch.Tensor:
    """Feature tokens ``(b, s, t_x, e)``: encoded tabular groups, then mixer
    tokens, plus the subspace positional embedding (per-member tables
    ``feat_pos_noise`` for a cross-width group)."""
    embedded_x = None
    if x is not None:
        xg = _group_features(x.float(), cfg.features_per_group)
        embedded_x = apply_encoder(params["encoder"], cfg, stats, xg)
    if image is not None:
        tokens = apply_mixer(params["mixer"], cfg.mixer, image.float())
        if tokens.shape[0] == 1 and b > 1:
            # members share the image: the mixer runs once and its tokens broadcast
            tokens = tokens.expand(b, *tokens.shape[1:])
        embedded_x = tokens if embedded_x is None else torch.cat([embedded_x, tokens], dim=-2)
    if n_feature_tokens is not None and embedded_x.shape[-2] != n_feature_tokens:
        raise ValueError(
            f"{embedded_x.shape[-2]} feature tokens, but the cache was primed with {n_feature_tokens}"
        )
    if cfg.feature_positional_embedding == "subspace":
        embedded_x = embedded_x + positional_embedding(
            params, cfg, embedded_x.shape[-2], feat_pos_noise, embedded_x.device
        )
    return embedded_x


def _feat_sublayer(
    st: torch.Tensor, lp: dict, cd: torch.dtype, cfg: ModelConfig, token_valid=None
) -> torch.Tensor:
    """Feature attention + residual + post-norm on ``(b, s, t, e)``: K5 (K6b
    with the per-member key mask ``token_valid`` ``(b, t)``, broadcast to
    ``(b, 1, t)`` over the rows) under ``cfg.fused_ops`` for up to
    `MAX_FUSED_ATTN_TOKENS` tokens, else plain (the residual sum in the
    compute dtype)."""
    w_qkv, w_out = lp["attn_feat"]["w_qkv"], lp["attn_feat"]["w_out"]
    if cfg.fused_ops and st.shape[-2] <= MAX_FUSED_ATTN_TOKENS:
        km = None if token_valid is None else token_valid[:, None, :]
        return fused_feature_attention_ln(st.to(cd), w_qkv, w_out, key_mask=km)
    st = st.to(cd)
    km = None if token_valid is None else token_valid[:, None, None, None, :]
    return residual_ln(st, self_attention(st, w_qkv, w_out, compute_dtype=cd, key_mask=km))


def _mlp_sublayer(st: torch.Tensor, lp: dict, cd: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    """MLP + residual + post-norm: K3 under ``cfg.fused_ops``, else plain."""
    w1, w2 = lp["mlp"]["w1"], lp["mlp"]["w2"]
    if cfg.fused_ops:
        return fused_mlp_ln(st.to(cd).contiguous(), w1, w2)
    return residual_ln(st, _mlp(st, w1, w2, cd))


@torch.no_grad()
def prime_cache(
    params: dict,
    cfg: ModelConfig,
    x_train: torch.Tensor | None,
    y_train: torch.Tensor,
    image_train: torch.Tensor | None = None,
    token_valid: torch.Tensor | None = None,
    feat_pos_noise: torch.Tensor | None = None,
) -> TrainsetCache:
    """Run the train rows through the stack, recording per layer the item
    attention's K and V of head 0 (the reference caches them inside the train
    self-attention, `layer.py:362-372`).

    x_train ``(b, S_tr, F)`` or None, y_train ``(b, S_tr)``, image_train
    ``(b or 1, S_tr, N_img, in_dim)`` or None. A cross-width group passes
    ``token_valid``, the ``(b, t)`` per-member key mask over the whole token
    axis (`transformer.member_token_valid`), and ``feat_pos_noise``, as in
    `transformer.forward`; the cache keeps both for its predicts."""
    cd = DTYPES[cfg.compute_dtype]
    b = y_train.shape[0]
    xg = None if x_train is None else _group_features(x_train.float(), cfg.features_per_group)
    stats = fit_encoder_stats(cfg, xg, y_train)
    embedded_x = _embed(params, cfg, stats, x_train, image_train, b, feat_pos_noise=feat_pos_noise)
    embedded_y = apply_y_encoder(params["y_encoder"], cfg, stats, y_train)
    st = torch.cat([embedded_x, embedded_y[:, :, None, :]], dim=2).to(cd)  # (b, s, t, e)

    kv0 = []
    for l in range(cfg.nlayers):
        lp = _layer(params, l)
        st = _feat_sublayer(st, lp, cd, cfg, token_valid)
        sti = st.transpose(1, 2)  # (b, t, s, e)
        w_qkv = lp["attn_item"]["w_qkv"].to(cd)
        # K and V of head 0 from the post-feature-attention state, rounded to
        # the compute dtype (cached.py:293-299)
        k0 = torch.einsum("btsi,di->btsd", sti, w_qkv[1, 0])
        v0 = torch.einsum("btsi,di->btsd", sti, w_qkv[2, 0])
        kv0.append(torch.stack([k0, v0], dim=2))  # (b, t, 2, s, d)
        # the full train self-attention advances the state; mha returns the
        # compute dtype, so the residual sum is in the compute dtype
        h = mha(sti, sti, w_qkv, lp["attn_item"]["w_out"], compute_dtype=cd,
                use_flash=cfg.use_flash)
        st = residual_ln(st, h.transpose(1, 2))
        st = _mlp_sublayer(st, lp, cd, cfg)
    return TrainsetCache(stats, torch.stack(kv0), token_valid, feat_pos_noise)


def _cached_item_attention(
    sti: torch.Tensor, kv0: torch.Tensor, lp: dict, cd: torch.dtype, cfg: ModelConfig
) -> torch.Tensor:
    """Multiquery attention of the test rows sti ``(b, t, s, e)`` against
    one layer's cached K/V ``(b, t, 2, S_tr, d)``; returns the out-projection
    ``(b, t, s, e)`` in float32 (`cached.py:362-402`)."""
    wq = lp["attn_item"]["w_qkv"][0].to(cd)  # (h, d, e)
    w_out = lp["attn_item"]["w_out"].to(cd)
    h_n, d = wq.shape[:2]
    b, t, s, _ = sti.shape
    k0, v0 = kv0[:, :, 0].to(cd), kv0[:, :, 1].to(cd)  # (b, t, S_tr, d)
    if cfg.use_flash:
        # the query heads fold into K4's query axis, head-major, against the
        # single cached KV head; q in the compute dtype
        q = torch.einsum("btsi,hdi->bthsd", sti.to(cd), wq).contiguous().reshape(b * t, h_n * s, d)
        # the cache's K and V of head 0 are strided views: K4 takes contiguous operands
        k0, v0 = k0.contiguous().reshape(b * t, -1, d), v0.contiguous().reshape(b * t, -1, d)
        o, _ = flash_attention(q, k0, v0)
        o = o.reshape(b, t, h_n, s, d).to(cd).float()
        return torch.einsum("bthqd,hdo->btqo", o, w_out.float())
    # plain: bf16 products accumulated and emitted in float32, as the JAX
    # einsums with preferred_element_type=float32
    q = torch.einsum("btsi,hdi->btshd", sti.to(cd).float(), wq.float()).to(cd).float()
    logits = torch.einsum("btqhd,btkd->bthqk", q, k0.float()) * (1.0 / math.sqrt(d))
    p = torch.softmax(logits, dim=-1).to(cd).float()
    o = torch.einsum("bthqk,btkd->btqhd", p, v0.float()).to(cd).float()
    return torch.einsum("btqhd,hdo->btqo", o, w_out.float())


@torch.no_grad()
def forward_cached(
    params: dict,
    cfg: ModelConfig,
    cache: TrainsetCache,
    x_test: torch.Tensor | None,
    image_test: torch.Tensor | None = None,
) -> torch.Tensor:
    """Predict test rows against the primed cache (reference
    `inference.py:461-513` with single_eval_pos=None). x_test ``(b, s, F)``
    or None, image_test ``(b or 1, s, N_img, in_dim)`` or None. Returns logits
    ``(b, s, n_out)`` in float32."""
    cd = DTYPES[cfg.compute_dtype]
    b = cache.kv0.shape[1]
    embedded_x = _embed(params, cfg, cache.stats, x_test, image_test, b,
                        n_feature_tokens=cache.kv0.shape[2] - 1,
                        feat_pos_noise=cache.feat_pos_noise)
    s_te = embedded_x.shape[1]
    y_nan = torch.full((b, s_te), float("nan"), device=embedded_x.device)
    embedded_y = apply_y_encoder(params["y_encoder"], cfg, cache.stats, y_nan)
    st = torch.cat([embedded_x, embedded_y[:, :, None, :]], dim=2).to(cd)

    for l in range(cfg.nlayers):
        lp = _layer(params, l)
        st = _feat_sublayer(st, lp, cd, cfg, cache.token_valid)
        h = _cached_item_attention(st.transpose(1, 2), cache.kv0[l], lp, cd, cfg)
        # the out-projection is float32 here, so the residual sum is too
        st = ln_rows(st.float() + h.transpose(1, 2)).to(cd)
        st = _mlp_sublayer(st, lp, cd, cfg)

    test_targets = st[:, :, -1].float()
    dec = params["decoder"]
    hidden = F.gelu(test_targets @ dec["w1"] + dec["b1"], approximate="none")
    return hidden @ dec["w2"] + dec["b2"]
