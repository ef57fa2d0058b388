"""PerFeatureTransformer forward as a function of (params, inputs): `forward`
for inference, `forward_train_test` for fine-tuning (differentiable).

Reference semantics: `mmpfn/models/mmpfn/model/transformer.py:182-1039` and
`layer.py:95-466`; the structure follows the JAX package
(`multimodalpfn_tpu/models/transformer.py`):

  * ensemble members ride the leading batch axis;
  * feature positional embeddings come from the torch-CPU noise table
    (`models.params.get_subspace_noise`) drawn once per (seed, token count);
  * with ``cfg.fused_ops`` the stack runs item-major ``(b, t, s, e)`` through
    `encoder_layer_im`, whose three sublayers are the hand-written kernels K1,
    K2a+K2b and K3; otherwise, or for more feature tokens than K1 takes,
    through the sample-major `encoder_layer`;
  * members of different widths can share one forward (cross-width
    batching): zero-padded to the widest, each masks its padded feature
    tokens out of feature attention as keys (``tab_valid``; K6a in place of
    K1) and keeps its own positional-embedding draws (``feat_pos_noise``);
  * under autograd the kernel sublayers run their backward kernels (K7 for
    K1, K10 + K9 for K2a + K2b, K8 for K3; with the K2 gate refused, K11 for
    K4 in both item blocks) and the plain residual-LN saves its
    compute-dtype sum (`_ResidualLN`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.encoders import encode_x, encode_y
from multimodalpfn_tpu_torch.models.mixers import apply_mixer
from multimodalpfn_tpu_torch.models.params import get_subspace_noise
from multimodalpfn_tpu_torch.ops.attention import can_use_fused_item, item_attention, self_attention
from multimodalpfn_tpu_torch.ops.fused import (
    MAX_FUSED_ATTN_TOKENS,
    fused_feature_attention_ln_im,
    fused_mlp_ln,
    ln_rows,
    ln_rows_bwd,
)
from multimodalpfn_tpu_torch.ops.item_fused import fused_item_sublayer
from multimodalpfn_tpu_torch.ops.kernels import needs_grad
from multimodalpfn_tpu_torch.parallel.mesh import gather_leaf, shard_axis

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _ResidualLN(torch.autograd.Function):
    """``LN(x + h)`` saving only the compute-dtype sum u, whose LN statistics
    the backward recomputes exactly (the JAX package's `_residual_ln_vjp`,
    `models/transformer.py:43-93`); both cotangents are du in u's dtype."""

    @staticmethod
    def forward(ctx, x, h):
        u = x + h
        ctx.save_for_backward(u)
        return ln_rows(u.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        du = ln_rows_bwd(u.float(), g.float()).to(u.dtype)
        return du, du


def residual_ln(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``LN(x + h)``: the sum is formed in x's dtype, the LN in float32, the
    result is returned in x's dtype (reference post-norm, `layer.py:437-455`)."""
    h = h.to(x.dtype)
    if needs_grad(x, h):
        return _ResidualLN.apply(x, h)
    return ln_rows((x + h).float()).to(x.dtype)


def _mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Bias-free 2-layer exact-erf GELU MLP (reference `mlp.py:59-104`), in
    the compute dtype."""
    return F.gelu(x.to(cd) @ w1.to(cd), approximate="none") @ w2.to(cd)


def _layer(params: dict, l: int) -> dict:
    """Layer l's leaves. A tensor-parallel shard (`parallel.mesh.shard_params`)
    is all-gathered over the ambient mesh's ``mp`` axis here, so every kernel
    runs on the whole layer as on one device."""
    return {k: {n: _layer_leaf(w, l) for n, w in v.items()} for k, v in params["layers"].items()}


def _layer_leaf(w: torch.Tensor, l: int) -> torch.Tensor:
    axis = shard_axis(w)
    return w[l] if axis is None else gather_leaf(w[l], axis - 1)


def _item_sublayer(
    state: torch.Tensor, lp: dict, *, single_eval_pos: int, cfg: ModelConfig
) -> torch.Tensor:
    """Item-attention sublayer ``LN(x + attn(x))`` over the items axis of
    item-major state ``(b, t, s, e)``, in the compute dtype. With
    ``cfg.use_flash`` it runs the kernels K2a + K2b where the gate admits the
    configuration, and otherwise (no multiquery test block, a ring axis, or
    ``fused_item`` off) the flash kernel K4 inside `item_attention` (K11 its
    backward) and `residual_ln`, as the JAX package does; with ``use_flash``
    off, the plain path. Under ``cfg.seq_shard_axis`` the attention core is
    the ring over that mesh axis (on K4 and K11 with ``use_flash``)."""
    cd = DTYPES[cfg.compute_dtype]
    sep, S = single_eval_pos, state.shape[-2]
    multiquery = cfg.multiquery_item_attention_for_test_set
    if can_use_fused_item(
        sep,
        S - sep,
        fused_item=cfg.use_flash and cfg.fused_item,
        multiquery_test=multiquery,
        ring_axis=cfg.seq_shard_axis,
    ):
        return fused_item_sublayer(
            state,
            lp["attn_item"]["w_qkv"],
            lp["attn_item"]["w_out"],
            single_eval_pos=sep,
            compute_dtype=cd,
        )
    h = item_attention(
        state,
        lp["attn_item"]["w_qkv"],
        lp["attn_item"]["w_out"],
        single_eval_pos=sep,
        multiquery_test=multiquery,
        compute_dtype=cd,
        use_flash=cfg.use_flash,
        ring_axis=cfg.seq_shard_axis,
    )
    return residual_ln(state, h)


def encoder_layer_im(
    state: torch.Tensor,
    lp: dict,
    *,
    single_eval_pos: int,
    cfg: ModelConfig,
    token_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Item-major PerFeatureEncoderLayer on state ``(b, t, s, e)`` (contiguous):
    feature attention (K1, or with the per-member key mask ``token_valid``
    ``(b, t)`` K6a), item attention (`_item_sublayer`: K2a + K2b), MLP (K3),
    each with residual and post-norm."""
    cd = DTYPES[cfg.compute_dtype]
    state = fused_feature_attention_ln_im(
        state.to(cd), lp["attn_feat"]["w_qkv"], lp["attn_feat"]["w_out"], key_mask=token_valid
    )
    state = _item_sublayer(state, lp, single_eval_pos=single_eval_pos, cfg=cfg)
    return fused_mlp_ln(state, lp["mlp"]["w1"], lp["mlp"]["w2"])


def encoder_layer(
    state: torch.Tensor,
    lp: dict,
    *,
    single_eval_pos: int,
    cfg: ModelConfig,
    token_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample-major PerFeatureEncoderLayer (reference `layer.py:272-457`) on
    state ``(b, s, t, e)``: post-norm [feature-attn, item-attn, MLP], each with
    residual. Feature attention is plain: with ``cfg.fused_ops`` this layer runs
    only for more tokens than K1 takes, where the JAX package's feature
    attention is plain XLA too (`multimodalpfn_tpu/models/transformer.py:210-238`);
    ``token_valid`` ``(b, t)`` masks each member's keys there. Item attention
    follows ``cfg.use_flash`` (`_item_sublayer`) and the MLP runs K3 under
    ``cfg.fused_ops``, as in the JAX package."""
    cd = DTYPES[cfg.compute_dtype]
    state = state.to(cd)
    km = None if token_valid is None else token_valid[:, None, None, None, :]  # (b, s, h, q, k)
    h = self_attention(state, lp["attn_feat"]["w_qkv"], lp["attn_feat"]["w_out"], compute_dtype=cd,
                       key_mask=km)
    state = residual_ln(state, h)
    state = _item_sublayer(
        state.transpose(1, 2), lp, single_eval_pos=single_eval_pos, cfg=cfg
    ).transpose(1, 2)
    if cfg.fused_ops:
        return fused_mlp_ln(state.contiguous(), lp["mlp"]["w1"], lp["mlp"]["w2"])
    h = _mlp(state, lp["mlp"]["w1"], lp["mlp"]["w2"], cd)
    return residual_ln(state, h)


def _group_features(x: torch.Tensor, fpg: int) -> torch.Tensor:
    """Pad F to a multiple of features_per_group and group
    (reference `transformer.py:626-657`). (b, s, F) -> (b, s, f, n)."""
    b, s, F_ = x.shape
    pad = (-F_) % fpg
    if pad:
        x = torch.cat([x, torch.zeros((b, s, pad), dtype=x.dtype, device=x.device)], dim=-1)
    return x.reshape(b, s, (F_ + pad) // fpg, fpg)


def positional_embedding(
    params: dict, cfg: ModelConfig, n_tokens: int, feat_pos_noise: torch.Tensor | None, device
) -> torch.Tensor:
    """The "subspace" feature positional embedding (`transformer.py:925-933`):
    ``(1, 1, t_x, e)`` from the shared draw, or ``(b, 1, t_x, e)`` from
    per-member tables ``feat_pos_noise`` ``(b, t_x, k)``."""
    w, b = params["feat_pos_emb"]["w"], params["feat_pos_emb"]["b"]
    if feat_pos_noise is None:
        noise = get_subspace_noise(cfg.model_seed, n_tokens, cfg.emsize // 4, device=device)
        return (noise @ w + b)[None, None]
    if feat_pos_noise.shape[-2] != n_tokens:
        raise ValueError(f"feat_pos_noise has {feat_pos_noise.shape[-2]} tokens, expected {n_tokens}")
    return (feat_pos_noise.to(device=device, dtype=w.dtype) @ w + b)[:, None]


def member_token_valid(tab_valid: torch.Tensor, t: int) -> torch.Tensor:
    """The ``(b, t)`` key mask of cross-width batching: ``[tab_valid | image
    tokens | target]``, image and target tokens always valid (JAX package
    `models/transformer.py:430-443`), on ``tab_valid``'s device."""
    tab_valid = torch.as_tensor(tab_valid, dtype=torch.bool)
    b, f_tab = tab_valid.shape
    if not 0 < f_tab < t:
        raise ValueError(f"tab_valid covers {f_tab} tokens of {t}")
    rest = torch.ones((b, t - f_tab), dtype=torch.bool, device=tab_valid.device)
    return torch.cat([tab_valid, rest], dim=1)


@torch.no_grad()
def forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor | None,
    y_train: torch.Tensor,
    image: torch.Tensor | None = None,
    *,
    single_eval_pos: int,
    tab_valid: torch.Tensor | None = None,
    feat_pos_noise: torch.Tensor | None = None,
    mgm_active: int | None = None,
    return_embeddings: bool = False,
) -> torch.Tensor | dict[str, torch.Tensor]:
    """Inference forward (`_forward_impl` without autograd)."""
    return _forward_impl(
        params, cfg, x, y_train, image, single_eval_pos=single_eval_pos,
        tab_valid=tab_valid, feat_pos_noise=feat_pos_noise, mgm_active=mgm_active,
        return_embeddings=return_embeddings,
    )


def forward_train_test(
    params: dict,
    cfg: ModelConfig,
    train_x: torch.Tensor | None,
    train_y: torch.Tensor,
    test_x: torch.Tensor | None,
    train_image: torch.Tensor | None = None,
    test_image: torch.Tensor | None = None,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    feat_pos_noise: torch.Tensor | None = None,
    mgm_active: int | None = None,
) -> torch.Tensor:
    """The fine-tuning calling convention (reference `transformer.py:518-530`,
    the JAX package's `forward_train_test`): train and test rows are
    concatenated and ``single_eval_pos`` is the train row count. Runs with
    autograd as the caller has it enabled; ``train`` with a ``generator``
    turns the mixers' dropout on."""
    x = None if train_x is None else torch.cat([train_x, test_x], dim=1)
    image = None
    if train_image is not None and test_image is not None:
        image = torch.cat([train_image, test_image], dim=1)
    return _forward_impl(
        params, cfg, x, train_y, image, single_eval_pos=train_y.shape[1],
        feat_pos_noise=feat_pos_noise, train=train, generator=generator, mgm_active=mgm_active,
    )


def _forward_impl(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor | None,
    y_train: torch.Tensor,
    image: torch.Tensor | None = None,
    *,
    single_eval_pos: int,
    tab_valid: torch.Tensor | None = None,
    feat_pos_noise: torch.Tensor | None = None,
    train: bool = False,
    generator: torch.Generator | None = None,
    mgm_active: int | None = None,
    return_embeddings: bool = False,
) -> torch.Tensor | dict[str, torch.Tensor]:
    """The forward.

    Args:
      x: tabular features ``(b, S, F)`` float32 (NaN/inf allowed), or None for
        image-only mode (reference `transformer.py:765-766`).
      y_train: train targets ``(b, sep)``.
      image: frozen-encoder embeddings ``(b, S, N_img, in_dim)`` or ``(1, ...)``
        shared by all members, or None.
      single_eval_pos: the train/test split position ``sep``.
      tab_valid: ``(b, f_tab)`` bool, cross-width batching: which tabular
        feature-group tokens of each member are real (members zero-padded to
        a shared width mask the rest out of feature attention as keys; image
        and target tokens stay valid). May lie on the CPU, where K6a checks
        it without a host sync.
      feat_pos_noise: ``(b, t_x, emsize // 4)`` per-member subspace-noise
        tables (each member's own draws at the padded layout's slots), or
        None for the shared draw.
      mgm_active: the true head (expert) count of a padded mixer; its
        inactive heads are masked exactly, so the result is the unpadded
        mixer's (the JAX package's `_forward_impl:383-429`).
      train, generator: mixer dropout (training only).
      return_embeddings: also return the target-token embeddings of the
        train and test rows after the last layer (JAX package
        `models/transformer.py:489-496`).

    Returns logits ``(b, S - sep, n_out)`` in float32; with
    ``return_embeddings``, ``{"standard": logits, "train_embeddings": (b, sep,
    e), "test_embeddings": (b, S - sep, e)}``, the embeddings in float32.
    """
    sep = single_eval_pos
    b = y_train.shape[0]
    S = x.shape[1] if x is not None else image.shape[1]
    device = y_train.device

    # target tokens: pad the test region with NaN, then encode (transformer.py:682-724)
    y_full = torch.cat(
        [
            y_train.float(),
            torch.full((b, S - sep), float("nan"), dtype=torch.float32, device=device),
        ],
        dim=1,
    )
    embedded_y = encode_y(params["y_encoder"], cfg, y_full, sep)  # (b, S, e)

    embedded_x = None
    if x is not None:
        xg = _group_features(x.float(), cfg.features_per_group)
        embedded_x = encode_x(params["encoder"], cfg, xg, sep)  # (b, S, f, e)

    # multimodal mixer tokens appended on the feature axis (transformer.py:755-768)
    n_img_tokens, active_img = 0, None
    if image is not None:
        tokens = apply_mixer(params["mixer"], cfg.mixer, image.float(), train=train,
                             generator=generator, mgm_active=mgm_active)
        n_img_tokens = tokens.shape[-2]
        # MGM+CAP emits cap_heads tokens whatever the padding: no mask there
        if mgm_active is not None and cfg.mixer.mixer_type == "MGM":
            active_img = int(mgm_active) * image.shape[-2]
        elif mgm_active is not None and cfg.mixer.mixer_type == "MoE":
            active_img = int(mgm_active)  # one token per expert
        if tokens.shape[0] == 1 and b > 1:
            # members share the image: the mixer runs once and its tokens broadcast
            tokens = tokens.expand(b, *tokens.shape[1:])
        embedded_x = tokens if embedded_x is None else torch.cat([embedded_x, tokens], dim=-2)

    # feature positional embedding ("subspace", transformer.py:925-933)
    if cfg.feature_positional_embedding == "subspace":
        embedded_x = embedded_x + positional_embedding(
            params, cfg, embedded_x.shape[-2], feat_pos_noise, device
        )

    cd = DTYPES[cfg.compute_dtype]
    state = torch.cat([embedded_x, embedded_y[:, :, None, :]], dim=2).to(cd)
    token_valid = None
    if active_img is not None:
        # tabular tokens, the active prefix of the image tokens and the target
        # token are valid keys
        t = state.shape[2]
        f_tab = t - n_img_tokens - 1
        idx = torch.arange(t, device=device)
        token_valid = ((idx < f_tab) | (idx - f_tab < active_img) | (idx == t - 1))[None]
    if tab_valid is not None:
        if active_img is not None:
            raise ValueError("tab_valid and mgm_active are exclusive")
        token_valid = member_token_valid(tab_valid, state.shape[2])

    # item-major layout whenever the kernel path applies: one transpose before
    # the stack, none per layer; a padded mixer's mask keeps the sample-major
    # layer (plain masked feature attention, as the JAX package's traced mask)
    item_major = cfg.fused_ops and active_img is None and state.shape[2] <= MAX_FUSED_ATTN_TOKENS
    if item_major:
        state = state.transpose(1, 2).contiguous()  # (b, t, s, e)
        layer_fn = encoder_layer_im
    else:
        layer_fn = encoder_layer
    for l in range(cfg.nlayers):
        state = layer_fn(
            state, _layer(params, l), single_eval_pos=sep, cfg=cfg, token_valid=token_valid
        )

    # decode the target tokens of the test rows (transformer.py:849-864)
    test_targets = (state[:, -1, sep:] if item_major else state[:, sep:, -1]).float()
    dec = params["decoder"]
    hidden = F.gelu(test_targets @ dec["w1"] + dec["b1"], approximate="none")
    logits = hidden @ dec["w2"] + dec["b2"]
    if return_embeddings:
        train_targets = state[:, -1, :sep] if item_major else state[:, :sep, -1]
        return {"standard": logits, "train_embeddings": train_targets.float(),
                "test_embeddings": test_targets}
    return logits
