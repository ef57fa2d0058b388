"""Multimodal mixers: MGM, CAP, MoE as plain tensor math.

Reference semantics: `mmpfn/models/mmpfn/model/transformer.py:33-128`, written
(as in the JAX package, `multimodalpfn_tpu/models/mixers.py`) for a leading
ensemble/member batch axis; at batch 1 they reduce to the reference numerics.

All mixers map frozen-encoder embeddings ``(b, s, N, in_dim)`` to model-width
image tokens ``(b, s, N', emsize)`` that are concatenated onto the
feature-token axis. Dropout is an identity at inference. In training
(``train=True`` with a ``generator``) it drops at the JAX package's places
(MGM after the GLU, CAP on the attention weights and after the FFN's gelu,
MoE after its gelu), with masks drawn from the explicit ``torch.Generator``:
the same rates and scaling as the JAX package, but not its masks (its
``jax.random`` bits cannot be reproduced).

A mixer zero-padded to more MGM heads or MoE experts than it has
(`models.params.pad_mixer_params`, for a sweep that shares one step stream
across grid cells) takes ``mgm_active``, its true count: the inactive heads'
tokens leave CAP's key pool, the inactive experts' gate logits become -inf,
and dropout masks are drawn over the active heads, experts and keys only, so
a padded run draws the very masks of its unpadded twin.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.models.config import MixerConfig


def _layer_norm(x, g, b, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None, dim: int = 0, active: int | None = None
) -> torch.Tensor:
    """Inverted dropout (the JAX package's `_dropout`): keep with probability
    1 - rate and scale by 1 / (1 - rate); the identity without a generator.
    With ``active``, only the first ``active`` entries along ``dim`` (the
    active heads, experts or keys of a padded mixer) draw masks; the rest pass
    unchanged."""
    if generator is None or rate == 0.0:
        return x
    if active is not None and active < x.shape[dim]:
        head, tail = x.split([active, x.shape[dim] - active], dim=dim)
        return torch.cat([_dropout(head, rate, generator), tail], dim=dim)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def mgm(params: dict, x: torch.Tensor, rate: float = 0.0, generator=None,
        active: int | None = None) -> torch.Tensor:
    """Multihead Gated MLP (`transformer.py:33-48`): per head
    LN -> Linear(in,in) -> GLU -> Dropout -> Linear(in/2, emsize); heads
    concatenate on the token axis (head-major). Heads are batched into single
    einsums. ``active``: the heads of a padded mixer that draw dropout."""
    H = params["ln_g"].shape[0]
    h = _layer_norm(x[..., None, :, :], params["ln_g"][:, None, :], params["ln_b"][:, None, :])
    # h: (b, s, H, N, in); per-head first linear
    h = torch.einsum("...hni,hio->...hno", h, params["w1"]) + params["b1"][:, None, :]
    a, g = torch.chunk(h, 2, dim=-1)
    h = _dropout(a * torch.sigmoid(g), rate, generator, -3, active)  # torch GLU(dim=-1)
    out = torch.einsum("...hni,hio->...hno", h, params["w2"]) + params["b2"][:, None, :]
    # (b, s, H, N, e) -> heads-major token concat (b, s, H*N, e)
    return out.reshape(*out.shape[:-3], H * out.shape[-2], out.shape[-1])


def orthogonality_loss(params_mgm: dict) -> torch.Tensor:
    """Pairwise Frobenius norm of the MGM heads' output projections'
    cross-products (`transformer.py:50-57`); for feature parity, unused by
    default."""
    w = params_mgm["w2"].transpose(-1, -2)  # torch layout (H, out, in)
    loss = torch.zeros((), dtype=w.dtype, device=w.device)
    for i in range(w.shape[0]):
        for j in range(i + 1, w.shape[0]):
            loss = loss + torch.linalg.norm(w[i] @ w[j].T)
    return loss


def cap(params: dict, cfg: MixerConfig, src: torch.Tensor, generator=None,
        n_valid: int | None = None) -> torch.Tensor:
    """Cross-Attention Pooler (`transformer.py:60-88`): ``cap_heads`` learned
    queries attend over the mixer tokens (torch nn.MultiheadAttention
    semantics), then out = LN(out) + FFN(out).
    src: ``(b, s, N, e)`` -> ``(b, s, cap_heads, e)``. ``n_valid``: only the
    first ``n_valid`` source tokens are keys (the active heads' tokens of a
    padded MGM); the rest get exactly no weight."""
    e = src.shape[-1]
    nh = cfg.cap_heads
    hd = e // nh
    assert nh * hd == e, "cap_heads must divide emsize"

    k_in = _layer_norm(src, params["k_norm_g"], params["k_norm_b"])
    q_in = _layer_norm(params["queries"], params["q_norm_g"], params["q_norm_b"])
    q_in = q_in @ params["q_proj_w"]  # (cap, e)

    wq, wk, wv = torch.chunk(params["in_proj_w"], 3, dim=0)  # (e, e) torch (out, in)
    bq, bk, bv = torch.chunk(params["in_proj_b"], 3, dim=0)
    q = q_in @ wq.T + bq  # (cap, e)
    k = k_in @ wk.T + bk  # (b, s, N, e)
    v = k_in @ wv.T + bv

    qh = q.reshape(*q.shape[:-1], nh, hd)  # (cap, nh, hd)
    kh = k.reshape(*k.shape[:-1], nh, hd)  # (b, s, N, nh, hd)
    vh = v.reshape(*v.shape[:-1], nh, hd)
    logits = torch.einsum("chd,bsnhd->bshcn", qh, kh) / math.sqrt(hd)
    if n_valid is not None:
        logits = logits.masked_fill(torch.arange(src.shape[-2], device=src.device) >= n_valid, float("-inf"))
    p = _dropout(torch.softmax(logits.float(), dim=-1).to(src.dtype), cfg.dropout, generator, -1, n_valid)
    o = torch.einsum("bshcn,bsnhd->bschd", p, vh)
    o = o.reshape(*o.shape[:-2], e)
    out = o @ params["out_proj_w"].T + params["out_proj_b"]  # (b, s, cap, e)

    ffn = _dropout(F.gelu(out @ params["ffn_w1"] + params["ffn_b1"], approximate="none"),
                   cfg.dropout, generator)
    ffn = ffn @ params["ffn_w2"] + params["ffn_b2"]
    return _layer_norm(out, params["out_norm_g"], params["out_norm_b"]) + ffn


def moe(params: dict, cfg: MixerConfig, image: torch.Tensor, generator=None,
        expert_active: int | None = None) -> torch.Tensor:
    """Dense top-k MoE over the first image token (`transformer.py:91-128`).
    The reference's top_k = max(mgm_heads, cap_heads) >= n_experts whenever
    cap <= mgm, i.e. the gate is then dense; both branches are reproduced.
    ``expert_active``: experts at or past this index (padded ones) get gate
    weight exactly 0 (dense gate only)."""
    x = image[..., 0, :]  # (b, s, in_dim): first token only
    n_experts = params["ln_g"].shape[0]
    gate_logits = x @ params["gate_w"] + params["gate_b"]
    if expert_active is not None:
        assert cfg.moe_top_k >= n_experts, "per-run top-k gating is not supported with padded experts"
        gate_logits = gate_logits.masked_fill(
            torch.arange(n_experts, device=x.device) >= expert_active, float("-inf"))
    gate = torch.softmax(gate_logits, dim=-1)
    if cfg.moe_top_k < n_experts:
        thresh = torch.sort(gate, dim=-1, descending=True).values[
            ..., cfg.moe_top_k - 1 : cfg.moe_top_k
        ]
        gate = gate * (gate >= thresh)
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    h = _layer_norm(x[..., None, :], params["ln_g"], params["ln_b"])  # (b, s, E, in)
    h = torch.einsum("...ei,eio->...eo", h, params["w1"]) + params["b1"]
    h = _dropout(F.gelu(h, approximate="none"), 0.1, generator, -2, expert_active)
    outs = torch.einsum("...ei,eio->...eo", h, params["w2"]) + params["b2"]
    return outs * gate[..., None]  # (b, s, E, emsize)


def apply_mixer(
    mixer_params: dict,
    cfg: MixerConfig,
    image: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    mgm_active: int | None = None,
) -> torch.Tensor:
    """Dispatch per `transformer.py:755-761`; dropout only with ``train`` and
    a ``generator``. ``mgm_active``: the true head (expert) count of a
    mixer padded by `models.params.pad_mixer_params` (the JAX package's
    `apply_mixer`, `mixers.py:177-213`); the caller masks the inactive MGM
    and MoE output tokens out of feature attention. ``cap_heads`` is never
    padded."""
    gen = generator if train else None
    if mgm_active is not None:
        mgm_active = int(mgm_active)
    if cfg.mixer_type == "MoE":
        return moe(mixer_params["moe"], cfg, image, gen, expert_active=mgm_active)
    tokens = mgm(mixer_params["mgm"], image, cfg.dropout, gen, active=mgm_active)
    if cfg.mixer_type == "MGM+CAP":
        n_valid = None if mgm_active is None else mgm_active * image.shape[-2]
        tokens = cap(mixer_params["cap"], cfg, tokens, gen, n_valid=n_valid)
    return tokens
