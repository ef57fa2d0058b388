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


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (the JAX package's `_dropout`): keep with probability
    1 - rate and scale by 1 / (1 - rate); the identity without a generator."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def mgm(params: dict, x: torch.Tensor, rate: float = 0.0, generator=None) -> torch.Tensor:
    """Multihead Gated MLP (`transformer.py:33-48`): per head
    LN -> Linear(in,in) -> GLU -> Dropout -> Linear(in/2, emsize); heads
    concatenate on the token axis (head-major). Heads are batched into single
    einsums."""
    H = params["ln_g"].shape[0]
    h = _layer_norm(x[..., None, :, :], params["ln_g"][:, None, :], params["ln_b"][:, None, :])
    # h: (b, s, H, N, in); per-head first linear
    h = torch.einsum("...hni,hio->...hno", h, params["w1"]) + params["b1"][:, None, :]
    a, g = torch.chunk(h, 2, dim=-1)
    h = _dropout(a * torch.sigmoid(g), rate, generator)  # torch GLU(dim=-1)
    out = torch.einsum("...hni,hio->...hno", h, params["w2"]) + params["b2"][:, None, :]
    # (b, s, H, N, e) -> heads-major token concat (b, s, H*N, e)
    return out.reshape(*out.shape[:-3], H * out.shape[-2], out.shape[-1])


def cap(params: dict, cfg: MixerConfig, src: torch.Tensor, generator=None) -> torch.Tensor:
    """Cross-Attention Pooler (`transformer.py:60-88`): ``cap_heads`` learned
    queries attend over the mixer tokens (torch nn.MultiheadAttention
    semantics), then out = LN(out) + FFN(out).
    src: ``(b, s, N, e)`` -> ``(b, s, cap_heads, e)``."""
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
    p = _dropout(torch.softmax(logits.float(), dim=-1).to(src.dtype), cfg.dropout, generator)
    o = torch.einsum("bshcn,bsnhd->bschd", p, vh)
    o = o.reshape(*o.shape[:-2], e)
    out = o @ params["out_proj_w"].T + params["out_proj_b"]  # (b, s, cap, e)

    ffn = _dropout(F.gelu(out @ params["ffn_w1"] + params["ffn_b1"], approximate="none"),
                   cfg.dropout, generator)
    ffn = ffn @ params["ffn_w2"] + params["ffn_b2"]
    return _layer_norm(out, params["out_norm_g"], params["out_norm_b"]) + ffn


def moe(params: dict, cfg: MixerConfig, image: torch.Tensor, generator=None) -> torch.Tensor:
    """Dense top-k MoE over the first image token (`transformer.py:91-128`).
    The reference's top_k = max(mgm_heads, cap_heads) >= n_experts whenever
    cap <= mgm, i.e. the gate is then dense; both branches are reproduced."""
    x = image[..., 0, :]  # (b, s, in_dim): first token only
    n_experts = params["ln_g"].shape[0]
    gate = torch.softmax(x @ params["gate_w"] + params["gate_b"], dim=-1)
    if cfg.moe_top_k < n_experts:
        thresh = torch.sort(gate, dim=-1, descending=True).values[
            ..., cfg.moe_top_k - 1 : cfg.moe_top_k
        ]
        gate = gate * (gate >= thresh)
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    h = _layer_norm(x[..., None, :], params["ln_g"], params["ln_b"])  # (b, s, E, in)
    h = torch.einsum("...ei,eio->...eo", h, params["w1"]) + params["b1"]
    h = _dropout(F.gelu(h, approximate="none"), 0.1, generator)
    outs = torch.einsum("...ei,eio->...eo", h, params["w2"]) + params["b2"]
    return outs * gate[..., None]  # (b, s, E, emsize)


def apply_mixer(
    mixer_params: dict,
    cfg: MixerConfig,
    image: torch.Tensor,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Dispatch per `transformer.py:755-761`; dropout only with ``train`` and
    a ``generator``."""
    gen = generator if train else None
    if cfg.mixer_type == "MoE":
        return moe(mixer_params["moe"], cfg, image, gen)
    tokens = mgm(mixer_params["mgm"], image, cfg.dropout, gen)
    if cfg.mixer_type == "MGM+CAP":
        tokens = cap(mixer_params["cap"], cfg, tokens, gen)
    return tokens
