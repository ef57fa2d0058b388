"""The plain reference of the MMPFN forward: the TabPFN-v2 per-feature
transformer with the MGM+CAP mixer, one ensemble member at a time,
sample-major, in float32 (TF32 off), written from the published layer
equations with no kernel, cache, batching or padding.

Reference sources: too-z/MultiModalPFN `model/transformer.py` (the mixers,
the "subspace" feature embedding, the decoder), `model/layer.py` (post-norm
feature attention, item attention with the multiquery test block, MLP) and
`model/encoders.py` (the input and target encoder steps).

``precision`` selects the arithmetic of every product: "float32", or "fp8",
the control, which rounds both operands of each product to float8 e4m3 with
a per-tensor scale (the precision below the configuration's bf16). Rounding
passes gradients straight through.

Nothing here imports the program: the weights are a flat dict of tensors
named as the benchmark made them (`portbench/weights.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


class Arith:
    """The products of one forward, in the precision it was asked for."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.round = _fp8 if precision == "fp8" else (lambda t: t)

    def ein(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, self.round(a), self.round(b))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def ln(x: torch.Tensor, g=None, b=None) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return y if g is None else y * g + b


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with a mask of ``x``'s shape drawn from ``gen``."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


# --- encoders (`encoders.py`: RemoveEmpty, NanHandling, remove_outliers,
# normalize_data, VariableNumFeatures; the target's NanHandling and class
# flattening) -------------------------------------------------------------

def _nanmean(x: torch.Tensor) -> torch.Tensor:
    nan = torch.isnan(x)
    return torch.where(nan, 0.0, x).sum(0) / (~nan).sum(0).to(x.dtype).clamp(min=1.0)


def _nanstd(x: torch.Tensor) -> torch.Tensor:
    nan = torch.isnan(x)
    n = (~nan).sum(0).to(x.dtype)
    mean = torch.where(nan, 0.0, x).sum(0) / n
    ss = torch.where(nan, 0.0, (mean - x) ** 2).sum(0)
    return torch.sqrt(ss / (n - 1.0))


def _nan_handling(x: torch.Tensor, sep: int) -> tuple[torch.Tensor, torch.Tensor]:
    isnan, isinf = torch.isnan(x), torch.isinf(x)
    ind = (isnan * -2.0 + (isinf & (x > 0)) * 2.0 + (isinf & (x < 0)) * 4.0).to(x.dtype)
    tr = x[:sep]
    means = torch.where(torch.isnan(tr), 0.0, tr).sum(0) / (~torch.isnan(tr)).sum(0).to(x.dtype)
    return torch.where(isnan | isinf, means.expand_as(x), x), ind


def encode_x(w: torch.Tensor, x: torch.Tensor, sep: int, outlier_sigma: float | None,
             ar: Arith) -> torch.Tensor:
    """``x`` (S, F) float32 -> (S, F, e); one feature a token."""
    S = x.shape[0]
    varies = (x[1:] == x[:1]).sum(0) != S - 1
    x = torch.where(varies, x, 0.0)
    x, ind = _nan_handling(x, sep)
    if outlier_sigma is not None:
        data = x[:sep]
        m1, s1 = _nanmean(data), _nanstd(data)
        clean = torch.where((data > m1 + s1 * outlier_sigma) | (data < m1 - s1 * outlier_sigma),
                            float("nan"), data)
        m2, s2 = _nanmean(clean), _nanstd(clean)
        lo, hi = m2 - s2 * outlier_sigma, m2 + s2 * outlier_sigma
        x = torch.maximum(-torch.log1p(x.abs()) + lo, x)
        x = torch.minimum(torch.log1p(x.abs()) + hi, x)
    mean, std = _nanmean(x[:sep]), _nanstd(x[:sep]) + 1e-20
    if S == 1 or sep == 1:
        std = torch.ones_like(std)
    x = ((x - mean) / std).clamp(-100, 100)
    # VariableNumFeatures with one feature a group multiplies by sqrt(1 / max(used, 1)) = 1
    return ar.mm(torch.stack([x, ind], dim=-1), w)


def encode_y(w: torch.Tensor, b: torch.Tensor, y_train: torch.Tensor, n_test: int,
             classification: bool, ar: Arith) -> torch.Tensor:
    sep = y_train.shape[0]
    y = torch.cat([y_train, torch.full((n_test,), float("nan"), device=y_train.device)])
    y, ind = _nan_handling(y, sep)
    if classification:  # the count of distinct train targets below each target
        u = torch.unique(y_train)
        y = (u[None, :] < y[:, None]).sum(-1).to(y.dtype)
    return ar.mm(torch.stack([y, ind], dim=-1), w) + b


# --- mixer (`transformer.py:33-88`: MultiheadGatedMLP, CrossAttentionPooler) --

def mgm(p: dict, x: torch.Tensor, rate: float, gen, ar: Arith) -> torch.Tensor:
    """x (1, S, N, in) -> (1, S, H·N, e), heads major."""
    H = p["ln_g"].shape[0]
    h = ln(x[:, :, None], p["ln_g"][:, None, :], p["ln_b"][:, None, :])  # (1, S, H, N, in)
    h = ar.ein("bshni,hio->bshno", h, p["w1"]) + p["b1"][:, None, :]
    a, g = torch.chunk(h, 2, dim=-1)
    h = dropout(a * torch.sigmoid(g), rate, gen)
    out = ar.ein("bshni,hio->bshno", h, p["w2"]) + p["b2"][:, None, :]
    return out.reshape(*out.shape[:2], H * out.shape[3], out.shape[4])


def cap(p: dict, heads: int, rate: float, src: torch.Tensor, gen, ar: Arith) -> torch.Tensor:
    """src (1, S, N, e) -> (1, S, heads, e): learned queries attend over the
    MGM tokens (torch MultiheadAttention), then LN(out) + FFN(out)."""
    e = src.shape[-1]
    hd = e // heads
    k_in = ln(src, p["k_norm_g"], p["k_norm_b"])
    q_in = ar.mm(ln(p["queries"], p["q_norm_g"], p["q_norm_b"]), p["q_proj_w"])
    wq, wk, wv = torch.chunk(p["in_proj_w"], 3, dim=0)
    bq, bk, bv = torch.chunk(p["in_proj_b"], 3, dim=0)
    q = ar.mm(q_in, wq.T) + bq
    k = ar.mm(k_in, wk.T) + bk
    v = ar.mm(k_in, wv.T) + bv
    qh = q.reshape(q.shape[0], heads, hd)
    kh = k.reshape(*k.shape[:-1], heads, hd)
    vh = v.reshape(*v.shape[:-1], heads, hd)
    logits = ar.ein("chd,bsnhd->bshcn", qh, kh) / math.sqrt(hd)
    pr = dropout(torch.softmax(logits, dim=-1), rate, gen)
    o = ar.ein("bshcn,bsnhd->bschd", pr, vh).reshape(*src.shape[:2], q.shape[0], e)
    out = ar.mm(o, p["out_proj_w"].T) + p["out_proj_b"]
    ffn = dropout(F.gelu(ar.mm(out, p["ffn_w1"]) + p["ffn_b1"]), rate, gen)
    ffn = ar.mm(ffn, p["ffn_w2"]) + p["ffn_b2"]
    return ln(out, p["out_norm_g"], p["out_norm_b"]) + ffn


# --- the encoder layer (`layer.py`: post-norm feature attention, item
# attention, MLP) ---------------------------------------------------------------

TOKEN_BLOCK = 4  # token columns whose item-attention scores are formed at once


def _feature_attention(x, w_qkv, w_out, ar: Arith):
    """x (S, t, e): each row's tokens attend to each other."""
    d = w_qkv.shape[2]
    q, k, v = (ar.ein("sti,hdi->sthd", x, w_qkv[i]) for i in range(3))
    pr = torch.softmax(ar.ein("sqhd,skhd->shqk", q, k) / math.sqrt(d), dim=-1)
    o = ar.ein("shqk,skhd->sqhd", pr, v)
    return ar.ein("sqhd,hdo->sqo", o, w_out)


def _item_attention(x, w_qkv, w_out, sep: int, ar: Arith):
    """x (S, t, e): per token column, train rows attend to train rows with
    every head; test rows attend to train rows with KV head 0 shared by all
    query heads (the multiquery test block)."""
    d = w_qkv.shape[2]
    outs = []
    for c in range(0, x.shape[1], TOKEN_BLOCK):
        xc = x[:, c:c + TOKEN_BLOCK].transpose(0, 1)  # (tb, S, e)
        tr = xc[:, :sep]
        q = ar.ein("tsi,hdi->tshd", xc, w_qkv[0])
        k = ar.ein("tsi,hdi->tshd", tr, w_qkv[1])
        v = ar.ein("tsi,hdi->tshd", tr, w_qkv[2])
        pr = torch.softmax(ar.ein("tqhd,tkhd->thqk", q[:, :sep], k) / math.sqrt(d), dim=-1)
        o_tr = ar.ein("thqk,tkhd->tqhd", pr, v)
        pr = torch.softmax(ar.ein("tqhd,tkd->thqk", q[:, sep:], k[:, :, 0]) / math.sqrt(d), dim=-1)
        o_te = ar.ein("thqk,tkd->tqhd", pr, v[:, :, 0])
        o = torch.cat([o_tr, o_te], dim=1)
        outs.append(ar.ein("tqhd,hdo->tqo", o, w_out).transpose(0, 1))
    return torch.cat(outs, dim=1)


def encoder_layer(x, lp: dict, sep: int, ar: Arith):
    x = ln(x + _feature_attention(x, lp["attn_feat/w_qkv"], lp["attn_feat/w_out"], ar))
    x = ln(x + _item_attention(x, lp["attn_item/w_qkv"], lp["attn_item/w_out"], sep, ar))
    h = ar.mm(F.gelu(ar.mm(x, lp["mlp/w1"])), lp["mlp/w2"])
    return ln(x + h)


# --- the whole forward -------------------------------------------------------------

def subspace_noise(model_seed: int, n_tokens: int, k: int) -> torch.Tensor:
    """The "subspace" embedding's draws: ``randn(n_tokens, k)`` from a CPU
    generator seeded with the model seed (left at torch's default seed when
    the model seed is 0, as the published ``if self.seed:`` does)."""
    gen = torch.Generator(device="cpu")
    if model_seed:
        gen.manual_seed(int(model_seed))
    return torch.randn((n_tokens, k), generator=gen)


def group(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def forward(params: dict, arch: dict, x: torch.Tensor, y_train: torch.Tensor,
            image: torch.Tensor, *, outlier_sigma: float | None = None,
            precision: str = "float32", gen: torch.Generator | None = None,
            checkpoint_layers: bool = False) -> torch.Tensor:
    """One member: ``x`` (S, F) preprocessed features, the first
    ``len(y_train)`` rows the train rows; ``image`` (S, N, in) the frozen
    encoder's embeddings; returns the test rows' logits (S - sep, n_out).
    ``gen``: training, with the mixer's dropout drawn from it (MGM after the
    GLU, CAP on its attention weights and after the FFN's gelu, in that order)."""
    ar = Arith(precision)
    sep, S = y_train.shape[0], x.shape[0]
    mix = arch["mixer"]
    rate = mix["dropout"] if gen is not None else 0.0
    emb_y = encode_y(params["y_encoder/w"], params["y_encoder/b"], y_train, S - sep,
                     arch["max_num_classes"] >= 2, ar)
    emb_x = encode_x(params["encoder/w"], x, sep, outlier_sigma, ar)
    tokens = mgm(group(params, "mixer/mgm"), image[None], rate, gen, ar)
    tokens = cap(group(params, "mixer/cap"), mix["cap_heads"], rate, tokens, gen, ar)[0]
    emb_x = torch.cat([emb_x, tokens], dim=1)
    noise = subspace_noise(arch["model_seed"], emb_x.shape[1], arch["emsize"] // 4).to(x.device)
    emb_x = emb_x + ar.mm(noise, params["feat_pos_emb/w"]) + params["feat_pos_emb/b"]
    state = torch.cat([emb_x, emb_y[:, None]], dim=1)  # (S, t, e)
    layers = group(params, "layers")
    for l in range(arch["nlayers"]):
        lp = {k: v[l] for k, v in layers.items()}
        if checkpoint_layers:
            state = checkpoint(encoder_layer, state, lp, sep, ar, use_reentrant=False)
        else:
            state = encoder_layer(state, lp, sep, ar)
    hidden = F.gelu(ar.mm(state[sep:, -1], params["decoder/w1"]) + params["decoder/b1"])
    return ar.mm(hidden, params["decoder/w2"]) + params["decoder/b2"]
