"""Fused row-local encoder sublayers: K1 and K5 (feature attention + residual
+ LN, item-major and sample-major), their key-masked forms K6a and K6b (for
members of different widths padded into one group), and K3 (MLP + residual +
LN), with the backward kernels K7 (of K1), K7s (of K5) and K8 (of K3). The
counterpart of the JAX package's `multimodalpfn_tpu/ops/pallas_fused.py`.

Each sublayer has a plain PyTorch version (``*_plain``) and a wrapper. The
wrapper runs the plain version for a tensor on the CPU; for a CUDA tensor it
launches the hand-written kernel (`csrc/feat_attn.cu`, `csrc/mlp_ln.cu`,
`csrc/feat_attn_bwd.cu`, `csrc/mlp_ln_bwd.cu`) or raises. The plain versions
round to the compute dtype at the points where the Pallas kernels do
(projections, scaled q, softmax weights, head outputs, the MLP hidden; in the
backwards the LN cotangent, the gelu-scaled hidden cotangent and the
attention's dq, dk, dv and ds) and keep every sum in float32, so in float32
they are the same function as the kernels and in bfloat16 they differ only by
summation order.

K1, K5 and K3 are differentiable like the JAX package's custom VJPs: under
autograd, `fused_feature_attention_ln_im`, `fused_feature_attention_ln`
(without a mask) and `fused_mlp_ln` save only x and the weights, and their
backward recomputes the rest (K7, K7s, K8). K5 with ``token_valid_count``, K6a
and K6b have no VJP in the JAX package either (`pallas_fused.py:1181-1187`,
`:1203-1212`): they serve inference only, and on the card they raise under
autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.ops import kernels

LN_EPS = 1e-5

# Feature tokens K1 and K5 take: their float32 softmax gives each lane of a
# warp two keys, and at 64 tokens (e = h·d = 192) their shared-memory tiles
# take 140 KB of the 227 KB a block may use. The Pallas kernels stop at 48
# (`multimodalpfn_tpu/ops/pallas_fused.py:42`), a bound from the TPU's VMEM.
# With more tokens the forward runs the sample-major layer and the KV-cache
# path its feature attention plain, in both packages.
MAX_FUSED_ATTN_TOKENS = 64


def ln_rows(u32: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis, float32 in and out
    (reference `layer.py:236-246`)."""
    mean = u32.mean(dim=-1, keepdim=True)
    var = ((u32 - mean) ** 2).mean(dim=-1, keepdim=True)
    return (u32 - mean) * torch.rsqrt(var + eps)


def ln_rows_bwd(u32: torch.Tensor, g32: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Cotangent of `ln_rows` at its input ``u32`` given the output cotangent
    ``g32``, float32 (`pallas_fused.py:_ln_rows_bwd`)."""
    mean = u32.mean(dim=-1, keepdim=True)
    c = u32 - mean
    r = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    n = c * r
    return r * (g32 - g32.mean(dim=-1, keepdim=True) - n * (g32 * n).mean(dim=-1, keepdim=True))


def rounder(cd: torch.dtype):
    if cd == torch.float32:
        return lambda t: t
    return lambda t: t.to(cd).float()


def softmax_pv(s: torch.Tensor, v: torch.Tensor, rnd) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax-weighted values with the attention kernels' rounding (K2a, K4):
    the unnormalized weights are rounded by ``rnd`` before the product, the sum
    is float32, and lse = max + log(sum). s and v float32."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (rnd(p) @ v) / l, (m + torch.log(l)).squeeze(-1)


def _attn_operands(kernel: str, x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                   t: int, token_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's and K5's checks and weights: W_qkv^T ``(e, 3·h·d)`` and W_out
    ``(h·d, e)`` in x's dtype."""
    e = x.shape[-1]
    _, h, d, _ = w_qkv.shape
    kernels.require_shape(kernel, "w_qkv", w_qkv, (3, h, d, e))
    kernels.require_shape(kernel, "w_out", w_out, (h, d, e))
    if t > MAX_FUSED_ATTN_TOKENS or not 1 <= token_valid <= t or e % 4 or d % 2 or (h * d) % 4:
        raise ValueError(
            f"{kernel}: unsupported shape t={t}, token_valid={token_valid}, e={e}, h={h}, d={d}"
        )
    wqkv_t = kernels.aligned(w_qkv.reshape(3 * h * d, e).t().to(x.dtype).contiguous())
    wout = kernels.aligned(w_out.reshape(h * d, e).to(x.dtype).contiguous())
    return wqkv_t, wout


def _key_mask_words(
    kernel: str, key_mask: torch.Tensor, lead: tuple[int, ...], t: int
) -> tuple[torch.Tensor, int]:
    """K6a's and K6b's mask operand, on the mask's device: one 64-bit word
    per member, bit j set when token j is a key, and the number of consecutive
    rows that share a word. ``key_mask`` is a bool mask broadcastable to
    ``(*lead, t)``; its trailing broadcast axes become the rows a word serves.
    Every row must keep its last (target) token as a key. A mask on the CPU is
    checked there; a mask on the card is checked with one host sync."""
    m = key_mask.to(torch.bool)
    if m.dim() < 1 or m.shape[-1] != t or m.dim() - 1 > len(lead):
        raise ValueError(f"{kernel}: key_mask of shape {tuple(m.shape)} for rows {lead} of {t} tokens")
    mlead = (1,) * (len(lead) - m.dim() + 1) + tuple(m.shape[:-1])
    k = len(mlead)
    while k and mlead[k - 1] == 1:
        k -= 1
    if any(a not in (1, n) for a, n in zip(mlead[:k], lead)):
        raise ValueError(f"{kernel}: key_mask of shape {tuple(m.shape)} for rows {lead} of {t} tokens")
    m = m.reshape(*mlead, t).expand(*lead[:k], *mlead[k:], t).reshape(-1, t)
    if not bool(m[:, -1].all()):
        raise ValueError(f"{kernel}: key_mask leaves out the target token (the last) of a row")
    words = (m.long() << torch.arange(t, device=m.device)).sum(-1)
    return words, math.prod(lead[k:])


def _words_to(words: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The mask words on the kernel's device; from the CPU without blocking."""
    if words.device.type == "cpu":
        words = words.pin_memory().to(device, non_blocking=True)
    return kernels.aligned(words.to(device).contiguous())


# ---------------------------------------------------------------------------
# K5 / K1: feature attention + residual + LN, sample-major (..., t, e) and
# item-major (b, t, s, e); K6b / K6a: the same with a per-member key mask
# ---------------------------------------------------------------------------


def feature_attention_ln_plain(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    token_valid_count: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``LN(x + W_out·attn(x))`` over the t tokens of every row of x
    ``(..., t, e)``; w_qkv ``(3, h, d, e)``, w_out ``(h, d, e)``. Keys at or
    past ``token_valid_count`` (None: t) get no weight; so do the keys that
    ``key_mask``, a bool mask broadcastable to ``(..., t)``, leaves out (their
    logits are -inf). Returns x's shape and dtype."""
    if token_valid_count is not None and key_mask is not None:
        raise ValueError("token_valid_count and key_mask are exclusive")
    cd = x.dtype
    rnd = rounder(cd)
    _, h, d, e = w_qkv.shape
    t = x.shape[-2]
    xs = x.float()
    w = w_qkv.to(cd).float()
    q = rnd(torch.einsum("...te,hde->...htd", xs, w[0]))
    q = rnd(q * (1.0 / math.sqrt(d)))
    k = rnd(torch.einsum("...te,hde->...htd", xs, w[1]))
    v = rnd(torch.einsum("...te,hde->...htd", xs, w[2]))
    s = q @ k.transpose(-1, -2)  # (..., h, t, t)
    if token_valid_count is not None:
        if not 1 <= token_valid_count <= t:
            raise ValueError(f"token_valid_count={token_valid_count} outside [1, {t}]")
        s = s.masked_fill(torch.arange(t, device=x.device) >= token_valid_count, float("-inf"))
    if key_mask is not None:
        keys = key_mask.to(device=x.device, dtype=torch.bool)[..., None, None, :]
        s = s.masked_fill(~keys, float("-inf"))
    p = rnd(torch.softmax(s, dim=-1))
    o = rnd(p @ v)  # (..., h, t, d)
    o_all = o.transpose(-3, -2).reshape(*xs.shape[:-1], h * d)
    acc = o_all @ w_out.reshape(h * d, e).to(cd).float()
    return ln_rows(xs + acc).to(cd)


def fused_feature_attention_ln(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    token_valid_count: int | None = None,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """K5, and with ``key_mask`` (bool, broadcastable to ``(..., t)``; every
    row's last token a key) K6b. K5 replaces
    `multimodalpfn_tpu/ops/pallas_fused.py:_feat_attn_kernel`, K6b
    `_feat_attn_kernel_masked` (both called through `_attn_fwd_call`); kernel
    in `csrc/feat_attn.cu`, K1's body with contiguous tokens and rows
    flattened over x's leading axes. Without a mask (no ``token_valid_count``,
    no ``key_mask``) it is differentiable, with K7s as its backward
    (`_FeatAttnLn`)."""
    if token_valid_count is None and key_mask is None and kernels.needs_grad(x, w_qkv, w_out):
        return _FeatAttnLn.apply(x, w_qkv, w_out)
    if x.device.type == "cpu":
        return feature_attention_ln_plain(x, w_qkv, w_out, token_valid_count, key_mask)
    if token_valid_count is not None and key_mask is not None:
        raise ValueError("token_valid_count and key_mask are exclusive")
    kid = "K5" if key_mask is None else "K6b"
    kernels.forbid_autograd(kid, x, w_qkv, w_out)
    t, e = x.shape[-2:]
    _, h, d, _ = w_qkv.shape
    tv = t if token_valid_count is None else token_valid_count
    wqkv_t, wout = _attn_operands(kid, x, w_qkv, w_out, t, tv)
    if key_mask is not None:
        words, rows_per_member = _key_mask_words(kid, key_mask, tuple(x.shape[:-2]), t)
    x2 = kernels.aligned(x.reshape(-1, t, e).contiguous())
    if x2.shape[0] >= 2**31:
        raise ValueError(f"{kid}: {x2.shape[0]} rows exceed the kernel's grid")
    kernels.require_cuda(kid, x2, wqkv_t, wout)
    out = torch.empty_like(x2)
    lib = kernels.library()
    if key_mask is None:
        rc = lib.mmpfn_feat_attn_ln(
            x2.data_ptr(), wqkv_t.data_ptr(), wout.data_ptr(), out.data_ptr(),
            x2.shape[0], t, e, h, d, tv, *kernels.launch_args(x2, kid),
        )
    else:
        words = _words_to(words, x2.device)
        rc = lib.mmpfn_feat_attn_ln_masked(
            x2.data_ptr(), wqkv_t.data_ptr(), wout.data_ptr(), out.data_ptr(), words.data_ptr(),
            x2.shape[0], t, e, h, d, rows_per_member, *kernels.launch_args(x2, kid),
        )
    kernels.check(rc, kid)
    kernels.LAUNCHES[kid] += 1
    return out.reshape(x.shape)


def feature_attention_ln_im_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, key_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """`feature_attention_ln_plain` over the t tokens of every (member,
    sample) row of an item-major x ``(b, t, s, e)``; ``key_mask``, bool
    broadcastable to ``(b, t)``, masks each member's keys."""
    if key_mask is not None and key_mask.dim() == 2:
        key_mask = key_mask[:, None, :]  # (b, 1, t) against the rows (b, s)
    out = feature_attention_ln_plain(x.transpose(1, 2), w_qkv, w_out, key_mask=key_mask)
    return out.transpose(1, 2).contiguous()


def fused_feature_attention_ln_im(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, key_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """K1, and with ``key_mask`` (bool, broadcastable to ``(b, t)``; every
    member's last token a key) K6a. K1 replaces
    `multimodalpfn_tpu/ops/pallas_fused.py:_feat_attn_kernel_im`, K6a
    `_feat_attn_kernel_im_masked` (both called through `_attn_fwd_call_im`);
    kernel in `csrc/feat_attn.cu`. Without a mask it is differentiable, with
    K7 as its backward (`_FeatAttnLnIm`)."""
    if key_mask is None and kernels.needs_grad(x, w_qkv, w_out):
        return _FeatAttnLnIm.apply(x, w_qkv, w_out)
    if x.device.type == "cpu":
        return feature_attention_ln_im_plain(x, w_qkv, w_out, key_mask)
    kid = "K1" if key_mask is None else "K6a"
    kernels.forbid_autograd(kid, x, w_qkv, w_out)
    b, t, s, e = x.shape
    _, h, d, _ = w_qkv.shape
    wqkv_t, wout = _attn_operands(kid, x, w_qkv, w_out, t, t)
    if key_mask is not None:  # a word per member
        words, _ = _key_mask_words(kid, key_mask.expand(b, t), (b,), t)
    x = kernels.aligned(x)
    kernels.require_cuda(kid, x, wqkv_t, wout)
    out = torch.empty_like(x)
    lib = kernels.library()
    if key_mask is None:
        rc = lib.mmpfn_feat_attn_ln_im(
            x.data_ptr(), wqkv_t.data_ptr(), wout.data_ptr(), out.data_ptr(),
            b, t, s, e, h, d, *kernels.launch_args(x, kid),
        )
    else:
        words = _words_to(words, x.device)
        rc = lib.mmpfn_feat_attn_ln_im_masked(
            x.data_ptr(), wqkv_t.data_ptr(), wout.data_ptr(), out.data_ptr(), words.data_ptr(),
            b, t, s, e, h, d, *kernels.launch_args(x, kid),
        )
    kernels.check(rc, kid)
    kernels.LAUNCHES[kid] += 1
    return out


# ---------------------------------------------------------------------------
# K3: MLP + residual + LN, rows independent
# ---------------------------------------------------------------------------


def mlp_ln_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``LN(x + gelu(x·W1)·W2)`` over the last axis (exact-erf gelu); w1
    ``(e, nhid)``, w2 ``(nhid, e)``."""
    cd = x.dtype
    x32 = x.float()
    hid = rounder(cd)(F.gelu(x32 @ w1.to(cd).float(), approximate="none"))
    return ln_rows(x32 + hid @ w2.to(cd).float()).to(cd)


def fused_mlp_ln(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K3. Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_mlp_kernel_g`
    (called through `_mlp_fwd_call`); kernel in `csrc/mlp_ln.cu`.
    Differentiable, with K8 as its backward (`_MlpLn`)."""
    if kernels.needs_grad(x, w1, w2):
        return _MlpLn.apply(x, w1, w2)
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, w2)
    e = x.shape[-1]
    nhid = w1.shape[1]
    kernels.require_shape("K3", "w1", w1, (e, nhid))
    kernels.require_shape("K3", "w2", w2, (nhid, e))
    if e > 256 or e % 2 or nhid % 4:
        raise ValueError(f"K3: unsupported widths e={e}, nhid={nhid}")
    w1c = kernels.aligned(w1.to(x.dtype).contiguous())
    w2c = kernels.aligned(w2.to(x.dtype).contiguous())
    x = kernels.aligned(x)
    kernels.require_cuda("K3", x, w1c, w2c)
    out = torch.empty_like(x)
    rc = kernels.library().mmpfn_mlp_ln(
        x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), out.data_ptr(),
        x.numel() // e, e, nhid, *kernels.launch_args(x, "K3"),
    )
    kernels.check(rc, "K3")
    kernels.LAUNCHES["K3"] += 1
    return out



# ---------------------------------------------------------------------------
# K7 / K7s: backward of K1 / K5 (feature attention + residual + LN,
# item-major and sample-major)
# ---------------------------------------------------------------------------


def feature_attention_ln_bwd_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of `feature_attention_ln_plain` (no key mask) at x
    ``(..., t, e)`` given the output cotangent g: dx in x's dtype, dw_qkv
    ``(3, h, d, e)`` and dw_out ``(h, d, e)`` in float32. Recomputes the
    forward from x (`pallas_fused.py:_feat_attn_bwd_core`)."""
    cd = x.dtype
    rnd = rounder(cd)
    _, h, d, e = w_qkv.shape
    hd = h * d
    scale = 1.0 / math.sqrt(d)
    xs, g32 = x.float(), g.float()
    w = w_qkv.to(cd).float()
    wo = w_out.reshape(hd, e).to(cd).float()
    q = rnd(rnd(torch.einsum("...te,hde->...htd", xs, w[0])) * scale)
    k = rnd(torch.einsum("...te,hde->...htd", xs, w[1]))
    v = rnd(torch.einsum("...te,hde->...htd", xs, w[2]))
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # (..., h, t, t) float32
    pc = rnd(p)
    o = rnd(pc @ v)

    def heads_last(a):  # (..., h, t, d) -> (..., t, h·d)
        return a.transpose(-3, -2).reshape(*xs.shape[:-1], hd)

    o_all = heads_last(o)
    du = ln_rows_bwd(xs + o_all @ wo, g32)
    du_c = rnd(du)
    do = rnd(du_c @ wo.T).reshape(*xs.shape[:-1], h, d).transpose(-3, -2)  # (..., h, t, d)
    dp = do @ v.transpose(-1, -2)
    ds = rnd(p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
    dq = rnd((ds @ k) * scale)
    dk = rnd(ds.transpose(-1, -2) @ q)
    dv = rnd(pc.transpose(-1, -2) @ do)
    dqkv = torch.cat([heads_last(dq), heads_last(dk), heads_last(dv)], dim=-1)  # (..., t, 3·h·d)
    dx = du + dqkv @ w.reshape(3 * hd, e)
    dwqkv = dqkv.reshape(-1, 3 * hd).T @ xs.reshape(-1, e)
    dwout = o_all.reshape(-1, hd).T @ du_c.reshape(-1, e)
    return dx.to(cd), dwqkv.reshape(3, h, d, e), dwout.reshape(h, d, e)


def feature_attention_ln_im_bwd_plain(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`feature_attention_ln_bwd_plain` for item-major x and g ``(b, t, s, e)``."""
    dx, dwqkv, dwout = feature_attention_ln_bwd_plain(
        x.transpose(1, 2), w_qkv, w_out, g.transpose(1, 2)
    )
    return dx.transpose(1, 2).contiguous(), dwqkv, dwout


def _attn_bwd_buffers(x, rows: int, hd: int) -> tuple[torch.Tensor, ...]:
    """The outputs and scratch of K7's and K7s' C entries over ``rows``
    tokens of x, in the entries' order: qkv, o, u, du, du_c, do, dqkv, dx,
    dW_qkv, dW_out (float32) and the weight gradients' slabs."""
    e, cd, dev = x.shape[-1], x.dtype, x.device

    def ws(n, dtype):
        return torch.empty((rows, n), dtype=dtype, device=dev)

    return (
        ws(3 * hd, cd), ws(hd, cd), ws(e, torch.float32), ws(e, torch.float32), ws(e, cd),
        ws(hd, cd), ws(3 * hd, cd), torch.empty_like(x),
        torch.empty((3 * hd, e), dtype=torch.float32, device=dev),
        torch.empty((hd, e), dtype=torch.float32, device=dev),
        kernels.wgrad_workspace(rows, 3 * hd, e, dev),
    )


def _attn_bwd_operands(kid: str, x, w_qkv, w_out, g, t: int, rows: int):
    """K7's and K7s' checks and operands, in their C entries' order: x,
    W_qkv ``(3·h·d, e)`` and W_out ``(h·d, e)`` in x's dtype, g; ``rows``
    (K7: the (member, sample) rows; K7s: the tokens, which it indexes in 32
    bits) below 2**31."""
    e = x.shape[-1]
    _, h, d, _ = w_qkv.shape
    hd = h * d
    kernels.require_shape(kid, "w_qkv", w_qkv, (3, h, d, e))
    kernels.require_shape(kid, "w_out", w_out, (h, d, e))
    kernels.require_shape(kid, "g", g, tuple(x.shape))
    if t > MAX_FUSED_ATTN_TOKENS or d not in (8, 16, 32, 64) or rows > 2**31 - 1:
        raise ValueError(f"{kid}: unsupported shape t={t}, d={d}, rows={rows}")
    cd = x.dtype
    wqkv = kernels.aligned(w_qkv.reshape(3 * hd, e).to(cd).contiguous())
    wout = kernels.aligned(w_out.reshape(hd, e).to(cd).contiguous())
    x = kernels.aligned(x.contiguous())
    g = kernels.aligned(g.to(cd).contiguous())
    kernels.require_cuda(kid, x, g, wqkv, wout)
    return x, wqkv, wout, g


def feature_attention_ln_bwd(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7s (sample-major). Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_attn_bwd_kernel`
    (called through `_attn_bwd_call`); kernel in `csrc/feat_attn_bwd.cu`, K7's
    launches with contiguous tokens and rows flattened over x's leading axes.
    Results as `feature_attention_ln_bwd_plain`."""
    if x.device.type == "cpu":
        return feature_attention_ln_bwd_plain(x, w_qkv, w_out, g)
    t, e = x.shape[-2:]
    _, h, d, _ = w_qkv.shape
    rows = x.numel() // (t * e)
    operands = _attn_bwd_operands("K7s", x, w_qkv, w_out, g, t, rows * t)
    bufs = _attn_bwd_buffers(operands[0], rows * t, h * d)
    rc = kernels.library().mmpfn_feat_attn_bwd(
        *(a.data_ptr() for a in operands + bufs),
        rows, t, e, h, d, kernels.WGRAD_ROWS, *kernels.launch_args(operands[0], "K7s"),
    )
    kernels.check(rc, "K7s")
    kernels.LAUNCHES["K7s"] += 1
    dx, dwqkv, dwout = bufs[7:10]
    return dx.reshape(x.shape), dwqkv.reshape(3, h, d, e), dwout.reshape(h, d, e)


class _FeatAttnLn(torch.autograd.Function):
    """K5 forward, K7s backward; saves x and the weights only (the JAX
    package's `_fused_attn_ln_vjp`). Weight cotangents come back in the
    weights' dtype."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out):
        ctx.save_for_backward(x, w_qkv, w_out)
        return fused_feature_attention_ln(x, w_qkv, w_out)

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, w_out = ctx.saved_tensors
        dx, dwqkv, dwout = feature_attention_ln_bwd(x, w_qkv, w_out, g.to(x.dtype))
        return dx, dwqkv.to(w_qkv.dtype), dwout.to(w_out.dtype)


def feature_attention_ln_im_bwd(
    x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 (item-major). Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_attn_bwd_kernel_im`
    (called through `_attn_bwd_call_im`); kernel in `csrc/feat_attn_bwd.cu`.
    Results as `feature_attention_ln_im_bwd_plain`."""
    if x.device.type == "cpu":
        return feature_attention_ln_im_bwd_plain(x, w_qkv, w_out, g)
    b, t, s, e = x.shape
    _, h, d, _ = w_qkv.shape
    operands = _attn_bwd_operands("K7", x, w_qkv, w_out, g, t, b * s)
    bufs = _attn_bwd_buffers(operands[0], b * t * s, h * d)
    rc = kernels.library().mmpfn_feat_attn_bwd_im(
        *(a.data_ptr() for a in operands + bufs),
        b, t, s, e, h, d, kernels.WGRAD_ROWS, *kernels.launch_args(operands[0], "K7"),
    )
    kernels.check(rc, "K7")
    kernels.LAUNCHES["K7"] += 1
    dx, dwqkv, dwout = bufs[7:10]
    return dx, dwqkv.reshape(3, h, d, e), dwout.reshape(h, d, e)


class _FeatAttnLnIm(torch.autograd.Function):
    """K1 forward, K7 backward; saves x and the weights only (the JAX
    package's `_fused_attn_ln_im_vjp`). Weight cotangents come back in the
    weights' dtype (float32 master weights)."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out):
        ctx.save_for_backward(x, w_qkv, w_out)
        return fused_feature_attention_ln_im(x, w_qkv, w_out)

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, w_out = ctx.saved_tensors
        dx, dwqkv, dwout = feature_attention_ln_im_bwd(x, w_qkv, w_out, g.to(x.dtype))
        return dx, dwqkv.to(w_qkv.dtype), dwout.to(w_out.dtype)


# ---------------------------------------------------------------------------
# K8: backward of K3 (MLP + residual + LN)
# ---------------------------------------------------------------------------


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d gelu(z) / dz for the exact-erf gelu: Φ(z) + z·φ(z)."""
    return 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0)))) + z * torch.exp(
        -0.5 * z * z
    ) * (1.0 / math.sqrt(2.0 * math.pi))


def mlp_ln_bwd_plain(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of `mlp_ln_plain` at x ``(..., e)`` given g: dx in x's
    dtype, dw1 ``(e, nhid)`` and dw2 ``(nhid, e)`` in float32. Recomputes
    the hidden layer (`pallas_fused.py:_mlp_bwd_kernel`)."""
    cd = x.dtype
    rnd = rounder(cd)
    e = x.shape[-1]
    x32, g32 = x.reshape(-1, e).float(), g.reshape(-1, e).float()
    w1c, w2c = w1.to(cd).float(), w2.to(cd).float()
    z = x32 @ w1c
    gz = rnd(F.gelu(z, approximate="none"))
    du = ln_rows_bwd(x32 + gz @ w2c, g32)
    du_c = rnd(du)
    dz = rnd((du_c @ w2c.T) * _gelu_grad(z))
    dx = du + dz @ w1c.T
    return dx.to(cd).reshape(x.shape), x32.T @ dz, gz.T @ du_c


def mlp_ln_bwd(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8. Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_mlp_bwd_kernel_g` /
    `_mlp_bwd_kernel` (called through `_mlp_bwd_call`); kernel in
    `csrc/mlp_ln_bwd.cu`. Results as `mlp_ln_bwd_plain`."""
    if x.device.type == "cpu":
        return mlp_ln_bwd_plain(x, w1, w2, g)
    e = x.shape[-1]
    nhid = w1.shape[1]
    kernels.require_shape("K8", "w1", w1, (e, nhid))
    kernels.require_shape("K8", "w2", w2, (nhid, e))
    kernels.require_shape("K8", "g", g, tuple(x.shape))
    cd = x.dtype
    w1c = kernels.aligned(w1.to(cd).contiguous())
    w2c = kernels.aligned(w2.to(cd).contiguous())
    x = kernels.aligned(x.contiguous())
    g = kernels.aligned(g.to(cd).contiguous())
    kernels.require_cuda("K8", x, g, w1c, w2c)
    rows, dev = x.numel() // e, x.device

    def ws(n, dtype):
        return torch.empty((rows, n), dtype=dtype, device=dev)

    gz, gzg, dz = ws(nhid, cd), ws(nhid, torch.float32), ws(nhid, cd)
    u, du, du_c = ws(e, torch.float32), ws(e, torch.float32), ws(e, cd)
    dx = torch.empty_like(x)
    dw1 = torch.empty((e, nhid), dtype=torch.float32, device=dev)
    dw2 = torch.empty((nhid, e), dtype=torch.float32, device=dev)
    work = kernels.wgrad_workspace(rows, e, nhid, dev)
    rc = kernels.library().mmpfn_mlp_ln_bwd(
        x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), g.data_ptr(), gz.data_ptr(),
        gzg.data_ptr(), u.data_ptr(), du.data_ptr(), du_c.data_ptr(), dz.data_ptr(),
        dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), work.data_ptr(),
        rows, e, nhid, kernels.WGRAD_ROWS, *kernels.launch_args(x, "K8"),
    )
    kernels.check(rc, "K8")
    kernels.LAUNCHES["K8"] += 1
    return dx, dw1, dw2


class _MlpLn(torch.autograd.Function):
    """K3 forward, K8 backward; saves x and the weights only (the JAX
    package's `_fused_mlp_ln_vjp`)."""

    @staticmethod
    def forward(ctx, x, w1, w2):
        ctx.save_for_backward(x, w1, w2)
        return fused_mlp_ln(x, w1, w2)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2 = ctx.saved_tensors
        dx, dw1, dw2 = mlp_ln_bwd(x, w1, w2, g.to(x.dtype))
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)
