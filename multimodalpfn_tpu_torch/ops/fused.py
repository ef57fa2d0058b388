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

# Feature tokens K1 and K5 take: the CUDA-core body's softmax gives each lane
# of a warp two keys, and at 64 tokens (e = h·d = 192) its shared-memory
# tiles take 140 KB of the 227 KB a block may use; the wgmma body holds a
# sample's keys in one 64-bit word and a warpgroup's tile in 64 rows. The
# Pallas kernels stop at 48 (`multimodalpfn_tpu/ops/pallas_fused.py:42`), a
# bound from the TPU's VMEM.
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


def feat_attn_body(dtype: torch.dtype, e: int, h: int, d: int) -> str:
    """Which body of K1, K5, K6a and K6b (`csrc/feat_attn.cu`) runs on the
    card for operands of ``dtype`` at width ``e`` with ``h`` heads of width
    ``d``: ``"wgmma"`` (bf16, h·d = e, e = 192 with d = 32 or e = 64 with d
    = 16; Hopper's wgmma fed by TMA) or ``"cuda_cores"`` (float32, and bf16
    at other widths). Raises TypeError for another dtype and ValueError where
    no body takes the widths (e, h·d not positive multiples of 4; d not a
    positive even number)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1/K5/K6: dtype {dtype} is not supported (float32 or bfloat16)")
    if e < 4 or e % 4 or h < 1 or d < 2 or d % 2 or (h * d) % 4:
        raise ValueError(f"K1/K5/K6: unsupported widths e={e}, h={h}, d={d}")
    if dtype == torch.bfloat16 and h * d == e and (e, d) in ((192, 32), (64, 16)):
        return "wgmma"
    return "cuda_cores"


def _attn_operands(kernel: str, x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                   t: int, token_valid: int) -> tuple[str, torch.Tensor, torch.Tensor]:
    """K1's and K5's checks, body (`feat_attn_body`) and weights in x's
    dtype: for the wgmma body W_qkv with each head's q, k, v rows together
    ``(h·3·d, e)``, for the CUDA cores W_qkv^T ``(e, 3·h·d)``; W_out ``(h·d,
    e)``."""
    e = x.shape[-1]
    _, h, d, _ = w_qkv.shape
    kernels.require_shape(kernel, "w_qkv", w_qkv, (3, h, d, e))
    kernels.require_shape(kernel, "w_out", w_out, (h, d, e))
    body = feat_attn_body(x.dtype, e, h, d)
    if t > MAX_FUSED_ATTN_TOKENS or not 1 <= token_valid <= t:
        raise ValueError(
            f"{kernel}: unsupported shape t={t}, token_valid={token_valid}, e={e}, h={h}, d={d}"
        )
    if body == "wgmma":
        wqkv = w_qkv.transpose(0, 1).reshape(3 * h * d, e)
    else:
        wqkv = w_qkv.reshape(3 * h * d, e).t()
    wqkv = kernels.aligned(wqkv.to(x.dtype).contiguous())
    wout = kernels.aligned(w_out.reshape(h * d, e).to(x.dtype).contiguous())
    return body, wqkv, wout


def _launch_feat_attn(kid: str, body: str, x, wqkv, wout, words, rows_per_member: int, b: int,
                      t: int, s: int, tv: int, h: int, d: int, sample_major: bool) -> torch.Tensor:
    """Launch K1, K5, K6a or K6b on x (item-major ``(b, t, s, e)``, or
    ``sample_major`` ``(s, t, e)``) through the C entry of ``body``, and
    count it."""
    e = x.shape[-1]
    out = torch.empty_like(x)
    lib = kernels.library()
    ptrs = (x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(), out.data_ptr())
    mask = None if words is None else words.data_ptr()
    dtype, device, stream = kernels.launch_args(x, kid)
    if body == "wgmma":
        rc = lib.mmpfn_feat_attn_ln_wg(*ptrs, mask, rows_per_member, b, t, s, e, h, d, tv,
                                       int(sample_major), device, stream)
    elif sample_major and words is None:
        rc = lib.mmpfn_feat_attn_ln(*ptrs, s, t, e, h, d, tv, dtype, device, stream)
    elif sample_major:
        rc = lib.mmpfn_feat_attn_ln_masked(*ptrs, mask, s, t, e, h, d, rows_per_member, dtype,
                                           device, stream)
    elif words is None:
        rc = lib.mmpfn_feat_attn_ln_im(*ptrs, b, t, s, e, h, d, dtype, device, stream)
    else:
        rc = lib.mmpfn_feat_attn_ln_im_masked(*ptrs, mask, b, t, s, e, h, d, dtype, device, stream)
    kernels.check(rc, kid)
    kernels.LAUNCHES[kid] += 1
    kernels.BODY_LAUNCHES[f"{kid} {body}"] += 1
    return out


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
    in `csrc/feat_attn.cu`, K1's bodies (`feat_attn_body`) with contiguous
    tokens and rows flattened over x's leading axes. Without a mask (no ``token_valid_count``,
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
    body, wqkv, wout = _attn_operands(kid, x, w_qkv, w_out, t, tv)
    words, rows_per_member = None, 1
    if key_mask is not None:
        words, rows_per_member = _key_mask_words(kid, key_mask, tuple(x.shape[:-2]), t)
    x2 = kernels.aligned(x.reshape(-1, t, e).contiguous())
    if x2.shape[0] >= 2**31:
        raise ValueError(f"{kid}: {x2.shape[0]} rows exceed the kernel's grid")
    kernels.require_cuda(kid, x2, wqkv, wout)
    if words is not None:
        words = _words_to(words, x2.device)
    out = _launch_feat_attn(kid, body, x2, wqkv, wout, words, rows_per_member, 1, t, x2.shape[0],
                            tv, h, d, sample_major=True)
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
    kernel in `csrc/feat_attn.cu`, its body chosen by `feat_attn_body`.
    Without a mask it is differentiable, with
    K7 as its backward (`_FeatAttnLnIm`)."""
    if key_mask is None and kernels.needs_grad(x, w_qkv, w_out):
        return _FeatAttnLnIm.apply(x, w_qkv, w_out)
    if x.device.type == "cpu":
        return feature_attention_ln_im_plain(x, w_qkv, w_out, key_mask)
    kid = "K1" if key_mask is None else "K6a"
    kernels.forbid_autograd(kid, x, w_qkv, w_out)
    b, t, s, e = x.shape
    _, h, d, _ = w_qkv.shape
    body, wqkv, wout = _attn_operands(kid, x, w_qkv, w_out, t, t)
    words = None
    if key_mask is not None:  # a word per member
        words, _ = _key_mask_words(kid, key_mask.expand(b, t), (b,), t)
    x = kernels.aligned(x)
    kernels.require_cuda(kid, x, wqkv, wout)
    if words is not None:
        words = _words_to(words, x.device)
    return _launch_feat_attn(kid, body, x, wqkv, wout, words, 1, b, t, s, t, h, d,
                             sample_major=False)


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


def mlp_ln_body(dtype: torch.dtype, e: int, nhid: int, kid: str = "K3") -> str:
    """Which body of K3 (`csrc/mlp_ln.cu`) runs on the card for operands of
    ``dtype`` at width ``e`` and hidden width ``nhid``: ``"wgmma"`` (bf16, e
    = 64, 128, 192, nhid a multiple of 64; Hopper's wgmma fed by TMA),
    ``"mma_sync"`` (bf16, e = 32, 96, 160, nhid a multiple of 64) or
    ``"cuda_cores"`` (float32, and bf16 at other widths). Raises TypeError
    for another dtype and ValueError where no body takes the widths (e odd,
    below 2 or above 256; nhid not a positive multiple of 4), naming ``kid``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kid}: dtype {dtype} is not supported (float32 or bfloat16)")
    if e < 2 or e % 2 or e > 256 or nhid < 4 or nhid % 4:
        raise ValueError(f"{kid}: unsupported widths e={e}, nhid={nhid}")
    if dtype == torch.bfloat16 and nhid % 64 == 0:
        if e in (64, 128, 192):
            return "wgmma"
        if e in (32, 96, 160):
            return "mma_sync"
    return "cuda_cores"


def fused_mlp_ln(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K3. Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_mlp_kernel_g`
    (called through `_mlp_fwd_call`); kernel in `csrc/mlp_ln.cu`, its body
    chosen by `mlp_ln_body`. Differentiable, with K8 as its backward
    (`_MlpLn`)."""
    if kernels.needs_grad(x, w1, w2):
        return _MlpLn.apply(x, w1, w2)
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, w2)
    e = x.shape[-1]
    nhid = w1.shape[1]
    kernels.require_shape("K3", "w1", w1, (e, nhid))
    kernels.require_shape("K3", "w2", w2, (nhid, e))
    body = mlp_ln_body(x.dtype, e, nhid)
    w1c = kernels.aligned(w1.to(x.dtype).contiguous())
    w2c = kernels.aligned(w2.to(x.dtype).contiguous())
    x = kernels.aligned(x)
    kernels.require_cuda("K3", x, w1c, w2c)
    out = torch.empty_like(x)
    lib = kernels.library()
    ptrs = (x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), out.data_ptr(), x.numel() // e, e, nhid)
    dtype, device, stream = kernels.launch_args(x, "K3")
    if body == "wgmma":
        rc = lib.mmpfn_mlp_ln_wg(*ptrs, device, stream)
    elif body == "mma_sync":
        rc = lib.mmpfn_mlp_ln_mma(*ptrs, device, stream)
    else:
        rc = lib.mmpfn_mlp_ln(*ptrs, dtype, device, stream)
    kernels.check(rc, "K3")
    kernels.LAUNCHES["K3"] += 1
    kernels.BODY_LAUNCHES[f"K3 {body}"] += 1
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


def feat_attn_bwd_body(dtype: torch.dtype, d: int) -> str:
    """Which body of K7's and K7s' per-row attention (`csrc/feat_attn_bwd.cu`,
    steps 2 and 6) runs on the card for operands of ``dtype`` with heads of
    width ``d``: ``"wgmma"`` (bf16 at d = 16, 32, 64; Hopper's wgmma over
    packed 64-row tiles of whole samples, fed by TMA) or ``"cuda_cores"``
    (float32, the parity mode, and bf16 at d = 8: a warp a (row, head)).
    The products of the launch sequence are the same in both. Raises
    TypeError for another dtype and ValueError for another d."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K7/K7s: dtype {dtype} is not supported (float32 or bfloat16)")
    if d not in (8, 16, 32, 64):
        raise ValueError(f"K7/K7s: unsupported head width d={d} (8, 16, 32 or 64)")
    return "wgmma" if dtype == torch.bfloat16 and d != 8 else "cuda_cores"


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
    launches with contiguous tokens and rows flattened over x's leading axes,
    its per-row attention on the body `feat_attn_bwd_body` names.
    Results as `feature_attention_ln_bwd_plain`."""
    if x.device.type == "cpu":
        return feature_attention_ln_bwd_plain(x, w_qkv, w_out, g)
    t, e = x.shape[-2:]
    _, h, d, _ = w_qkv.shape
    rows = x.numel() // (t * e)
    operands = _attn_bwd_operands("K7s", x, w_qkv, w_out, g, t, rows * t)
    body = feat_attn_bwd_body(x.dtype, d)
    bufs = _attn_bwd_buffers(operands[0], rows * t, h * d)
    rc = kernels.library().mmpfn_feat_attn_bwd(
        *(a.data_ptr() for a in operands + bufs),
        rows, t, e, h, d, kernels.WGRAD_ROWS, int(body == "wgmma"),
        *kernels.launch_args(operands[0], "K7s"),
    )
    kernels.check(rc, "K7s")
    kernels.LAUNCHES["K7s"] += 1
    kernels.BODY_LAUNCHES[f"K7s {body}"] += 1
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
    (called through `_attn_bwd_call_im`); kernel in `csrc/feat_attn_bwd.cu`,
    its per-row attention on the body `feat_attn_bwd_body` names.
    Results as `feature_attention_ln_im_bwd_plain`."""
    if x.device.type == "cpu":
        return feature_attention_ln_im_bwd_plain(x, w_qkv, w_out, g)
    b, t, s, e = x.shape
    _, h, d, _ = w_qkv.shape
    operands = _attn_bwd_operands("K7", x, w_qkv, w_out, g, t, b * s)
    body = feat_attn_bwd_body(x.dtype, d)
    bufs = _attn_bwd_buffers(operands[0], b * t * s, h * d)
    rc = kernels.library().mmpfn_feat_attn_bwd_im(
        *(a.data_ptr() for a in operands + bufs),
        b, t, s, e, h, d, kernels.WGRAD_ROWS, int(body == "wgmma"),
        *kernels.launch_args(operands[0], "K7"),
    )
    kernels.check(rc, "K7")
    kernels.LAUNCHES["K7"] += 1
    kernels.BODY_LAUNCHES[f"K7 {body}"] += 1
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


def mlp_bwd_body(dtype: torch.dtype, e: int, nhid: int) -> str:
    """Which body of K8 (`csrc/mlp_ln_bwd.cu`) runs on the card: ``"wgmma"``
    (the row pass, `wg::mlp_ln_bwd_wg_kernel`, then the two weight
    gradients: bf16 at the widths of K3's wgmma body, e = 64, 128, 192 with
    nhid a multiple of 64) or ``"sequence"`` (float32, the parity mode, and
    bf16 at other widths: the products of `csrc/gemm_tile.cuh` with their
    epilogues and the LN backward, the intermediates in device memory).
    Raises where `mlp_ln_body` raises."""
    return "wgmma" if mlp_ln_body(dtype, e, nhid, "K8") == "wgmma" else "sequence"


def _weight_grads(e: int, nhid: int, rows: int, dev) -> tuple[torch.Tensor, ...]:
    """dW1, dW2 (float32) and the weight gradients' slabs."""
    return (
        torch.empty((e, nhid), dtype=torch.float32, device=dev),
        torch.empty((nhid, e), dtype=torch.float32, device=dev),
        kernels.wgrad_workspace(rows, e, nhid, dev),
    )


def _mlp_bwd_buffers(x, rows: int, nhid: int) -> tuple[torch.Tensor, ...]:
    """The outputs and scratch of K8's sequence (C entry `mmpfn_mlp_ln_bwd`)
    over ``rows`` rows of x, in the entry's order: gz, gzg (float32), u, du
    (float32), du_c, dz, dx, dW1, dW2 (float32) and the weight gradients'
    slabs."""
    e, cd, dev = x.shape[-1], x.dtype, x.device

    def ws(n, dtype):
        return torch.empty((rows, n), dtype=dtype, device=dev)

    return (
        ws(nhid, cd), ws(nhid, torch.float32), ws(e, torch.float32), ws(e, torch.float32),
        ws(e, cd), ws(nhid, cd), torch.empty_like(x), *_weight_grads(e, nhid, rows, dev),
    )


def _mlp_bwd_wg_buffers(x, rows: int, nhid: int) -> tuple[torch.Tensor, ...]:
    """The outputs and scratch of K8's row pass (C entry
    `mmpfn_mlp_ln_bwd_wg`) over ``rows`` rows of x, in the entry's order:
    gz, du_c, dz (x's dtype, read by the weight gradients), dx, dW1, dW2
    (float32) and the weight gradients' slabs."""
    e, cd, dev = x.shape[-1], x.dtype, x.device
    return (
        torch.empty((rows, nhid), dtype=cd, device=dev), torch.empty((rows, e), dtype=cd, device=dev),
        torch.empty((rows, nhid), dtype=cd, device=dev), torch.empty_like(x),
        *_weight_grads(e, nhid, rows, dev),
    )


def mlp_ln_bwd(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8. Replaces `multimodalpfn_tpu/ops/pallas_fused.py:_mlp_bwd_kernel_g` /
    `_mlp_bwd_kernel` (called through `_mlp_bwd_call`); kernel in
    `csrc/mlp_ln_bwd.cu`, its body chosen by `mlp_bwd_body`. Results as
    `mlp_ln_bwd_plain`."""
    if x.device.type == "cpu":
        return mlp_ln_bwd_plain(x, w1, w2, g)
    e = x.shape[-1]
    nhid = w1.shape[1]
    kernels.require_shape("K8", "w1", w1, (e, nhid))
    kernels.require_shape("K8", "w2", w2, (nhid, e))
    kernels.require_shape("K8", "g", g, tuple(x.shape))
    cd = x.dtype
    body = mlp_bwd_body(cd, e, nhid)
    w1c = kernels.aligned(w1.to(cd).contiguous())
    w2c = kernels.aligned(w2.to(cd).contiguous())
    x = kernels.aligned(x.contiguous())
    g = kernels.aligned(g.to(cd).contiguous())
    kernels.require_cuda("K8", x, g, w1c, w2c)
    rows = x.numel() // e
    lib = kernels.library()
    dtype, device, stream = kernels.launch_args(x, "K8")
    if body == "wgmma":
        bufs = _mlp_bwd_wg_buffers(x, rows, nhid)
        rc = lib.mmpfn_mlp_ln_bwd_wg(*(a.data_ptr() for a in (x, w1c, w2c, g) + bufs),
                                     rows, e, nhid, kernels.WGRAD_ROWS, device, stream)
        out = bufs[3:6]
    else:
        bufs = _mlp_bwd_buffers(x, rows, nhid)
        rc = lib.mmpfn_mlp_ln_bwd(*(a.data_ptr() for a in (x, w1c, w2c, g) + bufs),
                                  rows, e, nhid, kernels.WGRAD_ROWS, dtype, device, stream)
        out = bufs[6:9]
    kernels.check(rc, "K8")
    kernels.LAUNCHES["K8"] += 1
    kernels.BODY_LAUNCHES[f"K8 {body}"] += 1
    return out


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
