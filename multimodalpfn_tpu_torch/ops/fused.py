"""Fused row-local encoder sublayers: K1 and K5 (feature attention + residual
+ LN, item-major and sample-major), their key-masked forms K6a and K6b (for
members of different widths padded into one group), and K3 (MLP + residual +
LN). The counterpart of the JAX package's `multimodalpfn_tpu/ops/pallas_fused.py`,
forward only.

Each sublayer has a plain PyTorch version (``*_plain``) and a wrapper. The
wrapper runs the plain version for a tensor on the CPU; for a CUDA tensor it
launches the hand-written kernel (`csrc/feat_attn.cu`, `csrc/mlp_ln.cu`) or
raises. The plain versions round to the compute dtype at the points where the
Pallas kernels do (projections, scaled q, softmax weights, head outputs, the
MLP hidden) and keep every sum in float32, so in float32 they are the same
function as the kernels and in bfloat16 they differ only by summation order.
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
    flattened over x's leading axes."""
    if x.device.type == "cpu":
        return feature_attention_ln_plain(x, w_qkv, w_out, token_valid_count, key_mask)
    if token_valid_count is not None and key_mask is not None:
        raise ValueError("token_valid_count and key_mask are exclusive")
    kid = "K5" if key_mask is None else "K6b"
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
    kernel in `csrc/feat_attn.cu`."""
    if x.device.type == "cpu":
        return feature_attention_ln_im_plain(x, w_qkv, w_out, key_mask)
    kid = "K1" if key_mask is None else "K6a"
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
    (called through `_mlp_fwd_call`); kernel in `csrc/mlp_ln.cu`."""
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

