"""Flash attention, K4 (forward) and K11 (backward): the counterpart of the
JAX package's `multimodalpfn_tpu/ops/pallas_attention.py`.

The port keeps the natural layout: q ``(G, Sq, d)``, k and v ``(G, Skv, d)``,
o ``(G, Sq, d)`` and lse ``(G, Sq)`` in float32. The Pallas kernel's
``(G, d, S)`` layout was a TPU lane trick (`pallas_attention.py:12-18`).
Multiquery attention (every query head against one shared KV head, the
reference's ``reuse_first_head_kv``) folds the query heads into the query
axis, head-major, as the JAX package does; in the backward each key's dk and
dv then sum over every query head.

`flash_attention` runs `flash_attention_plain` for a tensor on the CPU; for a
CUDA tensor it launches the hand-written kernel (`csrc/flash_fwd.cu`) or
raises. The plain version rounds where the Pallas kernel does: float32
scores, the unnormalized weights in v's dtype before P·V, the sum and
``acc / l`` in float32.

Under autograd `flash_attention` goes through `_FlashAttention`, the JAX
package's ``flash_mha_t`` custom VJP: the forward saves q, k, v, o and lse
(nothing is recomputed) and the backward runs K11 (`flash_attention_bwd`,
`csrc/flash_bwd.cu`), or on the CPU its plain version
`flash_attention_bwd_plain`, so the CPU tests exercise the formula K11
implements and not autograd of the plain forward.
"""

from __future__ import annotations

import math

import torch

from multimodalpfn_tpu_torch.ops import kernels
from multimodalpfn_tpu_torch.ops.fused import rounder, softmax_pv

# The plain version materializes (chunk, Sq, Skv) float32 scores; groups are
# processed in chunks of at most this many score bytes.
_PLAIN_SCORE_BYTES = 1 << 30


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``softmax(q·kᵀ·scale)·v`` per group: q ``(G, Sq, d)``, k, v
    ``(G, Skv, d)``; scale 1/sqrt(d) unless given. Returns o ``(G, Sq, d)``
    and lse ``(G, Sq)``, both float32."""
    scale = _scale(q, sm_scale)
    rnd = rounder(v.dtype)
    G, Sq, _ = q.shape
    chunk = max(1, _PLAIN_SCORE_BYTES // max(1, 4 * Sq * k.shape[1]))
    o_parts, lse_parts = [], []
    for g0 in range(0, G, chunk):
        sl = slice(g0, g0 + chunk)
        s = (q[sl].float() @ k[sl].float().transpose(-1, -2)) * scale
        o, lse = softmax_pv(s, v[sl].float(), rnd)
        o_parts.append(o)
        lse_parts.append(lse)
    return torch.cat(o_parts), torch.cat(lse_parts)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4. Replaces `multimodalpfn_tpu/ops/pallas_attention.py:_fwd_kernel`
    (called through `_fwd_impl`); kernel in `csrc/flash_fwd.cu`. Shapes and
    results as `flash_attention_plain`. Differentiable in q, k and v, with K11
    as its backward (`_FlashAttention`); lse carries no gradient. On the card
    q, k and v must be contiguous and the scale positive."""
    if kernels.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale)
    G, Sq, d = q.shape
    Skv = k.shape[1]
    kernels.require_shape("K4", "k", k, (G, Skv, d))
    kernels.require_shape("K4", "v", v, (G, Skv, d))
    if d not in (8, 16, 32, 64) or Skv < 1 or G > 65535:
        raise ValueError(f"K4: unsupported shape G={G}, Skv={Skv}, d={d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K4: q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    scale = _scale(q, sm_scale)
    if not scale > 0:
        raise ValueError(f"K4: the kernel takes a positive scale, got {scale}")
    # the bf16 kernel reads q, k and v through TMA tensor maps of (G, S, d):
    # every caller hands in contiguous tensors, and a copy here would hide one
    # that does not
    kernels.require_cuda("K4", q, k, v)
    q, k, v = (kernels.aligned(t) for t in (q, k, v))
    o = torch.empty((G, Sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((G, Sq), dtype=torch.float32, device=q.device)
    rc = kernels.library().mmpfn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        G, Sq, Skv, d, scale, *kernels.launch_args(q, "K4"),
    )
    kernels.check(rc, "K4")
    kernels.LAUNCHES["K4"] += 1
    return o, lse


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of `flash_attention_plain`'s o at q, k and v, from the
    forward's o and lse ``(G, Sq)`` (float32) and the cotangent do
    ``(G, Sq, d)`` (`pallas_attention.py:_bwd_impl`). Rounds where Pallas
    rounds: delta = Σ_d do·o in float32 before do is rounded to q's dtype;
    p = exp(s·scale − lse) rounded to do's dtype for dv;
    ds = rnd(p·(dp − delta)·scale), the scale folded in once; dq, dk and dv
    summed in float32 and rounded once, dq to q's dtype, dk and dv to k's."""
    scale = _scale(q, sm_scale)
    rnd = rounder(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    do_c = do.to(q.dtype).float()
    lse = lse.float()
    G, Sq, _ = q.shape
    chunk = max(1, _PLAIN_SCORE_BYTES // max(1, 4 * Sq * k.shape[1]))
    dq_parts, dk_parts, dv_parts = [], [], []
    for g0 in range(0, G, chunk):
        sl = slice(g0, g0 + chunk)
        qf, kf, vf, dof = q[sl].float(), k[sl].float(), v[sl].float(), do_c[sl]
        p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[sl, :, None])
        ds = rnd(p * ((dof @ vf.transpose(-1, -2)) - delta[sl, :, None]) * scale)
        dq_parts.append(ds @ kf)
        dk_parts.append(ds.transpose(-1, -2) @ qf)
        dv_parts.append(rnd(p).transpose(-1, -2) @ dof)
    return (torch.cat(dq_parts).to(q.dtype), torch.cat(dk_parts).to(k.dtype),
            torch.cat(dv_parts).to(v.dtype))


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11. Replaces `multimodalpfn_tpu/ops/pallas_attention.py:_bwd_kernel`
    (called through `_bwd_impl`, with its delta pre-step); kernel in
    `csrc/flash_bwd.cu`. Results as `flash_attention_bwd_plain`. The
    interface takes any (o, lse) of the same function, so a ring of shards
    can call it with the global o and lse of its queries."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale)
    G, Sq, d = q.shape
    Skv = k.shape[1]
    kernels.require_shape("K11", "k", k, (G, Skv, d))
    kernels.require_shape("K11", "v", v, (G, Skv, d))
    kernels.require_shape("K11", "o", o, (G, Sq, d))
    kernels.require_shape("K11", "lse", lse, (G, Sq))
    kernels.require_shape("K11", "do", do, (G, Sq, d))
    if d not in (8, 16, 32, 64) or Skv < 1 or G > 65535:
        raise ValueError(f"K11: unsupported shape G={G}, Skv={Skv}, d={d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K11: q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = (kernels.aligned(t.contiguous()) for t in (q, k, v))
    o, lse, do = (kernels.aligned(t.float().contiguous()) for t in (o, lse, do))
    kernels.require_cuda("K11", q, k, v, o, lse, do)
    do_c = torch.empty_like(q)
    delta = torch.empty((G, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = kernels.library().mmpfn_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        do_c.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        G, Sq, Skv, d, _scale(q, sm_scale), *kernels.launch_args(q, "K11"),
    )
    kernels.check(rc, "K11")
    kernels.LAUNCHES["K11"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K4 forward, K11 backward (the JAX package's ``flash_mha_t`` custom
    VJP): saves q, k, v, o and lse; lse is returned but carries no gradient,
    as ``flash_mha_t`` keeps it as a residual only."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_head0_only: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Conventional-layout wrapper (`pallas_attention.py:435-462`): q
    ``(B, h, Sq, d)``; k, v ``(B, h, Skv, d)``, or ``(B, h_kv, Skv, d)`` with
    only KV head 0 used when ``kv_head0_only`` (multiquery: the h query heads
    fold into the query axis against it). Returns float32 ``(B, h, Sq, d)``."""
    B, h, Sq, d = q.shape
    q = q.contiguous()
    if kv_head0_only:
        k, v = k[:, 0].contiguous(), v[:, 0].contiguous()
        o, _ = flash_attention(q.reshape(B, h * Sq, d), k, v, sm_scale)
    else:
        k, v = k.contiguous(), v.contiguous()
        o, _ = flash_attention(
            q.reshape(B * h, Sq, d), k.reshape(B * h, -1, d), v.reshape(B * h, -1, d), sm_scale
        )
    return o.reshape(B, h, Sq, d)
