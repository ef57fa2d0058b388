"""Fused item-attention sublayer: K2a (QKV projection + two-block online-softmax
attention) and K2b (out-projection + residual + LN), with their backward
kernels K9 and K10. The counterpart of the JAX package's
`multimodalpfn_tpu/ops/pallas_item_fused.py`.

Semantics are the reference two-block item attention (`layer.py:341-395`):
train rows self-attend with all KV heads; test rows attend to train rows only,
sharing KV head 0 across the query heads (``reuse_first_head_kv``,
`multi_head_attention.py:438-445`). Test rows never attend to each other, which
is what makes the estimator's test-row bucketing (repeat the last row) exact.

The attention output keeps the natural ``(G, S, h·d)`` layout; the Pallas
kernel's ``(G, h·d, S)`` layout was a TPU lane-layout choice
(`pallas_attention.py:12-18`).

Each op has a plain PyTorch version and a wrapper that runs the plain version
for a CPU tensor and, for a CUDA tensor, launches the kernels of
`csrc/item_attn.cu` / `csrc/item_epilogue.cu` (forward) and
`csrc/item_epilogue_bwd.cu` / `csrc/item_attn_bwd.cu` (backward) or raises.

Under autograd the sublayer saves what the JAX package's custom VJP saves (x,
the weights, the attention output o and the per-head lse) and its backward runs
K10 (LN backward, do = du·W_outᵀ, the per-head delta = Σ_d do·o, dW_out) then
K9 (the attention backward of both regions from the saved lse, with the QKV
projection recomputed from x, dx and dW_qkv).
"""

from __future__ import annotations

import math

import torch

from multimodalpfn_tpu_torch.ops import kernels
from multimodalpfn_tpu_torch.ops.fused import ln_rows, ln_rows_bwd, rounder, softmax_pv

# The plain version materializes (chunk, h, rows, sep) float32 scores; groups
# are processed in chunks of at most this many score bytes.
_PLAIN_SCORE_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# K2a: QKV projection + two-block attention -> o (G, S, h·d), lse (G, h, S)
# ---------------------------------------------------------------------------


def item_attention_core_plain(
    x3: torch.Tensor, w_qkv: torch.Tensor, single_eval_pos: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x3 ``(G, S, e)`` whose first ``single_eval_pos`` rows are train rows;
    w_qkv ``(3, h, d, e)``. Returns o ``(G, S, h·d)`` in x3's dtype (heads
    stacked on the last axis) and lse ``(G, h, S)`` float32."""
    cd = x3.dtype
    rnd = rounder(cd)
    G, S, e = x3.shape
    _, h, d, _ = w_qkv.shape
    hd, sep = h * d, single_eval_pos
    scale = 1.0 / math.sqrt(d)
    w2 = w_qkv.reshape(3 * hd, e).to(cd).float()
    chunk = max(1, _PLAIN_SCORE_BYTES // max(1, 4 * h * S * sep))
    o_parts, lse_parts = [], []
    for g0 in range(0, G, chunk):
        xg = x3[g0 : g0 + chunk].float()
        n = xg.shape[0]
        qkv = rnd(xg @ w2.T)  # (n, S, 3hd)
        q = qkv[..., :hd].reshape(n, S, h, d).transpose(1, 2)  # (n, h, S, d)
        k = qkv[:, :sep, hd : 2 * hd].reshape(n, sep, h, d).transpose(1, 2)
        v = qkv[:, :sep, 2 * hd :].reshape(n, sep, h, d).transpose(1, 2)
        o_tr, lse_tr = softmax_pv(
            (q[:, :, :sep] @ k.transpose(-1, -2)) * scale, v, rnd
        )
        o_te, lse_te = softmax_pv(  # test rows: KV head 0 for every query head
            (q[:, :, sep:] @ k[:, :1].transpose(-1, -2)) * scale, v[:, :1], rnd
        )
        o = torch.cat([o_tr, o_te], dim=2)  # (n, h, S, d)
        o_parts.append(o.transpose(1, 2).reshape(n, S, hd).to(cd))
        lse_parts.append(torch.cat([lse_tr, lse_te], dim=2))
    return torch.cat(o_parts), torch.cat(lse_parts)


def item_attention_core(
    x3: torch.Tensor, w_qkv: torch.Tensor, single_eval_pos: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a. Replaces `multimodalpfn_tpu/ops/pallas_item_fused.py:_fwd_kernel`
    (called twice through `_fwd_region` from `_fwd_call`); kernels in
    `csrc/item_attn.cu`: the QKV projection, then both regions' attention in
    one launch."""
    if x3.device.type == "cpu":
        return item_attention_core_plain(x3, w_qkv, single_eval_pos)
    G, S, e = x3.shape
    _, h, d, _ = w_qkv.shape
    kernels.require_shape("K2a", "w_qkv", w_qkv, (3, h, d, e))
    if d not in (8, 16, 32, 64) or not 1 <= single_eval_pos <= S:
        raise ValueError(f"K2a: unsupported d={d} or single_eval_pos={single_eval_pos}")
    w2 = kernels.aligned(w_qkv.reshape(3 * h * d, e).to(x3.dtype).contiguous())
    x3 = kernels.aligned(x3)
    kernels.require_cuda("K2a", x3, w2)
    tail = kernels.launch_args(x3, "K2a")
    lib = kernels.library()
    qkv = torch.empty((G, S, 3 * h * d), dtype=x3.dtype, device=x3.device)
    kernels.check(
        lib.mmpfn_proj_nt(
            x3.data_ptr(), w2.data_ptr(), qkv.data_ptr(), G * S, 3 * h * d, e, *tail
        ),
        "K2a",
    )
    o = torch.empty((G, S, h * d), dtype=x3.dtype, device=x3.device)
    lse = torch.empty((G, h, S), dtype=torch.float32, device=x3.device)
    kernels.check(
        lib.mmpfn_item_attn(
            qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), G, S, single_eval_pos, h, d, *tail
        ),
        "K2a",
    )
    kernels.LAUNCHES["K2a"] += 1
    return o, lse


# ---------------------------------------------------------------------------
# K2b: out-projection + residual + LN
# ---------------------------------------------------------------------------


def item_epilogue_ln_plain(x3: torch.Tensor, o: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """``LN(x + o·W_out)`` with the residual sum in float32 (the Pallas
    epilogue's precision, `pallas_item_fused.py:626-632`); x3 ``(G, S, e)``,
    o ``(G, S, h·d)``, w_out ``(h, d, e)``."""
    cd = x3.dtype
    hd = o.shape[-1]
    acc = o.float() @ w_out.reshape(hd, -1).to(cd).float()
    return ln_rows(x3.float() + acc).to(cd)


def item_epilogue_ln(x3: torch.Tensor, o: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """K2b. Replaces `multimodalpfn_tpu/ops/pallas_item_fused.py:_epi_fwd_kernel`
    (called through `_epi_fwd_call`); kernel in `csrc/item_epilogue.cu`."""
    if x3.device.type == "cpu":
        return item_epilogue_ln_plain(x3, o, w_out)
    e = x3.shape[-1]
    hd = o.shape[-1]
    if w_out.numel() != hd * e:
        raise ValueError(f"K2b: w_out has shape {tuple(w_out.shape)}, expected h·d = {hd} by e = {e}")
    if e > 256 or o.shape[:-1] != x3.shape[:-1] or o.dtype != x3.dtype:
        raise ValueError(f"K2b: unsupported operands x {tuple(x3.shape)}, o {tuple(o.shape)}")
    wout = kernels.aligned(w_out.reshape(hd, e).to(x3.dtype).contiguous())
    x3, o = kernels.aligned(x3), kernels.aligned(o)
    kernels.require_cuda("K2b", x3, o, wout)
    out = torch.empty_like(x3)
    rc = kernels.library().mmpfn_item_epilogue_ln(
        x3.data_ptr(), o.data_ptr(), wout.data_ptr(), out.data_ptr(),
        x3.numel() // e, e, hd, *kernels.launch_args(x3, "K2b"),
    )
    kernels.check(rc, "K2b")
    kernels.LAUNCHES["K2b"] += 1
    return out


def fused_item_sublayer(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    *,
    single_eval_pos: int,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Whole item-attention sublayer, ``LN(x + W_out·attn(x))``, over the items
    axis of x ``(..., S, e)``; returns x's shape in the compute dtype
    (reference sublayer structure: `layer.py:341-455`). Differentiable, with
    K10 and K9 as its backward (`_ItemSublayer`)."""
    *lead, S, e = x.shape
    x3 = x.reshape(-1, S, e).to(compute_dtype).contiguous()
    if kernels.needs_grad(x3, w_qkv, w_out):
        out = _ItemSublayer.apply(x3, w_qkv, w_out, single_eval_pos)
    else:
        o, _lse = item_attention_core(x3, w_qkv, single_eval_pos)
        out = item_epilogue_ln(x3, o, w_out)
    return out.reshape(*lead, S, e)


# ---------------------------------------------------------------------------
# K10: backward of K2b (out-projection + residual + LN), with the delta of K9
# ---------------------------------------------------------------------------


def item_epilogue_bwd_plain(
    x3: torch.Tensor, o: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of `item_epilogue_ln_plain` given g ``(G, S, e)``: returns
    du (the cotangent of x through the residual, in x's dtype), do
    ``(G, S, h·d)`` in x's dtype, the attention backward's per-head
    delta = Σ_d do·o ``(G, h, S)`` float32 (from do before it is rounded, as
    `pallas_item_fused.py:_epi_bwd_kernel`), and dw_out ``(h, d, e)``
    float32."""
    cd = x3.dtype
    rnd = rounder(cd)
    G, S, e = x3.shape
    h, d, _ = w_out.shape
    o32 = o.float()
    wo = w_out.reshape(h * d, e).to(cd).float()
    du_c = rnd(ln_rows_bwd(x3.float() + o32 @ wo, g.float()))
    do32 = du_c @ wo.T
    delta = (do32 * o32).reshape(G, S, h, d).sum(-1).transpose(1, 2).contiguous()
    dw = o32.reshape(-1, h * d).T @ du_c.reshape(-1, e)
    return du_c.to(cd), do32.to(cd), delta, dw.reshape(h, d, e)


def item_epilogue_bwd(
    x3: torch.Tensor, o: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10. Replaces `multimodalpfn_tpu/ops/pallas_item_fused.py:_epi_bwd_kernel`
    (called through `_epi_bwd_call`); kernel in `csrc/item_epilogue_bwd.cu`.
    Results as `item_epilogue_bwd_plain`."""
    if x3.device.type == "cpu":
        return item_epilogue_bwd_plain(x3, o, w_out, g)
    G, S, e = x3.shape
    h, d, _ = w_out.shape
    hd = h * d
    kernels.require_shape("K10", "w_out", w_out, (h, d, e))
    kernels.require_shape("K10", "o", o, (G, S, hd))
    kernels.require_shape("K10", "g", g, (G, S, e))
    cd = x3.dtype
    wout = kernels.aligned(w_out.reshape(hd, e).to(cd).contiguous())
    x3, o = kernels.aligned(x3.contiguous()), kernels.aligned(o.to(cd).contiguous())
    g = kernels.aligned(g.to(cd).contiguous())
    kernels.require_cuda("K10", x3, o, g, wout)
    rows, dev = G * S, x3.device
    u = torch.empty((rows, e), dtype=torch.float32, device=dev)
    du_c = torch.empty_like(x3)
    do32 = torch.empty((rows, hd), dtype=torch.float32, device=dev)
    do = torch.empty_like(o)
    delta = torch.empty((G, h, S), dtype=torch.float32, device=dev)
    dw = torch.empty((hd, e), dtype=torch.float32, device=dev)
    work = kernels.wgrad_workspace(rows, hd, e, dev)
    rc = kernels.library().mmpfn_item_epilogue_bwd(
        x3.data_ptr(), o.data_ptr(), wout.data_ptr(), g.data_ptr(), u.data_ptr(),
        du_c.data_ptr(), do32.data_ptr(), do.data_ptr(), delta.data_ptr(), dw.data_ptr(),
        work.data_ptr(), rows, S, e, h, d, kernels.WGRAD_ROWS, *kernels.launch_args(x3, "K10"),
    )
    kernels.check(rc, "K10")
    kernels.LAUNCHES["K10"] += 1
    return du_c, do, delta, dw.reshape(h, d, e)


# ---------------------------------------------------------------------------
# K9: backward of K2a's attention (both regions), dx and dW_qkv
# ---------------------------------------------------------------------------


def item_attention_bwd_plain(
    x3: torch.Tensor,
    w_qkv: torch.Tensor,
    do: torch.Tensor,
    delta: torch.Tensor,
    lse: torch.Tensor,
    single_eval_pos: int,
    dx_epi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangents of `item_attention_core_plain`'s o at x3 ``(G, S, e)`` and
    w_qkv, given do ``(G, S, h·d)``, the per-head delta and lse ``(G, h, S)``,
    added to ``dx_epi`` (the epilogue's cotangent of x). Returns dx in x3's
    dtype and dw_qkv ``(3, h, d, e)`` float32.

    Train rows self-attend with every KV head; test rows attend to the train
    rows through KV head 0, so their dk, dv sum over the query heads into
    head 0 and test rows get no dk, dv (`pallas_item_fused.py:_attn_bwd_impl`).
    The weights p come from the saved lse; p, ds, dq, dk and dv are rounded
    to the compute dtype where the Pallas kernel rounds them. A train row's
    dx sums the self region's q and kv sides and the cross region's kv side
    in float32."""
    cd = x3.dtype
    rnd = rounder(cd)
    G, S, e = x3.shape
    _, h, d, _ = w_qkv.shape
    hd, sep = h * d, single_eval_pos
    scale = 1.0 / math.sqrt(d)
    w = w_qkv.reshape(3 * hd, e).to(cd).float()
    w_ext = torch.cat([w, w[hd : hd + d], w[2 * hd : 2 * hd + d]])  # (3·hd + 2d, e)
    chunk = max(1, _PLAIN_SCORE_BYTES // max(1, 4 * h * S * sep))
    dx_parts, dw = [], torch.zeros_like(w_ext)
    for g0 in range(0, G, chunk):
        sl = slice(g0, g0 + chunk)
        xg = x3[sl].float()
        n = xg.shape[0]
        qkv = rnd(xg @ w.T)

        def heads(a, rows):  # (n, rows, h·d) -> (n, h, rows, d)
            return a.reshape(n, rows, h, d).transpose(1, 2)

        q = heads(qkv[..., :hd], S)
        k, v = heads(qkv[:, :sep, hd : 2 * hd], sep), heads(qkv[:, :sep, 2 * hd :], sep)
        dog = heads(do[sl].float(), S)
        lse_g, delta_g = lse[sl].float()[..., None], delta[sl].float()[..., None]

        def region(qr, kr, vr, dor, lser, deltar):
            p = torch.exp((qr @ kr.transpose(-1, -2)) * scale - lser)
            ds = rnd(p * ((dor @ vr.transpose(-1, -2)) - deltar) * scale)
            return ds @ kr, ds.transpose(-1, -2) @ qr, rnd(p).transpose(-1, -2) @ dor

        dq_tr, dk_s, dv_s = region(
            q[:, :, :sep], k, v, dog[:, :, :sep], lse_g[:, :, :sep], delta_g[:, :, :sep]
        )
        dq_te, dk_c, dv_c = region(
            q[:, :, sep:], k[:, :1], v[:, :1], dog[:, :, sep:], lse_g[:, :, sep:], delta_g[:, :, sep:]
        )
        dq = rnd(torch.cat([dq_tr, dq_te], dim=2)).transpose(1, 2).reshape(n, S, hd)
        dkv = torch.zeros((n, S, 2 * hd + 2 * d), dtype=torch.float32, device=x3.device)
        dkv[:, :sep, :hd] = rnd(dk_s).transpose(1, 2).reshape(n, sep, hd)
        dkv[:, :sep, hd : 2 * hd] = rnd(dv_s).transpose(1, 2).reshape(n, sep, hd)
        dkv[:, :sep, 2 * hd : 2 * hd + d] = rnd(dk_c.sum(1))
        dkv[:, :sep, 2 * hd + d :] = rnd(dv_c.sum(1))
        dqkv = torch.cat([dq, dkv], dim=-1)  # (n, S, 3·h·d + 2d)
        dx_parts.append((dx_epi[sl].float() + dqkv @ w_ext).to(cd))
        dw += dqkv.reshape(-1, dqkv.shape[-1]).T @ xg.reshape(-1, e)
    return torch.cat(dx_parts), _fold_dw_ext(dw, h, d)


def _fold_dw_ext(dw: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """dW of the extended weight rows ``[W_q; W_k; W_v; W_k0; W_v0]`` folded
    into ``(3, h, d, e)``: the cross region's rows add into head 0 of W_k and
    W_v."""
    hd = h * d
    out = dw[: 3 * hd].clone()
    out[hd : hd + d] += dw[3 * hd : 3 * hd + d]
    out[2 * hd : 2 * hd + d] += dw[3 * hd + d :]
    return out.reshape(3, h, d, -1)


def item_attention_bwd(
    x3: torch.Tensor,
    w_qkv: torch.Tensor,
    do: torch.Tensor,
    delta: torch.Tensor,
    lse: torch.Tensor,
    single_eval_pos: int,
    dx_epi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K9. Replaces `multimodalpfn_tpu/ops/pallas_item_fused.py:_bwd_kernel`
    (called through `_bwd_region` for both regions from `_attn_bwd_impl`);
    kernel in `csrc/item_attn_bwd.cu`. Results as `item_attention_bwd_plain`."""
    if x3.device.type == "cpu":
        return item_attention_bwd_plain(x3, w_qkv, do, delta, lse, single_eval_pos, dx_epi)
    G, S, e = x3.shape
    _, h, d, _ = w_qkv.shape
    hd, sep = h * d, single_eval_pos
    kernels.require_shape("K9", "w_qkv", w_qkv, (3, h, d, e))
    kernels.require_shape("K9", "do", do, (G, S, hd))
    kernels.require_shape("K9", "lse", lse, (G, h, S))
    kernels.require_shape("K9", "delta", delta, (G, h, S))
    kernels.require_shape("K9", "dx_epi", dx_epi, (G, S, e))
    if d not in (8, 16, 32, 64) or not 1 <= sep <= S or G > 65535:
        raise ValueError(f"K9: unsupported d={d}, G={G} or single_eval_pos={sep}")
    cd = x3.dtype
    w = w_qkv.reshape(3 * hd, e).to(cd)
    w_ext = kernels.aligned(torch.cat([w, w[hd : hd + d], w[2 * hd : 2 * hd + d]]).contiguous())
    x3 = kernels.aligned(x3.contiguous())
    do = kernels.aligned(do.to(cd).contiguous())
    dx_epi = kernels.aligned(dx_epi.to(cd).contiguous())
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    kernels.require_cuda("K9", x3, w_ext, do, lse, delta, dx_epi)
    rows, dev, n_ext = G * S, x3.device, 3 * hd + 2 * d
    qkv = torch.empty((rows, 3 * hd), dtype=cd, device=dev)
    dqkv = torch.zeros((rows, n_ext), dtype=cd, device=dev)  # test rows keep dk = dv = 0
    dx = torch.empty_like(x3)
    dw = torch.empty((n_ext, e), dtype=torch.float32, device=dev)
    work = kernels.wgrad_workspace(rows, n_ext, e, dev)
    rc = kernels.library().mmpfn_item_attn_bwd(
        x3.data_ptr(), w_ext.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dx_epi.data_ptr(), qkv.data_ptr(), dqkv.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        work.data_ptr(), G, S, sep, h, d, e, kernels.WGRAD_ROWS, *kernels.launch_args(x3, "K9"),
    )
    kernels.check(rc, "K9")
    kernels.LAUNCHES["K9"] += 1
    return dx, _fold_dw_ext(dw, h, d)


class _ItemSublayer(torch.autograd.Function):
    """K2a + K2b forward, K10 + K9 backward; saves x, the weights, o and lse
    (the JAX package's `_item_sublayer_core`)."""

    @staticmethod
    def forward(ctx, x3, w_qkv, w_out, single_eval_pos):
        o, lse = item_attention_core(x3, w_qkv, single_eval_pos)
        ctx.save_for_backward(x3, w_qkv, w_out, o, lse)
        ctx.sep = single_eval_pos
        return item_epilogue_ln(x3, o, w_out)

    @staticmethod
    def backward(ctx, g):
        x3, w_qkv, w_out, o, lse = ctx.saved_tensors
        du, do, delta, dw_out = item_epilogue_bwd(x3, o, w_out, g.to(x3.dtype))
        dx, dw_qkv = item_attention_bwd(x3, w_qkv, do, delta, lse, ctx.sep, du)
        return dx, dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype), None
