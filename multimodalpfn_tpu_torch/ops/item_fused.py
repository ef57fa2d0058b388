"""Fused item-attention sublayer: K2a (QKV projection + two-block online-softmax
attention) and K2b (out-projection + residual + LN). The counterpart of the JAX
package's `multimodalpfn_tpu/ops/pallas_item_fused.py`, forward only.

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
`csrc/item_attn.cu` / `csrc/item_epilogue.cu` or raises.
"""

from __future__ import annotations

import math

import torch

from multimodalpfn_tpu_torch.ops import kernels
from multimodalpfn_tpu_torch.ops.fused import ln_rows, rounder, softmax_pv

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
    (reference sublayer structure: `layer.py:341-455`)."""
    *lead, S, e = x.shape
    x3 = x.reshape(-1, S, e).to(compute_dtype).contiguous()
    o, _lse = item_attention_core(x3, w_qkv, single_eval_pos)
    return item_epilogue_ln(x3, o, w_out).reshape(*lead, S, e)
