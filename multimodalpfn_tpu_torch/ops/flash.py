"""Flash attention forward, K4: the counterpart of the JAX package's
`multimodalpfn_tpu/ops/pallas_attention.py`, forward only.

The port keeps the natural layout: q ``(G, Sq, d)``, k and v ``(G, Skv, d)``,
o ``(G, Sq, d)`` and lse ``(G, Sq)`` in float32. The Pallas kernel's
``(G, d, S)`` layout was a TPU lane trick (`pallas_attention.py:12-18`).
Multiquery attention (every query head against one shared KV head, the
reference's ``reuse_first_head_kv``) folds the query heads into the query
axis, head-major, as the JAX package does.

`flash_attention` runs `flash_attention_plain` for a tensor on the CPU; for a
CUDA tensor it launches the hand-written kernel (`csrc/flash_fwd.cu`) or
raises. The plain version rounds where the Pallas kernel does: float32 scores,
the unnormalized weights in v's dtype before P·V, the sum and ``acc / l`` in
float32.
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
    results as `flash_attention_plain`."""
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
    q, k, v = (kernels.aligned(t.contiguous()) for t in (q, k, v))
    kernels.require_cuda("K4", q, k, v)
    o = torch.empty((G, Sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((G, Sq), dtype=torch.float32, device=q.device)
    rc = kernels.library().mmpfn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        G, Sq, Skv, d, _scale(q, sm_scale), *kernels.launch_args(q, "K4"),
    )
    kernels.check(rc, "K4")
    kernels.LAUNCHES["K4"] += 1
    return o, lse


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
    if kv_head0_only:
        o, _ = flash_attention(q.reshape(B, h * Sq, d), k[:, 0], v[:, 0], sm_scale)
    else:
        o, _ = flash_attention(
            q.reshape(B * h, Sq, d), k.reshape(B * h, -1, d), v.reshape(B * h, -1, d), sm_scale
        )
    return o.reshape(B, h, Sq, d)
