"""Plain attention for the dual-axis transformer, and the dispatch gate for the
item-attention kernel.

Semantics anchor: reference `multi_head_attention.py:548-736` (einsum path)
with the stacked ``w_qkv (3,h,d,in)`` / ``w_out (h,d,out)`` weight layout
(`multi_head_attention.py:120-147`), and the two-block item attention of
`layer.py:341-395`:

  * train rows self-attend with all KV heads;
  * test rows cross-attend to train rows re-using only KV head 0 broadcast
    across all query heads (``reuse_first_head_kv``,
    `multi_head_attention.py:438-445`).

Matmuls take and emit the compute dtype (the JAX package's
``preferred_element_type=compute_dtype``); the softmax runs in float32.
"""

from __future__ import annotations

import math

import torch


def can_use_fused_item(
    sep: int,
    n_test: int,
    *,
    fused_item: bool,
    multiquery_test: bool,
    ring_axis: str | None,
) -> bool:
    """THE dispatch gate for the item-attention sublayer kernels
    (`ops/item_fused.py`), the counterpart of the JAX package's gate
    (`multimodalpfn_tpu/ops/attention.py:35-62`).

    The JAX bounds (512 <= sep <= 4096, n_test <= 4096) came from TPU VMEM
    (resident K/V) and tiny-shape padding on the TPU. The CUDA kernel streams
    K/V tiles from device memory and masks its ragged tiles, so neither bound
    applies: it serves any split with at least one train row. The kernel
    implements only the multiquery test block, and sequence parallelism is
    not ported.
    """
    del n_test  # no bound on the test rows: the kernel tiles them
    return fused_item and ring_axis is None and multiquery_test and sep >= 1


def mha(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    *,
    kv_head0_only: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multi-head attention with stacked qkv weights.

    x_q ``(..., Sq, E)``, x_kv ``(..., Sk, E)``, w_qkv ``(3, h, d, E)``,
    w_out ``(h, d, E_out)``. ``kv_head0_only``: multiquery — K/V only from
    head 0, shared across all query heads."""
    d = w_qkv.shape[2]
    scale = 1.0 / math.sqrt(d)
    cd = compute_dtype
    xq = x_q.to(cd)
    xkv = x_kv.to(cd)
    wq, wk, wv = (w_qkv[i].to(cd) for i in range(3))
    q = torch.einsum("...si,hdi->...shd", xq, wq)
    if kv_head0_only:
        k = torch.einsum("...si,di->...sd", xkv, wk[0])
        v = torch.einsum("...si,di->...sd", xkv, wv[0])
        logits = torch.einsum("...qhd,...kd->...hqk", q, k) * scale
        p = torch.softmax(logits.float(), dim=-1).to(cd)
        o = torch.einsum("...hqk,...kd->...qhd", p, v)
    else:
        k = torch.einsum("...si,hdi->...shd", xkv, wk)
        v = torch.einsum("...si,hdi->...shd", xkv, wv)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
        p = torch.softmax(logits.float(), dim=-1).to(cd)
        o = torch.einsum("...hqk,...khd->...qhd", p, v)
    return torch.einsum("...qhd,hdo->...qo", o, w_out.to(cd))


def item_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    *,
    single_eval_pos: int,
    multiquery_test: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Two-block attention over the items axis of ``x`` ``(..., S, E)``, whose
    first ``single_eval_pos`` rows are train rows (reference `layer.py:341-395`).
    Returns the pre-residual sublayer value ``(..., S, E_out)``."""
    sep = single_eval_pos
    train = x[..., :sep, :]
    test = x[..., sep:, :]
    out_train = mha(train, train, w_qkv, w_out, compute_dtype=compute_dtype)
    if test.shape[-2] == 0:
        return out_train
    out_test = mha(
        test,
        train,
        w_qkv,
        w_out,
        kv_head0_only=multiquery_test,
        compute_dtype=compute_dtype,
    )
    return torch.cat([out_train, out_test], dim=-2)
