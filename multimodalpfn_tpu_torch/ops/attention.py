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
``preferred_element_type=compute_dtype``); the softmax runs in float32. With
``use_flash`` the attention core is the flash kernel K4 (`ops/flash.py`), whose
plain version serves CPU tensors; under autograd its backward is K11. With a
ring axis the item attention's K/V are sharded over a mesh axis
(`parallel/ring_attention.py`).
"""

from __future__ import annotations

import math

import torch

from multimodalpfn_tpu_torch.ops.flash import flash_attention
from multimodalpfn_tpu_torch.parallel.ring_attention import ring_attention


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
    implements only the multiquery test block, and holds the whole K/V: under
    a ring axis (sequence parallelism) the item attention runs `_ring_mha`.
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
    use_flash: bool = False,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention with stacked qkv weights.

    x_q ``(..., Sq, E)``, x_kv ``(..., Sk, E)``, w_qkv ``(3, h, d, E)``,
    w_out ``(h, d, E_out)``. ``kv_head0_only``: multiquery — K/V only from
    head 0, shared across all query heads. ``use_flash``: the attention core
    runs K4 (the JAX package's flash branch, `ops/attention.py:105-151`).
    ``key_mask``: bool, broadcastable to the logits ``(..., h, Sq, Sk)``;
    False keys get -inf logits (plain path only, as in the JAX package)."""
    if key_mask is not None and use_flash:
        raise NotImplementedError("key_mask is not supported on the flash path")
    d = w_qkv.shape[2]
    scale = 1.0 / math.sqrt(d)
    cd = compute_dtype
    xq = x_q.to(cd)
    xkv = x_kv.to(cd)
    wq, wk, wv = (w_qkv[i].to(cd) for i in range(3))
    if use_flash:
        return _flash_mha(xq, xkv, wq, wk, wv, w_out.to(cd), kv_head0_only)
    q = torch.einsum("...si,hdi->...shd", xq, wq)
    if kv_head0_only:
        k = torch.einsum("...si,di->...sd", xkv, wk[0])
        v = torch.einsum("...si,di->...sd", xkv, wv[0])
        logits = torch.einsum("...qhd,...kd->...hqk", q, k) * scale
        p = torch.softmax(_masked(logits, key_mask).float(), dim=-1).to(cd)
        o = torch.einsum("...hqk,...kd->...qhd", p, v)
    else:
        k = torch.einsum("...si,hdi->...shd", xkv, wk)
        v = torch.einsum("...si,hdi->...shd", xkv, wv)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
        p = torch.softmax(_masked(logits, key_mask).float(), dim=-1).to(cd)
        o = torch.einsum("...hqk,...khd->...qhd", p, v)
    return torch.einsum("...qhd,hdo->...qo", o, w_out.to(cd))


def _masked(logits: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
    if key_mask is None:
        return logits
    keep = key_mask.to(device=logits.device, dtype=torch.bool)
    return logits.masked_fill(~keep, float("-inf"))


def _flash_mha(xq, xkv, wq, wk, wv, w_out, kv_head0_only: bool) -> torch.Tensor:
    """`mha` through K4 on compute-dtype operands: the projections emit the
    compute dtype, the heads (or, multiquery, the query heads folded into the
    query axis, head-major, against KV head 0) fold into K4's groups, and K4's
    float32 output is rounded to the compute dtype for the out-projection.
    Under autograd K4's o goes through `flash.flash_attention`'s autograd
    Function, whose backward is K11 (the folded heads' dk, dv sum into KV
    head 0); the projections and the out-projection are einsums, as the JAX
    package computes them in XLA outside the Pallas call."""
    lead, Sq, Skv = xq.shape[:-2], xq.shape[-2], xkv.shape[-2]
    h, d = wq.shape[:2]
    # K4 takes contiguous (G, S, d) operands: an einsum may return a permuted view
    q = torch.einsum("...si,hdi->...hsd", xq, wq).contiguous()
    if kv_head0_only:
        k = torch.einsum("...si,di->...sd", xkv, wk[0]).contiguous().reshape(-1, Skv, d)
        v = torch.einsum("...si,di->...sd", xkv, wv[0]).contiguous().reshape(-1, Skv, d)
        o, _ = flash_attention(q.reshape(-1, h * Sq, d), k, v)
    else:
        k = torch.einsum("...si,hdi->...hsd", xkv, wk).contiguous().reshape(-1, Skv, d)
        v = torch.einsum("...si,hdi->...hsd", xkv, wv).contiguous().reshape(-1, Skv, d)
        o, _ = flash_attention(q.reshape(-1, Sq, d), k, v)
    o = o.reshape(*lead, h, Sq, d).to(xq.dtype)
    return torch.einsum("...hqd,hdo->...qo", o, w_out)


def _ring_mha(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    *,
    ring_axis: str,
    kv_head0_only: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    use_flash: bool = False,
) -> torch.Tensor:
    """Sequence-parallel `mha` (the JAX package's `_ring_mha`,
    `ops/attention.py:212-283`): the K/V rows ring-sharded over
    ``ring_axis`` of the ambient mesh, the queries replicated. The
    projections are einsums on every rank; only the attention core runs in
    the ring (`parallel/ring_attention.py`, K4 and K11 with ``use_flash``).
    Multiquery (``kv_head0_only``) folds the query heads into extra query
    rows, head-major, against KV head 0."""
    cd = compute_dtype
    h, d = w_qkv.shape[1], w_qkv.shape[2]
    lead, Sq, Skv = x_q.shape[:-2], x_q.shape[-2], x_kv.shape[-2]
    xq, xkv = x_q.to(cd), x_kv.to(cd)
    wq, wk, wv = (w_qkv[i].to(cd) for i in range(3))
    q = torch.einsum("...si,hdi->...hsd", xq, wq)
    if kv_head0_only:
        q = q.reshape(-1, 1, h * Sq, d)
        k = torch.einsum("...si,di->...sd", xkv, wk[0]).reshape(-1, 1, Skv, d)
        v = torch.einsum("...si,di->...sd", xkv, wv[0]).reshape(-1, 1, Skv, d)
    else:
        q = q.reshape(-1, h, Sq, d)
        k = torch.einsum("...si,hdi->...hsd", xkv, wk).reshape(-1, h, Skv, d)
        v = torch.einsum("...si,hdi->...hsd", xkv, wv).reshape(-1, h, Skv, d)
    o = ring_attention(q, k, v, axis=ring_axis, sm_scale=1.0 / math.sqrt(d), use_flash=use_flash)
    o = o.reshape(*lead, h, Sq, d).to(cd)
    return torch.einsum("...hqd,hdo->...qo", o, w_out.to(cd))


def item_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    w_out: torch.Tensor,
    *,
    single_eval_pos: int,
    multiquery_test: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    use_flash: bool = False,
    ring_axis: str | None = None,
) -> torch.Tensor:
    """Two-block attention over the items axis of ``x`` ``(..., S, E)``, whose
    first ``single_eval_pos`` rows are train rows (reference `layer.py:341-395`).
    Returns the pre-residual sublayer value ``(..., S, E_out)``.

    ``use_flash`` runs both blocks' attention cores on K4 at every ``sep``: the
    JAX package's ``sep >= 512`` floor (`ops/attention.py:344`) avoided TPU
    tile padding, and K4 masks its ragged tiles. ``ring_axis``: sequence
    parallelism (``cfg.seq_shard_axis``) — both blocks attend to the train
    rows' K/V ring-sharded over this axis of the ambient mesh (`_ring_mha`);
    ``sep`` must divide by the axis size."""
    sep = single_eval_pos
    train = x[..., :sep, :]
    test = x[..., sep:, :]
    if ring_axis is not None:
        out_train = _ring_mha(train, train, w_qkv, w_out, ring_axis=ring_axis,
                              compute_dtype=compute_dtype, use_flash=use_flash)
        if test.shape[-2] == 0:
            return out_train
        out_test = _ring_mha(test, train, w_qkv, w_out, ring_axis=ring_axis,
                             kv_head0_only=multiquery_test, compute_dtype=compute_dtype,
                             use_flash=use_flash)
        return torch.cat([out_train, out_test], dim=-2)
    out_train = mha(train, train, w_qkv, w_out, compute_dtype=compute_dtype, use_flash=use_flash)
    if test.shape[-2] == 0:
        return out_train
    out_test = mha(
        test,
        train,
        w_qkv,
        w_out,
        kv_head0_only=multiquery_test,
        compute_dtype=compute_dtype,
        use_flash=use_flash,
    )
    return torch.cat([out_train, out_test], dim=-2)
