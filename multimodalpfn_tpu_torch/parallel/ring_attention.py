"""Ring attention: item-axis attention with K/V sharded over a mesh axis,
forward and backward — the counterpart of the JAX package's
`multimodalpfn_tpu/parallel/ring_attention.py`.

Every rank holds a contiguous block of the K/V rows; the blocks rotate
around the ring (rank r sends to r + 1 and receives from r − 1: the JAX
permutation ``j -> j + 1``) while each rank accumulates its queries'
output. The next block's send and receive are posted before the current
block's compute, so the exchange overlaps it; the forward's last rotation,
which would only bring K/V home, is skipped.

  * Blocks merge in the normalized (o, lse) form,
    ``lse = logaddexp(lse_a, lse_b); o = o_a·e^{lse_a−lse} + o_b·e^{lse_b−lse}``,
    which is what the flash kernel K4 emits: with ``use_flash`` every block
    on the card runs K4 (`ops/flash.flash_attention`), on the CPU its plain
    version.
  * The backward (`_RingCore`) is a second ring pass: dq accumulates
    locally while each (k, v, dk, dv) quadruple rotates the full circle and
    arrives home with its complete gradient. Each step's block backward
    uses the global (o, lse) of the forward, so with ``use_flash`` it is K11
    (`ops/flash.flash_attention_bwd`).
  * Replicated queries: every rank computes the complete dq and the
    complete dk, dv of the visiting block (overwrite, not accumulate).
    Sharded queries accumulate dk, dv around the ring.

The public functions keep the JAX package's global contract: every rank
passes the whole q, k and v and cuts its own block (`_ShardRows`, whose
backward zero-pads the block's gradient and sums it over the ring: the
transpose ``shard_map`` gives the JAX package). `ring_attention` returns
the whole output on every rank, `ring_attention_sharded_queries` the
rank's block of it.

The JAX package ran shards under 512 rows (``MIN_FLASH_SHARD``, TPU lanes)
on XLA; K4 and K11 mask their ragged tiles, so every block takes the kernel.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodalpfn_tpu_torch.ops.flash import flash_attention, flash_attention_bwd
from multimodalpfn_tpu_torch.parallel.mesh import all_reduce_, require_mesh, via_host


def _g3(x: torch.Tensor) -> torch.Tensor:
    """(B, h, S, d) -> the kernels' contiguous (B·h, S, d)."""
    return x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous()


def _block_o_lse(q, k, v, scale: float, use_flash: bool):
    """Normalized block output and lse of q (B, h, Sq, d) against k, v
    (B, h, Skv, d): o (B, h, Sq, d) and lse (B, h, Sq), float32."""
    B, h, Sq, d = q.shape
    if use_flash:
        o, lse = flash_attention(_g3(q), _g3(k), _g3(v), scale)
        return o.reshape(B, h, Sq, d), lse.reshape(B, h, Sq)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = (p.to(v.dtype).float() @ v.float()) / l[..., None]
    return o, m + torch.log(l)


def _block_bwd(q, k, v, o, lse, g, delta, scale: float, use_flash: bool):
    """One ring step's block backward from the global (o, lse): ``p =
    exp(s·scale − lse)`` carries the whole softmax's normalization, so the
    visiting block's (dq, dk, dv) contribution is exact alone. Returns them
    in float32."""
    B, h, Sq, d = q.shape
    Skv = k.shape[2]
    if use_flash:
        dq, dk, dv = flash_attention_bwd(_g3(q), _g3(k), _g3(v), _g3(o), lse.reshape(B * h, Sq),
                                         _g3(g), scale)
        return (dq.float().reshape(B, h, Sq, d), dk.float().reshape(B, h, Skv, d),
                dv.float().reshape(B, h, Skv, d))
    cd = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    gc = g.to(cd).float()
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = p.to(cd).float().transpose(-1, -2) @ gc
    ds = (p * ((gc @ vf.transpose(-1, -2)) - delta[..., None]) * scale).to(cd).float()
    return ds @ kf, ds.transpose(-1, -2) @ qf, dv


def _rot(tensors: list[torch.Tensor], group: dist.ProcessGroup):
    """One step of the ring's rotation: posts the send of ``tensors`` to rank
    r + 1 and their receive from rank r − 1 (one `batch_isend_irecv`) and
    returns a function that waits for them and returns the received tensors.
    On a gloo group CUDA tensors go through host memory; on NCCL they are
    sent as they are."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    device, host = tensors[0].device, via_host(tensors[0], group)
    send = [t.detach().contiguous() for t in tensors]
    if host:
        send = [t.cpu() for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, group=group, group_peer=(r + 1) % n) for t in send]
    ops += [dist.P2POp(dist.irecv, t, group=group, group_peer=(r - 1) % n) for t in recv]
    works = dist.batch_isend_irecv(ops)

    def wait() -> list[torch.Tensor]:
        for w in works:
            w.wait()
        del send[:]  # the send buffers stay alive until the sends complete
        return [t.to(device) for t in recv] if host else recv

    return wait


def _ring_fwd(q, k, v, group, scale: float, use_flash: bool):
    """q's output against every rank's (k, v) block: o (B, h, Sq, d) and
    lse (B, h, Sq), float32."""
    n = dist.get_world_size(group)
    o = lse = None
    k_cur, v_cur = k, v
    for i in range(n):
        nxt = _rot([k_cur, v_cur], group) if i < n - 1 else None
        o_b, lse_b = _block_o_lse(q, k_cur, v_cur, scale, use_flash)
        if o is None:
            o, lse = o_b, lse_b
        else:
            lse_new = torch.logaddexp(lse, lse_b)
            o = o * torch.exp(lse - lse_new)[..., None] + o_b * torch.exp(lse_b - lse_new)[..., None]
            lse = lse_new
        if nxt is not None:
            k_cur, v_cur = nxt()
    return o, lse


class _RingCore(torch.autograd.Function):
    """Local-block ring attention (the JAX package's ``_ring_core``): q's
    block attends to every rank's (k, v) block over ``group``. Returns the
    normalized float32 output of q's rows. The backward is the second ring
    pass (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, use_flash, q_replicated):
        o, lse = _ring_fwd(q, k, v, group, scale, use_flash)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale, ctx.use_flash, ctx.q_replicated = group, scale, use_flash, q_replicated
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale, use_flash = ctx.group, ctx.scale, ctx.use_flash
        n = dist.get_world_size(group)
        g = g.float().contiguous()
        delta = (g * o).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for i in range(n):
            # the next (k, v) does not wait for this block: post it first
            kv = _rot([k_cur, v_cur], group) if i < n - 1 else None
            dq_b, dk_b, dv_b = _block_bwd(q, k_cur, v_cur, o, lse, g, delta, scale, use_flash)
            dq = dq + dq_b
            # replicated queries: this rank holds every query row, so the
            # visiting block's dk, dv are complete here (overwrite)
            dk_new, dv_new = (dk_b, dv_b) if ctx.q_replicated else (dk_cur + dk_b, dv_cur + dv_b)
            # (k, dk) and (v, dv) travel together; after n rotations each
            # pair is home with every rank's contribution
            if n > 1:
                dk_cur, dv_cur = _rot([dk_new, dv_new], group)()
            else:
                dk_cur, dv_cur = dk_new, dv_new
            if kv is not None:
                k_cur, v_cur = kv()
        # replicated queries: every rank holds the complete dq already (the
        # JAX package's pmean there only re-types it)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None, None, None


class _ShardRows(torch.autograd.Function):
    """This rank's contiguous block of ``x`` along ``dim`` over ``group``;
    the backward zero-pads the block's gradient to the whole and sums it
    over the group, so a replicated input gets its complete gradient on
    every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"ring attention: {x.shape[dim]} rows do not divide over the {n} ranks "
                             "of the ring axis")
        size = x.shape[dim] // n
        ctx.dim, ctx.start, ctx.size, ctx.shape, ctx.group = dim, r * size, size, x.shape, group
        return x.narrow(dim, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, ctx.size).copy_(g)
        return all_reduce_(full, ctx.group), None, None


def _setup(q, mesh: DeviceMesh | None, axis: str, sm_scale: float | None, who: str):
    mesh = require_mesh(mesh, axis, who)
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    return mesh.get_group(axis), scale


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: DeviceMesh | None = None,
    axis: str = "dp",
    sm_scale: float | None = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Non-causal attention with K/V sharded on ``axis`` along the sequence.

    q ``(B, h, Sq, d)``, k, v ``(B, h, Skv, d)``, the same on every rank of
    the axis; Skv must divide by the axis size. Returns ``(B, h, Sq, d)``
    float32, the whole output on every rank. ``mesh=None`` uses the ambient
    mesh (`set_mesh`). Differentiable (the ring backward); ``use_flash``
    runs each block through K4 and its backward through K11."""
    group, scale = _setup(q, mesh, axis, sm_scale, "ring_attention")
    k_loc, v_loc = _ShardRows.apply(k, 2, group), _ShardRows.apply(v, 2, group)
    return _RingCore.apply(q.contiguous(), k_loc, v_loc, group, scale, use_flash, True)


def ring_attention_sharded_queries(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: DeviceMesh | None = None,
    axis: str = "dp",
    sm_scale: float | None = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """The variant with the queries sharded too (full sequence
    parallelism): every rank passes the whole q, k, v and gets back its
    contiguous block of the output rows, ``(B, h, Sq / n, d)`` float32; Sq
    and Skv must divide by the axis size."""
    group, scale = _setup(q, mesh, axis, sm_scale, "ring_attention_sharded_queries")
    q_loc = _ShardRows.apply(q, 2, group)
    k_loc, v_loc = _ShardRows.apply(k, 2, group), _ShardRows.apply(v, 2, group)
    return _RingCore.apply(q_loc, k_loc, v_loc, group, scale, use_flash, False)
