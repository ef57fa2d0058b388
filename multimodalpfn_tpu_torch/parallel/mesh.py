"""Process groups, the device mesh and the tensor-parallel layout, on
``torch.distributed``: the counterpart of the JAX package's
`multimodalpfn_tpu/parallel/mesh.py`.

One `DeviceMesh` of shape ``(world // mp, mp)`` with axes

  * ``dp`` — data parallel over episodes, sweep runs and ring shards of the
    item attention (`ring_attention.py`);
  * ``mp`` — tensor parallel: attention heads and MLP hidden units of every
    layer, MGM heads and MoE experts, each sharded at rest.

NCCL serves the card and gloo the CPU (``initialize_distributed(device=...)``).
A gloo group also carries CUDA tensors, through host memory: that is how two
ranks share one card (NCCL refuses two ranks on one device).

Tensor parallelism keeps each rank's shard of a leaf at rest (`shard_params`,
`shard_estimator`) and all-gathers it where the leaf is used (`gather_leaf`:
`models/transformer._layer`, `models/mixers.apply_mixer`), under the ambient
mesh (`set_mesh`). The fused kernels end in a residual + LN over the whole
width, so a partial sum split by heads or hidden units cannot enter them;
every ``mp`` rank runs the whole layer on the gathered weights, and under
autograd keeps its slice of the (identical) full gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# a tensor-parallel shard carries the axis it was cut along as this attribute
SHARD_ATTR = "mp_shard_axis"

_AMBIENT: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar("mmpfn_mesh", default=None)


def _int_env(name: str) -> int:
    try:
        return int(os.environ.get(name, "1"))
    except ValueError:
        return 1


def _cluster_env_detected() -> bool:
    """True when the environment says this process is one of several of a
    job: a multi-task SLURM job, or a launcher's rendezvous (torchrun's
    ``WORLD_SIZE > 1`` or ``MASTER_ADDR``). Then a failed init is an error:
    degrading to one process would give wrong results or hung collectives."""
    return _int_env("SLURM_NTASKS") > 1 or _int_env("WORLD_SIZE") > 1 or bool(os.environ.get("MASTER_ADDR"))


def _backend_for(device: str | torch.device) -> str:
    """NCCL for the card, gloo for the CPU; raises when CUDA is asked for and
    missing (never a switch to gloo)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_distributed: CUDA is not available; pass device="cpu" for gloo')
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"initialize_distributed: no backend for device {device!r}")


def initialize_distributed(*, device: str | torch.device = "cuda", **kwargs: Any) -> bool:
    """Join the job's process group (`torch.distributed.init_process_group`
    with ``kwargs``: ``init_method``, ``world_size``, ``rank``, ``timeout``,
    ...). Returns True when a process group is (or already was) initialized.

      * already initialized -> True;
      * explicit kwargs that fail -> raises;
      * no kwargs and no cluster environment -> False, nothing initialized;
      * no kwargs, cluster markers present (`_cluster_env_detected`) -> the
        launcher's ``env://`` rendezvous, and any failure raises.

    With NCCL each process takes the card ``LOCAL_RANK`` (or its rank modulo
    the card count)."""
    if dist.is_initialized():
        return True
    if not kwargs and not _cluster_env_detected():
        return False
    backend = _backend_for(device)
    dist.init_process_group(backend=backend, **kwargs)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else dist.get_rank() % torch.cuda.device_count())
    return True


def make_mesh(n_devices: int | None = None, *, mp: int = 1, axis_names=("dp", "mp")) -> DeviceMesh:
    """The ``(n // mp, mp)`` mesh over every rank of the process group (rank
    r at ``(r // mp, r % mp)``); ``n_devices``, when given, must be the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process group has {n} ranks")
    if n % mp:
        raise ValueError(f"mp={mp} must divide device count {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // mp, mp), mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh | None) -> Iterator[DeviceMesh | None]:
    """The ambient mesh inside the block (``jax.set_mesh``): ring attention
    with ``mesh=None`` and the gathers of tensor-parallel shards read it."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_mesh() -> DeviceMesh | None:
    """The ambient mesh (`set_mesh`), or None."""
    return _AMBIENT.get()


def require_mesh(mesh: DeviceMesh | None, axis: str, who: str) -> DeviceMesh:
    """``mesh``, or the ambient one, which must have ``axis``."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"{who}: no mesh given and the ambient mesh {mesh} has no axis {axis!r}; "
                         "wrap the call in set_mesh(...)")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


# --- collectives -------------------------------------------------------------
# gloo carries CUDA tensors through host memory (two ranks on one card); NCCL
# takes device tensors as they are


def via_host(t: torch.Tensor, group: dist.ProcessGroup) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group: dist.ProcessGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    src = t.detach().contiguous()
    host = via_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


# --- the tensor-parallel layout ----------------------------------------------


def _mp_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, "mp") if "mp" in (mesh.mesh_dim_names or ()) else 1


def _walk(tree: dict, fn, path: tuple = ()) -> dict:
    return {k: _walk(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def _rule(path: tuple, shape: tuple, mp: int) -> int | None:
    """The JAX package's rule (`parallel/mesh.py:113-140`): in the layers,
    attention heads (``w_qkv`` axis 2, ``w_out`` axis 1) and MLP hidden units
    (``w1`` axis 2, ``w2`` axis 1); MoE and MGM leaves on axis 0; each only
    where ``mp`` divides the axis, else replicated (None)."""

    def div(axis: int) -> bool:
        return len(shape) > axis and shape[axis] % mp == 0

    if "layers" in path:
        for name, axis in (("w_qkv", 2), ("w_out", 1), ("w1", 2), ("w2", 1)):
            if name in path and div(axis):
                return axis
        return None
    if ("moe" in path or "mgm" in path) and div(0):
        return 0
    return None


def param_shardings(params: dict, mesh: DeviceMesh) -> dict:
    """Per leaf of ``params``, the axis it is sharded along over ``mp``, or
    None (replicated)."""
    mp = _mp_size(mesh)
    return _walk(params, lambda path, leaf: _rule(path, tuple(leaf.shape), mp))


def batch_shardings(batch: dict, mesh: DeviceMesh) -> dict:
    """Episodes, members and trials shard over ``dp`` on the leading axis:
    axis 0 for every tensor leaf."""
    del mesh
    return _walk(batch, lambda path, leaf: 0 if isinstance(leaf, torch.Tensor) and leaf.ndim else None)


def replicated(tree: dict, mesh: DeviceMesh) -> dict:
    """Every leaf replicated: None."""
    del mesh
    return _walk(tree, lambda path, leaf: None)


def shard_axis(t: torch.Tensor) -> int | None:
    """The axis a tensor-parallel shard was cut along, or None for a whole
    leaf."""
    return getattr(t, SHARD_ATTR, None)


def mark_shard(t: torch.Tensor, axis: int | None) -> torch.Tensor:
    setattr(t, SHARD_ATTR, axis)
    return t


def shard_params(params: dict, mesh: DeviceMesh) -> dict:
    """``params`` with each leaf that `param_shardings` shards replaced by
    this rank's contiguous block along its axis (marked, `shard_axis`)."""
    mp, r = _mp_size(mesh), (mesh.get_local_rank("mp") if _mp_size(mesh) > 1 else 0)

    def cut(path, leaf):
        axis = _rule(path, tuple(leaf.shape), mp)
        if axis is None or mp == 1:
            return leaf
        size = leaf.shape[axis] // mp
        return mark_shard(leaf.narrow(axis, r * size, size).contiguous(), axis)

    return _walk(params, cut)


class _GatherMP(torch.autograd.Function):
    """All-gather a shard over ``mp``; the backward keeps this rank's slice
    of the gradient. Every ``mp`` rank computes the same full gradient, so
    no reduction is needed."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size, ctx.rank = dim, t.shape[dim], dist.get_rank(group)
        return all_gather_cat(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def gather_leaf(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole leaf from this rank's shard ``t`` cut along ``dim``, over the
    ambient mesh's ``mp`` axis (differentiable)."""
    mesh = require_mesh(None, "mp", "a tensor-parallel shard")
    group = mesh.get_group("mp")
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherMP.apply(t, dim, group)
    return all_gather_cat(t, group, dim)


def gather_tree(tree: dict) -> dict:
    """``tree`` with every marked shard gathered (`gather_leaf`)."""
    if not any(shard_axis(v) is not None for v in _leaves(tree)):
        return tree
    return _walk(tree, lambda path, v: v if shard_axis(v) is None else gather_leaf(v, shard_axis(v)))


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def full_grad(p: torch.Tensor) -> torch.Tensor | None:
    """``p.grad``, gathered over ``mp`` where ``p`` is a shard."""
    if p.grad is None or shard_axis(p) is None:
        return p.grad
    mesh = require_mesh(None, "mp", "a tensor-parallel shard")
    return all_gather_cat(p.grad, mesh.get_group("mp"), shard_axis(p))


def local_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This ``dp`` rank's contiguous block of the batch's leading episode
    axis (``P("dp")``): every tensor whose leading size is the episode
    count ``y_train.shape[0]``; other entries as they are."""
    n = axis_size(mesh, "dp")
    if n == 1:
        return batch
    b = batch["y_train"].shape[0]
    if b % n:
        raise ValueError(f"the batch's {b} episodes do not divide over the {n} ranks of axis 'dp'")
    r, m = mesh.get_local_rank("dp"), b // n
    return {k: v[r * m:(r + 1) * m] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == b else v
            for k, v in batch.items()}


def shard_estimator(estimator, mesh: DeviceMesh):
    """Tensor-parallel serving: re-lay a FITTED classifier's or regressor's
    ``params_`` (and its inference engine's) to this rank's ``mp`` shards
    (`shard_params`). Call ``predict``/``predict_proba`` inside
    ``with set_mesh(mesh):``, where each layer gathers its shards; the
    answers are the unsharded estimator's. Returns the estimator."""
    params = getattr(estimator, "params_", None)
    if params is None:
        raise ValueError("shard_estimator requires a fitted estimator (call fit first)")
    estimator.params_ = shard_params(params, mesh)
    executor = getattr(estimator, "executor_", None)
    if executor is not None:
        executor.params = estimator.params_
    return estimator
