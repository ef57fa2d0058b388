"""Fine-tuning step: loss + gradients + clip + schedule-free AdamW (or AdamW).

Reference semantics: `scripts_finetune_mm/finetune_mmpfn_main.py:589-708` and
the JAX package's `multimodalpfn_tpu/train/step.py`: forward on a K-fold
episode, loss on the test fold, global gradient norm clipped to 1.0,
schedule-free AdamW, optional frozen input encoders (`:204-206`). bf16
compute with float32 master weights needs no loss scaling.

No schedule-free package is installed for PyTorch, so `ScheduleFreeAdamW` is
written here, pinned step for step to the optax chain the JAX package builds
(`make_optimizer`: ``apply_if_finite(multi_transform({train:
chain(clip_by_global_norm, schedule_free_adamw), frozen: set_to_zero}))``)
and to the NumPy spec of `tests/test_optimizer_spec.py`; so is `AdamW`, the
same chain around ``optax.adamw`` (``optimizer="adamw"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.params import flatten_params, unflatten_params
from multimodalpfn_tpu_torch.parallel.mesh import (
    all_reduce_,
    axis_size,
    full_grad,
    local_batch,
    mark_shard,
    set_mesh,
    shard_axis,
)
from multimodalpfn_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    params: dict  # nested dict of float32 leaves that require grad (schedule-free: the y-iterate)
    optimizer: "GuardedOptimizer"
    step: int = 0


def frozen_input_mask(params: dict, freeze_input: bool) -> dict:
    """True = trainable. The reference freezes ``encoder`` and ``y_encoder``
    (`finetune_mmpfn_main.py:204-206`)."""
    return unflatten_params({
        k: not (freeze_input and k.split("/")[0] in ("encoder", "y_encoder"))
        for k in flatten_params(params)
    })


# The JAX package's chain: optax's schedule-free AdamW and AdamW defaults,
# the clip of `finetune.py` and `apply_if_finite`'s patience
B1, B2, EPS, WEIGHT_LR_POWER = 0.9, 0.999, 1e-8, 2.0
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch.optim.AdamW's is 1e-2)
MAX_GRAD_NORM = 1.0
MAX_CONSECUTIVE_NONFINITE = 100


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||t||²) over the tensors, float32 (``optax.global_norm``)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(torch.stack([(t.float() ** 2).sum() for t in tensors]).sum())


def warmup_lr(peak: float, warmup_steps: int | None, count: int) -> float:
    """optax's ``warmup_constant_schedule(0, peak, warmup_steps)`` at
    ``count``, in float32 as optax evaluates it; ``peak`` without warmup."""
    if not warmup_steps:
        return peak
    frac = np.float32(1) - np.float32(min(max(count, 0), warmup_steps)) / np.float32(warmup_steps)
    return float(np.float32(-peak) * frac + np.float32(peak))


class GuardedOptimizer(torch.optim.Optimizer):
    """The part of the JAX package's chain around the update rule: param
    groups with ``trainable=False`` are the frozen leaves (never updated, no
    state, left out of the clip: optax ``multi_transform`` partitions before
    the clip); the trainable gradients are clipped to a global norm of
    `MAX_GRAD_NORM`; a step whose gradients (frozen ones included) hold a NaN
    or an inf is skipped with no state change, up to
    `MAX_CONSECUTIVE_NONFINITE` in a row, then applied (optax
    ``apply_if_finite``). A tensor-parallel shard (`parallel.mesh`) is
    updated in place from its slice of the gradient, while the finiteness
    check and the clip's norm read the whole gradient (gathered over the
    ambient mesh's ``mp`` axis), so each rank's shard steps exactly as its
    slice of the whole leaf would. Subclasses give the update (`_update`), the state
    of a leaf (`STATE`, tensors like the leaf) and their counters
    (`SCALARS`, written with the train state)."""

    STATE: tuple[str, ...] = ()
    SCALARS: tuple[str, ...] = ("count", "notfinite_count", "total_notfinite")

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, trainable=True))
        self.count = 0  # applied steps
        self.notfinite_count = 0
        self.total_notfinite = 0
        for p in self._trainable():
            self.state[p] = self._init_state(p)

    def _init_state(self, p: torch.Tensor) -> dict:
        return {name: torch.zeros_like(p) for name in self.STATE}

    def _trainable(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups if g["trainable"] for p in g["params"]]

    def _all(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """One update from the params' ``.grad`` (a missing one counts as
        zero). Returns whether it was applied. The finiteness check and the
        clip's test each read a device value on the host: two host syncs
        (spans ``mmpfn.sync.finite``, ``mmpfn.sync.clip``)."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        full = {id(p): full_grad(p) for p in self._all() if p.grad is not None}
        finite = True
        if full:
            all_finite = torch.stack([torch.isfinite(g).all() for g in full.values()]).all()
            with span("mmpfn.sync.finite"):
                finite = bool(all_finite)
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
            if self.notfinite_count <= MAX_CONSECUTIVE_NONFINITE:
                return False
        params = self._trainable()
        if not params:
            return True
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = global_norm(full[id(p)].float() if id(p) in full else torch.zeros_like(p) for p in params)
        below = gnorm < MAX_GRAD_NORM
        with span("mmpfn.sync.clip"):
            below = bool(below)
        if not below:  # optax: (g / ‖g‖) · max_norm
            grads = torch._foreach_mul(torch._foreach_div(grads, gnorm), MAX_GRAD_NORM)
        self.count += 1
        self._update(params, grads, float(self.param_groups[0]["lr"]))
        return True

    def _update(self, params: list[torch.Tensor], grads: list[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def eval_point(self, p: torch.Tensor) -> torch.Tensor:
        """The point at which validation evaluates the param: the param."""
        return p.detach()


class ScheduleFreeAdamW(GuardedOptimizer):
    """Schedule-free AdamW (Defazio et al. 2024) as optax composes it for the
    JAX package (optax 0.2.6 ``contrib.schedule_free_adamw``, weight decay 0,
    inside ``clip_by_global_norm`` and ``apply_if_finite``, `GuardedOptimizer`).

    The params are the gradient-evaluation point y; the state holds the base
    iterate z and Adam's second moment ν. Per applied step t (1, 2, ...),
    with the clipped trainable gradients g:

        ν ← b2·ν + (1−b2)·g²,   u = g / (sqrt(ν / (1 − b2^t)) + eps)
        z' = z − lr(t − 1)·u
        c = lr_max(t)² / Σ lr_max²                 (weight_lr_power 2)
        x = (y − (1−b1)·z) / b1,  x' = (1−c)·x + c·z'
        y ← y + (b1·x' + (1−b1)·z' − y)

    lr(t) is the learning rate, or with ``warmup_steps`` optax's linear
    warmup from 0 to it over that many steps: the base update reads it at
    its own count (t − 1), the averaging weight at the schedule-free count t,
    as optax does. ``warmup_steps`` 0 means none (the JAX package turns 0
    into None: optax would build a constant-zero schedule). Evaluation uses
    `eval_point`: x = (y − (1−b1)·z) / b1.
    """

    STATE = ("z", "nu")
    SCALARS = ("count", "max_lr", "weight_sum", "notfinite_count", "total_notfinite")

    def __init__(self, params, lr: float = 1e-5, warmup_steps: int | None = None):
        self.max_lr = 0.0
        self.weight_sum = 0.0
        self.warmup_steps = warmup_steps or None
        super().__init__(params, lr)

    def _init_state(self, p: torch.Tensor) -> dict:
        return {"z": p.detach().clone(), "nu": torch.zeros_like(p)}

    def _update(self, params, grads, lr) -> None:
        lr_base = warmup_lr(lr, self.warmup_steps, self.count - 1)
        self.max_lr = max(self.max_lr, warmup_lr(lr, self.warmup_steps, self.count))
        weight = self.max_lr**WEIGHT_LR_POWER
        self.weight_sum += weight
        ck = weight / self.weight_sum if self.weight_sum > 0 else 0.0
        b1, b2 = B1, B2
        bc = 1.0 - b2**self.count
        zs = [self.state[p]["z"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        # ν ← (1 − b2)·g² + b2·ν; u = g / (sqrt(ν / bc) + eps)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nus, bc)), EPS)
        z_new = torch._foreach_sub(zs, torch._foreach_mul(torch._foreach_div(grads, denom), lr_base))
        ys = [p.data for p in params]
        # x = (y − (1−b1)·z) / b1 ; x' = (1−c)·x + c·z' ; y' = b1·x' + (1−b1)·z'
        x = torch._foreach_div(torch._foreach_sub(ys, torch._foreach_mul(zs, 1.0 - b1)), b1)
        x = torch._foreach_add(torch._foreach_mul(x, 1.0 - ck), torch._foreach_mul(z_new, ck))
        y_new = torch._foreach_add(torch._foreach_mul(x, b1), torch._foreach_mul(z_new, 1.0 - b1))
        torch._foreach_add_(ys, torch._foreach_sub(y_new, ys))
        for z, zn in zip(zs, z_new):
            z.copy_(zn)

    @torch.no_grad()
    def eval_point(self, p: torch.Tensor) -> torch.Tensor:
        """The evaluation sequence x = (y − (1−b1)·z) / b1 for one param (the
        param itself when frozen)."""
        st = self.state.get(p)
        if st is None:
            return p.detach()
        b1 = torch.tensor(B1, dtype=torch.float32).item()  # b1 as the state stores it
        return (p.detach() - (1.0 - b1) * st["z"]) / b1


class AdamW(GuardedOptimizer):
    """``optax.adamw(lr)`` with optax's defaults inside the same chain
    (`GuardedOptimizer`): per applied step t, with the clipped gradients g,

        μ ← b1·μ + (1−b1)·g,   ν ← b2·ν + (1−b2)·g²
        p ← p − lr·(μ / (1 − b1^t) / (sqrt(ν / (1 − b2^t)) + eps) + wd·p)

    b1 0.9, b2 0.999, eps 1e-8, weight decay wd = `ADAMW_WEIGHT_DECAY` (1e-4,
    not ``torch.optim.AdamW``'s 1e-2) on every trainable leaf. Validation
    evaluates at the params themselves."""

    STATE = ("mu", "nu")

    def _update(self, params, grads, lr) -> None:
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, B1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - B1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2))
        mu_hat = torch._foreach_div(mus, 1.0 - B1**self.count)
        nu_hat = torch._foreach_div(nus, 1.0 - B2**self.count)
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS))
        ys = [p.data for p in params]
        u = torch._foreach_add(u, torch._foreach_mul(ys, ADAMW_WEIGHT_DECAY))
        torch._foreach_add_(ys, torch._foreach_mul(u, -lr))


OPTIMIZERS = {"schedule_free_adamw": ScheduleFreeAdamW, "adamw": AdamW}


def make_optimizer(
    params: dict,
    learning_rate: float = 1e-5,
    *,
    optimizer: str = "schedule_free_adamw",
    freeze_mask: dict | None = None,
    warmup_steps: int | None = None,
) -> GuardedOptimizer:
    """The JAX package's optimizer chain over the leaves of ``params``
    (`train/step.py:46-84` there): ``"schedule_free_adamw"`` (by default no
    warmup, the reference's torch ``AdamWScheduleFree`` default,
    `finetune_mmpfn_main.py:731`) or ``"adamw"`` (which takes no warmup)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: {optimizer}")
    flat = flatten_params(params)
    mask = flatten_params(freeze_mask) if freeze_mask is not None else {k: True for k in flat}
    groups = [
        {"params": [flat[k] for k in flat if mask[k]], "trainable": True},
        {"params": [flat[k] for k in flat if not mask[k]], "trainable": False},
    ]
    groups = [g for g in groups if g["params"]]
    if optimizer == "adamw":
        return AdamW(groups, learning_rate)
    return ScheduleFreeAdamW(groups, learning_rate, warmup_steps=warmup_steps)


def eval_params(state: TrainState) -> dict:
    """Schedule-free optimizers evaluate at the x-sequence, not at the params
    (the reference calls ``optimizer.eval()`` before every validation and
    save); AdamW at the params. New tensors; the params are untouched."""
    flat = flatten_params(state.params)
    return unflatten_params({k: state.optimizer.eval_point(v) for k, v in flat.items()})


def init_train_state(params: dict, optimizer_fn: Callable[[dict], GuardedOptimizer]) -> TrainState:
    """Leaves as float32 tensors that require grad, and their optimizer; a
    tensor-parallel shard stays marked as one."""
    flat = {k: mark_shard(v.detach().float().clone().requires_grad_(True), shard_axis(v))
            for k, v in flatten_params(params).items()}
    params = unflatten_params(flat)
    return TrainState(params=params, optimizer=optimizer_fn(params), step=0)


def make_train_step(cfg: ModelConfig, loss_fn: Callable, mesh: DeviceMesh | None = None):
    """The step: ``batch`` holds ``x_train (b, s_tr, F) | None``, ``y_train
    (b, s_tr)``, ``x_test | None``, ``y_test (b, s_te)``, optional
    ``image_train/image_test (b, s, N, D)`` and ``feat_pos_noise``, as
    tensors on the params' device, and ``mgm_active`` (an int: the active
    heads of a padded mixer). ``generator`` draws the mixers' dropout.
    Returns the state and ``{"loss", "grad_norm", "applied"}``: the loss and
    the global norm of ALL gradients (frozen ones included, `step.py:186` of
    the JAX package) as 0-d tensors, and whether the update was applied.

    With a ``mesh`` (`parallel.mesh.make_mesh`) the step runs under it: each
    ``dp`` rank takes its contiguous block of the batch's episodes
    (`parallel.mesh.local_batch`), and the gradients and the loss are
    averaged over ``dp`` before the norm and the optimizer, which gives the
    global-mean loss of the JAX step under GSPMD (every rank passes the same
    whole batch; a mixer's dropout draws from each rank's own generator).
    The state's params may be tensor-parallel shards over ``mp``
    (`parallel.mesh.shard_params` before `init_train_state`): each rank then
    steps its shards. ``cfg.seq_shard_axis`` rings over an axis of the
    ambient mesh; with a ``mesh`` it must not be ``dp``, which carries the
    episodes."""
    from multimodalpfn_tpu_torch.models.transformer import forward_train_test

    dp_group = None
    if mesh is not None:
        if cfg.seq_shard_axis == "dp":
            raise ValueError("make_train_step: seq_shard_axis='dp' would ring over the axis that "
                             "splits the episodes; ring over another axis of the mesh")
        if axis_size(mesh, "dp") > 1:
            dp_group = mesh.get_group("dp")

    def step_fn(state: TrainState, batch: dict, generator: torch.Generator | None):
        leaves = list(flatten_params(state.params).values())
        for p in leaves:
            p.grad = None
        with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            if mesh is not None:
                batch = local_batch(batch, mesh)
            with span("mmpfn.train.forward"):
                logits = forward_train_test(
                    state.params, cfg, batch.get("x_train"), batch["y_train"], batch.get("x_test"),
                    batch.get("image_train"), batch.get("image_test"),
                    train=True, generator=generator, feat_pos_noise=batch.get("feat_pos_noise"),
                    mgm_active=batch.get("mgm_active"),
                )
                loss = loss_fn(logits, batch["y_test"])
            with span("mmpfn.train.backward"):
                loss.backward()
                loss = loss.detach()
                if dp_group is not None:
                    loss = _dp_mean(leaves, loss, dp_group)
            with span("mmpfn.train.optimizer"):
                with torch.no_grad():
                    grad_norm = global_norm(full_grad(p) for p in leaves if p.grad is not None)
                applied = state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm, "applied": applied}

    return step_fn


@torch.no_grad()
def _dp_mean(leaves: list[torch.Tensor], loss: torch.Tensor, group) -> torch.Tensor:
    """Average the leaves' gradients and the loss over ``group`` in one
    all-reduce of a flat float32 buffer; returns the mean loss."""
    grads = [p.grad for p in leaves if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
    all_reduce_(flat, group).div_(dist.get_world_size(group))
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[off].to(loss.dtype)


# --- full-state checkpointing (params + optimizer state + step) --------------
# The reference saves weight snapshots only; the JAX package resumes an
# interrupted fine-tune exactly (`train/step.py:save_train_state`), and so
# does the port, from its own file format: one .npz of named arrays.

def train_state_arrays(state: TrainState) -> dict[str, torch.Tensor]:
    """Copies of every tensor and counter of ``state``, by name: the params
    (``params/<leaf>``), the optimizer's state of each trainable leaf
    (schedule-free: the base iterate and second moment, ``z/<leaf>``,
    ``nu/<leaf>``; AdamW: ``mu/<leaf>``, ``nu/<leaf>``), its counters and the
    step. The copies stay on the params' device, so a background writer can
    fetch them while training goes on."""
    out: dict[str, torch.Tensor] = {}
    opt = state.optimizer
    with torch.no_grad():
        for k, p in flatten_params(state.params).items():
            out[f"params/{k}"] = p.detach().clone()
            for name, t in opt.state.get(p, {}).items():
                out[f"{name}/{k}"] = t.clone()
    for name in opt.SCALARS:  # Python floats and ints, kept exactly
        v = getattr(opt, name)
        out[name] = torch.tensor(v, dtype=torch.float64 if isinstance(v, float) else torch.int64)
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    return out


def write_train_state(path, arrays: dict[str, torch.Tensor]) -> None:
    """Write `train_state_arrays` to ``path`` (an ``.npz``)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in arrays.items()})


def save_train_state(path, state: TrainState) -> None:
    """Params, optimizer state and step of ``state`` in one ``.npz``
    (the JAX package's `save_train_state`)."""
    write_train_state(path, train_state_arrays(state))


def restore_train_state(path, template: TrainState) -> TrainState:
    """Restore into a freshly initialized state of the same params and
    optimizer (the JAX package's `restore_train_state`): the tensors are
    overwritten in place, bit for bit, on their own devices. Raises
    ValueError when the file's leaves are not the template's."""
    opt = template.optimizer
    flat = flatten_params(template.params)
    with np.load(path) as data:
        expected = {f"params/{k}" for k in flat} | set(opt.SCALARS) | {"step"}
        expected |= {f"{n}/{k}" for k, p in flat.items() for n in opt.state.get(p, {})}
        if set(data.files) != expected:
            raise ValueError(f"{path}: the checkpoint's leaves are not the optimizer's "
                             f"(missing {sorted(expected - set(data.files))[:4]}, "
                             f"extra {sorted(set(data.files) - expected)[:4]})")

        def put(dst: torch.Tensor, name: str) -> None:
            src = torch.from_numpy(data[name])
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{path}: {name} is {src.dtype} {tuple(src.shape)}, expected "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)

        with torch.no_grad():
            for k, p in flat.items():
                put(p, f"params/{k}")
                for name, t in opt.state.get(p, {}).items():
                    put(t, f"{name}/{k}")
        for name in opt.SCALARS:
            setattr(opt, name, type(getattr(opt, name))(data[name].item()))
        template.step = int(data["step"].item())
    return template
