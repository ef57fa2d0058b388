"""Batched multi-run fine-tuning: many independent runs in one sweep.

The reference runs its 5-seeds-per-grid-cell protocol as sequential processes
(`run.py:39-129`); the JAX package's `train/finetune_batch.py` makes the runs
a leading ``vmap`` axis of one compiled step. Here every run keeps its own
`TrainState` (params, optimizer, step), and each sweep step advances every
run by one step in run order through `train.step.make_train_step`: a run's
backward ends before the next run's forward begins, so one run's activations
are alive at a time, and each run clips its own gradients and skips its own
non-finite steps, as under ``vmap``. On the card the steps run bf16 compute
through the hand-written kernels (one launch per layer and run; a run axis in
the kernels' grid is ROADMAP queue 2 work).

Two granularities, as in the JAX package:

  * `fine_tune_batched` — the seeds of ONE grid cell (same mgm/cap heads).
  * `fine_tune_batched_cells` — cells with different ``mgm_heads`` in one
    sweep: each run's mixer is drawn at its cell's true head count, then
    zero-padded to the group's largest (`models.params.pad_mixer_params`),
    and the forward activates the run's prefix (``mgm_active``): inactive
    heads are masked exactly and get zero gradients, so each run computes
    what its unpadded cell would. ``cap_heads`` sets the CAP head split and
    is never padded: a group shares it.

Episodes are gathered on the device: each run's train split stays resident
(the rows its validation forward reads too) and each step uploads only that
step's fold indices. Validation logits stay on the device and are scored
after the loop (no early stopping; the best error is the minimum of the
history).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from multimodalpfn_tpu_torch.estimator.base import initialize_model, resolve_device
from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution
from multimodalpfn_tpu_torch.models.config import MixerConfig
from multimodalpfn_tpu_torch.models.params import (
    Params,
    flatten_params,
    get_subspace_noise,
    init_mixer_params,
    pad_mixer_params,
    params_to,
    slice_mixer_params,
    unflatten_params,
)
from multimodalpfn_tpu_torch.models.transformer import forward_train_test
from multimodalpfn_tpu_torch.parallel.mesh import all_gather_cat, all_reduce_, axis_size
from multimodalpfn_tpu_torch.train.data import EpisodeSampler
from multimodalpfn_tpu_torch.train.finetune import _canon_task, first_layers
from multimodalpfn_tpu_torch.train.losses import get_loss_fn
from multimodalpfn_tpu_torch.train.metrics import get_scorer
from multimodalpfn_tpu_torch.train.step import (
    TrainState,
    eval_params,
    frozen_input_mask,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from multimodalpfn_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def sweep_needs_token_mask(mixer_on: bool, padded: bool, mixer_type: str) -> bool:
    """Whether a batched group's forward masks image tokens out of feature
    attention. Only padded MGM and MoE mixers change the token count with
    ``mgm_heads``; MGM+CAP emits ``cap_heads`` tokens for every run, so the
    reference's grid (mgm 2..256 × shared cap, `configs/pad_ufes_20.yaml`)
    runs the kernels' item-major path unmasked."""
    return mixer_on and padded and mixer_type in ("MGM", "MoE")


def init_run_mixer(seed: int, mixer_cfg: MixerConfig, emsize: int, device) -> Params:
    """One run's fresh mixer at its cell's true head count, drawn from a CPU
    ``torch.Generator`` seeded with the run's seed, then moved to
    ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    return params_to(init_mixer_params(gen, mixer_cfg, emsize), device)


def fine_tune_batched(
    *,
    mixer_type: str,
    mgm_heads: int,
    cap_heads: int,
    features_per_group: int,
    path_to_base_model: str = "auto",
    task_type: str = "multiclass",
    X: np.ndarray | None,
    image: np.ndarray | None,
    y: np.ndarray,
    seeds: list[int],
    finetuning_config: dict[str, Any] | None = None,
    validation_metric: str = "log_loss",
    freeze_input: bool = True,
    val_fraction: float = 0.2,
    time_limit: float = 3600,
    mesh=None,
    run_splits: list[tuple[np.ndarray, np.ndarray]] | None = None,
    device: str | torch.device = "cuda",
    **kw,
) -> dict[str, Any]:
    """Fine-tune ``len(seeds)`` independent runs of ONE grid cell in one
    sweep (`fine_tune_batched_cells` with one cell)."""
    cell = {"mgm_heads": mgm_heads, "cap_heads": cap_heads, "seeds": list(seeds)}
    if run_splits is not None:
        cell["run_splits"] = run_splits
    return fine_tune_batched_cells(
        cells=[cell], mixer_type=mixer_type, features_per_group=features_per_group,
        path_to_base_model=path_to_base_model, task_type=task_type, X=X, image=image, y=y,
        finetuning_config=finetuning_config, validation_metric=validation_metric,
        freeze_input=freeze_input, val_fraction=val_fraction, time_limit=time_limit, mesh=mesh,
        device=device, **kw,
    )


@dataclasses.dataclass
class _Run:
    """One run of a sweep: its state, episode stream, dropout generator,
    resident rows and padded-mixer extras."""

    state: TrainState
    sampler: EpisodeSampler
    generator: torch.Generator
    data: dict[str, torch.Tensor | None]  # x, image, y of the train split; x_val, image_val
    extras: dict[str, Any]  # mgm_active, feat_pos_noise

    def batch(self, tr: torch.Tensor, te: torch.Tensor) -> dict:
        """The episode of fold indices ``tr``, ``te`` (on the device),
        gathered on the device from the train split."""
        tr, te = tr[None], te[None]
        y = self.data["y"]
        out = {"y_train": y[tr], "y_test": y[te], **self.extras}
        for key in ("x", "image"):
            if self.data[key] is not None:
                out[f"{key}_train"], out[f"{key}_test"] = self.data[key][tr], self.data[key][te]
        return out


def fine_tune_batched_cells(
    *,
    cells: list[dict[str, Any]],
    mixer_type: str,
    features_per_group: int,
    path_to_base_model: str = "auto",
    task_type: str = "multiclass",
    X: np.ndarray | None,
    image: np.ndarray | None,
    y: np.ndarray,
    finetuning_config: dict[str, Any] | None = None,
    validation_metric: str = "log_loss",
    freeze_input: bool = True,
    val_fraction: float = 0.2,
    time_limit: float = 3600,
    mesh=None,
    static_seed: int | None = None,
    device: str | torch.device = "cuda",
    compute_dtype: str | None = None,
    cfg_override: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Fine-tune cells × seeds independent runs in one sweep (the JAX
    package's `fine_tune_batched_cells`, `finetune_batch.py:101-456`).

    ``cells``: each ``{"mgm_heads", "cap_heads", "seeds", ["run_splits"]}``.
    Every run r has its own mixer init (at its cell's true head count, then
    padded), its own train/val split (an 80/20 permutation of
    ``default_rng(seed)``, or the cell's ``run_splits``) and its own episode
    stream; all runs share split sizes. ``finetuning_config`` takes
    ``learning_rate`` (1e-5), ``max_steps`` (100),
    ``validate_every_n_steps`` (1), ``optimizer`` (``"schedule_free_adamw"``
    or ``"adamw"``) and ``warmup_steps``. On the card (``device``) the runs
    train in bf16 with the kernels on, except that padded MGM/MoE groups run
    feature attention and the MLP plain (`sweep_needs_token_mask`); on the CPU
    in float32 on the plain path. ``compute_dtype`` and ``cfg_override``
    (config fields, e.g. ``nlayers`` to keep the first layers) replace that
    choice. ``mesh`` (`parallel.mesh.make_mesh`): the runs are placed over
    its ``dp`` axis in contiguous blocks (the JAX package's ``P("dp")`` on
    the run axis; ``dp`` must divide the run count), each rank trains its
    block with the seeds, split, subspace noise and dropout generator the
    run has in one process, and the history and final params are gathered,
    so every rank returns what one process returns (``step_seconds``: the
    slowest rank's).

    Returns ``history`` (``train_loss`` per step and run, ``val_error`` as
    (step, per-run errors), ``best_val_error`` per run, ``skipped_steps`` per
    run, ``step_seconds`` per sweep step on the host clock (every run's step
    and validation, ended by a device synchronize), ``wall_s``), the final
    evaluation params stacked on a leading run axis (``params_stacked``), the
    ``config``, the ``splits``, the ``criterion_borders``, the
    ``run_cells`` ((cell index, seed) per run) and the ``run_mixer_cfgs``;
    `extract_run_params` recovers a run's checkpoint at its cell's shape."""
    st = time.time()
    device = resolve_device(device)
    on_card = device.type == "cuda"
    task = _canon_task(task_type)
    is_clf = task != "regression"
    hps = {
        "learning_rate": 1e-5,
        "max_steps": 100,
        "validate_every_n_steps": 1,
        "optimizer": "schedule_free_adamw",
        "warmup_steps": None,
        **(finetuning_config or {}),
    }

    # ---- flatten runs; the padded group shape
    run_cells = [(ci, int(s)) for ci, c in enumerate(cells) for s in c["seeds"]]
    mgm_max = max(int(c["mgm_heads"]) for c in cells)
    caps = {int(c["cap_heads"]) for c in cells}
    if mixer_type == "MGM+CAP" and image is not None and len(caps) != 1:
        raise ValueError(
            f"cap_heads must be shared across a batched group (got {sorted(caps)}):"
            " it sets the CAP attention head split and cannot be padded"
        )
    cap_heads = int(cells[0]["cap_heads"])
    padded = len({int(c["mgm_heads"]) for c in cells}) > 1
    if static_seed is None:
        static_seed = run_cells[0][1]

    loaded = initialize_model(
        model_path=path_to_base_model,
        which="classifier" if is_clf else "regressor",
        static_seed=int(static_seed),
        mixer_type=mixer_type if image is not None else "none",
        mgm_heads=mgm_max,
        cap_heads=cap_heads,
        features_per_group=features_per_group,
        device=device,
    )
    mixer_on = image is not None and mixer_type != "none"
    # the group's mixer shape, whatever mixer a saved model holds
    mixer = dataclasses.replace(loaded.config.mixer, mixer_type=mixer_type if image is not None else "none",
                                mgm_heads=mgm_max, cap_heads=cap_heads)
    cfg = dataclasses.replace(
        loaded.config,
        mixer=mixer,
        compute_dtype=compute_dtype or ("bfloat16" if on_card else "float32"),
        use_flash=on_card,
        fused_ops=on_card and not sweep_needs_token_mask(mixer_on, padded, mixer_type),
    )
    cfg = dataclasses.replace(cfg, **(cfg_override or {}))
    base = first_layers(loaded.params, cfg.nlayers)

    # ---- per-run (train, val) index splits of one size
    splits: list[tuple[np.ndarray, np.ndarray]] = []
    for ci, s in run_cells:
        cell_splits = cells[ci].get("run_splits")
        if cell_splits is not None:
            tr, va = cell_splits[cells[ci]["seeds"].index(s)]
            splits.append((np.asarray(tr), np.asarray(va)))
        else:
            n_val = int(round(len(y) * val_fraction))
            perm = np.random.default_rng(int(s)).permutation(len(y))
            splits.append((perm[n_val:], perm[:n_val]))
    if len({(len(tr), len(va)) for tr, va in splits}) != 1:
        raise ValueError("all runs must share split sizes")

    run_mixer_cfgs = [
        dataclasses.replace(cfg.mixer, mgm_heads=int(cells[ci]["mgm_heads"]), cap_heads=cap_heads)
        for ci, _ in run_cells
    ]
    mine = _rank_runs(len(run_cells), mesh)  # the global indices of this rank's runs
    borders = None
    if task == "regression":
        borders = np.asarray(loaded.criterion_borders, np.float32)
    train_step = make_train_step(cfg, get_loss_fn(task, borders))
    scorer = get_scorer(validation_metric)

    runs: list[_Run] = []
    for r, data in zip(mine, _stack_val(X, image, y, [splits[r] for r in mine], device)):
        (ci, s), (tr, va), mc = run_cells[r], splits[r], run_mixer_cfgs[r]
        params = dict(base)
        extras: dict[str, Any] = {}
        if mixer_on:
            params["mixer"] = pad_mixer_params(init_run_mixer(s, mc, cfg.emsize, device), cfg.mixer)
        if mixer_on and padded:
            extras["mgm_active"] = mc.mgm_heads
            if mixer_type != "MGM+CAP" and cfg.feature_positional_embedding == "subspace":
                # MGM/MoE token counts follow mgm_heads and torch's noise draws
                # are not prefix-stable: each run carries its own table
                per_img = image.shape[1] if mixer_type == "MGM" and image.ndim == 3 else 1
                f_tab = 0 if X is None else -(-X.shape[-1] // features_per_group)
                n_act, n_pad = mc.mgm_heads * per_img, mgm_max * per_img
                tab = get_subspace_noise(cfg.model_seed, f_tab + n_act, cfg.emsize // 4)
                tab = torch.cat([tab, tab.new_zeros((n_pad - n_act, tab.shape[1]))])
                extras["feat_pos_noise"] = tab[None].to(device)
        state = init_train_state(params, lambda p: make_optimizer(
            p, hps["learning_rate"], optimizer=hps["optimizer"], warmup_steps=hps["warmup_steps"],
            freeze_mask=frozen_input_mask(p, freeze_input)))
        sampler = EpisodeSampler(X=None if X is None else np.asarray(X)[tr],
                                 image=None if image is None else np.asarray(image)[tr],
                                 y=np.asarray(y)[tr], is_classification=is_clf, seed=4213 + s)
        generator = torch.Generator(device=device)
        generator.manual_seed(s)
        runs.append(_Run(state, sampler, generator, data, extras))

    @torch.no_grad()
    def val_logits(run: _Run, params: dict) -> torch.Tensor:
        d = run.data
        nb = (lambda t: None if t is None else t[None])
        return forward_train_test(
            params, cfg, nb(d["x"]), d["y"][None], nb(d["x_val"]), nb(d["image"]), nb(d["image_val"]),
            mgm_active=run.extras.get("mgm_active"), feat_pos_noise=run.extras.get("feat_pos_noise"),
        )[0]

    def sync():
        if on_card:
            with span("mmpfn.sync.step"):
                torch.cuda.synchronize(device)

    # the loop keeps losses and validation logits on the device; nothing in
    # it needs a device value
    n_classes = int(np.max(y)) + 1 if is_clf else None
    loss_hist: list[torch.Tensor] = []
    val_hist: list[tuple[int, list[torch.Tensor]]] = [(0, [val_logits(r, r.state.params) for r in runs])]
    step_seconds: list[float] = []
    sync()
    for step_i in range(1, int(hps["max_steps"]) + 1):
        if _any_rank(time.time() - st > time_limit, mesh, device):
            logger.info("time limit reached at step %d", step_i)
            break
        t0 = time.time()
        with span("mmpfn.train.sweep_step"):
            idx_tr, idx_te = _stack_batches([r.sampler for r in runs], device)
            losses = []
            for run, tr, te in zip(runs, idx_tr, idx_te):
                run.state, metrics = train_step(run.state, run.batch(tr, te), run.generator)
                losses.append(metrics["loss"])
            loss_hist.append(torch.stack(losses))
            if step_i % int(hps["validate_every_n_steps"]) == 0:
                val_hist.append((step_i, [val_logits(r, eval_params(r.state)) for r in runs]))
            sync()
        step_seconds.append(time.time() - t0)

    bardist = FullSupportBarDistribution(borders) if task == "regression" else None

    def score(r: int, logits: torch.Tensor) -> float:
        """Run ``r``'s (a global index) validation error from its logits."""
        # classification: softmax, cut to the classes of ``y``, renormalised;
        # regression: the bar distribution's mean (float32)
        va = splits[r][1]
        with span("mmpfn.sync.validation"):
            lo = logits.float().cpu()
        if bardist is not None:
            pred = bardist.mean(lo).numpy()
        else:
            lo = lo.numpy()
            z = lo - lo.max(-1, keepdims=True)
            pred = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
            pred = pred[:, :n_classes]
            pred = pred / pred.sum(-1, keepdims=True)
        return scorer.convert_score_to_error(scorer(np.asarray(y)[va], pred))

    p_final = [eval_params(r.state) for r in runs]
    flat = [flatten_params(p) for p in p_final]
    stacked = {k: torch.stack([f[k] for f in flat]) for k in flat[0]}
    losses = torch.stack(loss_hist) if loss_hist else None  # (steps, local runs)
    val_error = [(si, [score(r, lg) for r, lg in zip(mine, lgs)]) for si, lgs in val_hist]
    skipped = [r.state.optimizer.total_notfinite for r in runs]
    if mesh is not None and axis_size(mesh, "dp") > 1:
        group = mesh.get_group("dp")
        stacked = {k: all_gather_cat(v, group, 0) for k, v in stacked.items()}
        losses = None if losses is None else all_gather_cat(losses, group, 1)
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, (val_error, skipped, step_seconds), group=group)
        val_error = [(si, [e for part in parts for e in part[0][i][1]]) for i, (si, _) in enumerate(val_error)]
        skipped = [n for part in parts for n in part[1]]
        step_seconds = [max(ts) for ts in zip(*(part[2] for part in parts))]
    params_stacked = unflatten_params(stacked)
    history: dict[str, Any] = {
        "train_loss": losses.cpu().tolist() if losses is not None else [],
        "val_error": val_error,
        "skipped_steps": skipped,
        "step_seconds": step_seconds,
    }
    history["best_val_error"] = np.min(np.asarray([e for _, e in history["val_error"]]), axis=0).tolist()
    history["wall_s"] = time.time() - st
    return {
        "history": history,
        "params_stacked": params_stacked,
        "config": cfg,
        "splits": splits,
        "criterion_borders": loaded.criterion_borders,
        "run_cells": run_cells,
        "run_mixer_cfgs": run_mixer_cfgs if mixer_on else None,
    }


def _rank_runs(n_runs: int, mesh) -> list[int]:
    """The runs this rank trains: all of them without a mesh, else its
    ``dp`` rank's contiguous block."""
    if mesh is None:
        return list(range(n_runs))
    n, r = axis_size(mesh, "dp"), mesh.get_local_rank("dp")
    if n_runs % n:
        raise ValueError(f"the sweep's {n_runs} runs do not divide over the {n} ranks of axis 'dp'")
    m = n_runs // n
    return list(range(r * m, (r + 1) * m))


def _any_rank(flag: bool, mesh, device) -> bool:
    """``flag`` on any ``dp`` rank (every rank stops at the same step)."""
    if mesh is None or axis_size(mesh, "dp") == 1:
        return flag
    with span("mmpfn.sync.upload"):
        t = torch.tensor([float(flag)], device=device)
    with span("mmpfn.sync.stop"):
        return bool(all_reduce_(t, mesh.get_group("dp"), dist.ReduceOp.MAX).item())


def extract_run_params(result: dict[str, Any], r: int) -> tuple[dict, Any]:
    """Run r's final params at its cell's true mixer shape, and the matching
    ModelConfig, ready for `models.loading.save_model`."""
    params_r = unflatten_params({k: v[r] for k, v in flatten_params(result["params_stacked"]).items()})
    cfg = result["config"]
    mixer_cfgs = result.get("run_mixer_cfgs")
    if mixer_cfgs is not None and "mixer" in params_r:
        params_r["mixer"] = slice_mixer_params(params_r["mixer"], mixer_cfgs[r])
        cfg = dataclasses.replace(cfg, mixer=mixer_cfgs[r])
    return params_r, cfg


def _stack_val(X, image, y, splits, device) -> list[dict[str, torch.Tensor | None]]:
    """Each run's resident rows on the device, float32: ``x``, ``image``,
    ``y`` of its train split (the episodes' source and the validation's
    context) and ``x_val``, ``image_val`` of its validation split."""

    def dev(a, idx):
        return None if a is None else torch.as_tensor(np.asarray(a)[idx].astype(np.float32), device=device)

    return [{"x": dev(X, tr), "image": dev(image, tr), "y": dev(y, tr),
             "x_val": dev(X, va), "image_val": dev(image, va)} for tr, va in splits]


def _stack_batches(samplers: list[EpisodeSampler], device) -> tuple[torch.Tensor, torch.Tensor]:
    """The next fold of every run: train and test indices ``(runs, n)``,
    uploaded to the device in one blocking copy each (``mmpfn.sync.upload``)."""
    eps = [s.episode_indices() for s in samplers]
    out = []
    for i in (0, 1):
        idx = np.stack([e[i] for e in eps])
        with span("mmpfn.sync.upload"):
            out.append(torch.as_tensor(idx, device=device))
    return tuple(out)
