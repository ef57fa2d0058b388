"""Episode fine-tuning.

API and protocol: reference `scripts_finetune_mm/finetune_mmpfn_main.py:78-486`
(`fine_tune_mmpfn`) as the JAX package's `multimodalpfn_tpu/train/finetune.py`
runs it: load the base checkpoint, optionally freeze the input encoders, split
off 20 % of the rows for validation (stratified for classification), validate
the initial model,
then up to ``max_steps`` steps of one K-fold episode each with clipped
schedule-free AdamW; after every update, validate at the schedule-free
evaluation point and keep the best-by-validation snapshot, written in the
reference torch format (`models.loading.save_model`) so the port's
`MMPFNClassifier` serves it. With ``task_type="regression"`` the base model is
a regressor: the loss is its bar distribution's NLL on the raw targets (not
standardized, as in the JAX package's `finetune.py:329-337`), validation
scores the bar distribution's mean, and the snapshot keeps the borders
(``criterion.borders``), so `MMPFNRegressor` serves it.

On the card the step runs bf16 compute with float32 master weights, and the
encoder layers run the hand-written kernels forward (K1, K2a + K2b, K3) and
backward (K7, K10 + K9, K8); a model whose item attention the K2 gate refuses
(a checkpoint without the multiquery test block, or ``fused_item`` off) runs
K4 forward and K11 backward in both item blocks instead. Validation is the
inference forward.

``resume`` continues an interrupted fine-tune exactly, as the JAX package
does: every ``state_checkpoint_every`` steps the params, the optimizer state
and the step go to ``<save path>.state.npz`` (`train/step.py`), written by a
background thread before that step runs; a resumed call restores them and
goes on from the step after. Like the JAX package's, the episode sampler and
the dropout generator restart from their seeds. The JAX package's
XLA-specific parts (compile effort, program cache, prewarm thread, remat
threshold) have no counterpart, nor has its orbax snapshot of the final
state: the port's snapshot is the reference-format best one, which
`MMPFNClassifier` serves.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from multimodalpfn_tpu_torch.estimator.base import initialize_model, resolve_device
from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution
from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.loading import LoadedModel, save_model
from multimodalpfn_tpu_torch.models.params import flatten_params, unflatten_params
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.train.data import (
    EpisodeSampler,
    stratified_train_test_split,
    train_test_split_indices,
)
from multimodalpfn_tpu_torch.train.early_stopping import AdaptiveES
from multimodalpfn_tpu_torch.train.losses import get_loss_fn
from multimodalpfn_tpu_torch.train.metrics import get_scorer
from multimodalpfn_tpu_torch.train.snapshots import AsyncSnapshotWriter
from multimodalpfn_tpu_torch.train.step import (
    TrainState,
    eval_params,
    frozen_input_mask,
    init_train_state,
    make_optimizer,
    make_train_step,
    restore_train_state,
    train_state_arrays,
    write_train_state,
)

logger = logging.getLogger(__name__)


def _canon_task(task_type: str) -> str:
    t = task_type.lower()
    if t in ("multiclass", "multiclass_classification"):
        return "multiclass"
    if t in ("binary", "binary_classification"):
        return "binary"
    if t == "regression":
        return "regression"
    raise ValueError(f"Unknown task_type {task_type}")


def create_val_data(*, X, image, y, rng, is_classification):
    """Size-dependent validation split (reference `validation_utils.py:17-88`):
    ``train_test_split(..., random_state=rng, stratify=y if
    is_classification else None)`` as the JAX package calls it, drawn by the
    numpy copies of scikit-learn's splitters."""
    n = len(y)
    test_size = 0.2 if n < 500_000 else (0.1 if n < 1_000_000 else 0.05)
    if is_classification:
        tr, va = stratified_train_test_split(y, test_size, rng)
    else:
        tr, va = train_test_split_indices(n, test_size, rng)

    def take(a):
        return (None, None) if a is None else (np.asarray(a)[tr], np.asarray(a)[va])

    (X_tr, X_va), (im_tr, im_va) = take(X), take(image)
    y = np.asarray(y)
    return X_tr, X_va, im_tr, im_va, y[tr], y[va]


def first_layers(params: dict, nlayers: int) -> dict:
    """``params`` with its first ``nlayers`` encoder layers (all of them when
    it has no more)."""
    return {**params, "layers": {k: {n: w[:nlayers] for n, w in v.items()}
                                 for k, v in params["layers"].items()}}


def _copy_params(params: dict) -> dict:
    return unflatten_params({k: v.detach().clone() for k, v in flatten_params(params).items()})


@dataclasses.dataclass
class EpisodeTrainer:
    """The fine-tune's step loop, assembled once: the train state, the step
    function, the episode stream over the train split (whose rows live on the
    device) and the dropout generator. `fine_tune_mmpfn` runs it between its
    validations."""

    loaded: LoadedModel  # the base model: its config and checkpoint config are saved
    cfg: ModelConfig  # the training config (compute dtype, kernels, depth)
    state: TrainState
    train_step: Callable
    sampler: EpisodeSampler
    generator: torch.Generator
    data: dict[str, torch.Tensor | None]  # "x", "image", "y" of the train split on the device

    def next_batch(self, n_episodes: int = 1) -> dict:
        """The next ``n_episodes`` episodes, gathered on the device."""
        eps = [self.sampler.episode_indices() for _ in range(n_episodes)]
        y = self.data["y"]
        idx_tr = torch.as_tensor(np.stack([e[0] for e in eps]), device=y.device)
        idx_te = torch.as_tensor(np.stack([e[1] for e in eps]), device=y.device)
        batch = {"y_train": y[idx_tr], "y_test": y[idx_te]}
        for key in ("x", "image"):
            if self.data[key] is not None:
                batch[f"{key}_train"], batch[f"{key}_test"] = self.data[key][idx_tr], self.data[key][idx_te]
        return batch

    def step(self, n_episodes: int = 1) -> dict:
        """One training step on the next episodes; returns its metrics."""
        self.state, metrics = self.train_step(self.state, self.next_batch(n_episodes), self.generator)
        return metrics


def make_episode_trainer(
    *,
    path_to_base_model: str | Path,
    mixer_type: str,
    mgm_heads: int,
    cap_heads: int,
    features_per_group: int,
    X_train: np.ndarray | None,
    image_train: np.ndarray | None,
    y_train: np.ndarray,
    task: str = "multiclass",
    device: str | torch.device = "cuda",
    random_seed: int = 42,
    learning_rate: float = 1e-5,
    optimizer: str = "schedule_free_adamw",
    warmup_steps: int | None = None,
    freeze_input: bool = False,
    compute_dtype: str | None = None,
    cfg_override: dict[str, Any] | None = None,
    phase_seconds: dict[str, float] | None = None,
) -> EpisodeTrainer:
    """Load the base model and assemble the step loop over the train split.
    On the card the step runs bf16 compute and the kernels forward and
    backward, as the JAX package turns on its fused Pallas ops on an
    accelerator (`finetune.py:310-317`). ``cfg_override`` replaces config
    fields after that (an ``nlayers`` below the checkpoint's keeps its first
    layers). ``phase_seconds`` gets ``model_init`` and ``optimizer_setup``.
    A "regression" ``task`` loads a regressor and trains on its borders.
    ``optimizer`` and ``warmup_steps`` choose the update (`train.step.make_optimizer`)."""
    device = resolve_device(device)
    phase_seconds = {} if phase_seconds is None else phase_seconds
    t_phase = time.time()
    regression = task == "regression"
    loaded = initialize_model(
        model_path=path_to_base_model,
        which="regressor" if regression else "classifier",
        static_seed=random_seed,
        mixer_type=mixer_type if image_train is not None else "none",
        mgm_heads=mgm_heads,
        cap_heads=cap_heads,
        features_per_group=features_per_group,
        device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phase_seconds["model_init"] = time.time() - t_phase
    on_card = device.type == "cuda"
    if compute_dtype is None:
        compute_dtype = "bfloat16" if on_card else "float32"
    cfg = dataclasses.replace(
        loaded.config, compute_dtype=compute_dtype, use_flash=on_card, fused_ops=on_card,
    )
    cfg = dataclasses.replace(cfg, **(cfg_override or {}))
    params = first_layers(loaded.params, cfg.nlayers)
    n_params = sum(int(p.numel()) for p in flatten_params(params).values())
    logger.info("fine-tuning %s params", f"{n_params:,}")

    t_phase = time.time()
    state = init_train_state(
        params,
        lambda p: make_optimizer(p, learning_rate, optimizer=optimizer, warmup_steps=warmup_steps,
                                 freeze_mask=frozen_input_mask(p, freeze_input)),
    )
    if regression and loaded.criterion_borders is None:
        raise ValueError(f"{path_to_base_model!r} is not a regression model: it has no borders")
    train_step = make_train_step(cfg, get_loss_fn(task, loaded.criterion_borders))
    phase_seconds["optimizer_setup"] = time.time() - t_phase

    y_train = np.asarray(y_train, dtype=np.float32)
    sampler = EpisodeSampler(X=X_train, image=image_train, y=y_train, is_classification=not regression)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(random_seed))
    data = {k: None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=device)
            for k, a in (("x", X_train), ("image", image_train), ("y", y_train))}
    return EpisodeTrainer(loaded, cfg, state, train_step, sampler, generator, data)


def fine_tune_mmpfn(
    *,
    mixer_type: str,
    mgm_heads: int,
    cap_heads: int,
    features_per_group: int,
    save_path_to_fine_tuned_model: str | Path,
    path_to_base_model: str | Path = "auto",
    time_limit: int = 3600,
    finetuning_config: dict[str, Any] | None = None,
    validation_metric: str = "log_loss",
    categorical_features_index=None,  # accepted for API parity; encoders run on the device
    task_type: str = "multiclass",
    device: str | torch.device = "cuda",
    y_train: np.ndarray = None,
    X_train: np.ndarray | None = None,
    image_train: np.ndarray | None = None,
    X_val: np.ndarray | None = None,
    y_val: np.ndarray | None = None,
    image_val: np.ndarray | None = None,
    random_seed: int = 42,
    logger_level: int = 20,
    freeze_input: bool = False,
    episode_batch_size: int = 1,
    use_early_stopping: bool = False,
    compute_dtype: str | None = None,
    resume: bool = False,
    state_checkpoint_every: int = 25,
) -> dict[str, Any]:
    """Fine-tune and save the best-by-validation snapshot.
    ``finetuning_config`` takes ``learning_rate``, ``max_steps``,
    ``validate_every_n_steps``, ``optimizer`` (``"schedule_free_adamw"`` or
    ``"adamw"``), ``warmup_steps`` (schedule-free only) and the early
    stopping's ``adaptive_rate``, ``adaptive_offset``, ``min_patience`` and
    ``max_patience``. Returns the JAX package's history: ``train_loss``, ``grad_norm``, ``val_error`` (step,
    error), ``best_val_error``, ``steps``, ``step_seconds``, ``wall_s``,
    ``phase_seconds``, and ``skipped_steps``, the updates the non-finite
    guard skipped. Runs on the card unless ``device="cpu"``; without CUDA it
    raises. With ``resume`` and a state file from an earlier call, training
    continues from the step after the saved one (module docstring);
    ``state_checkpoint_every=0`` writes no state."""
    logger.setLevel(logger_level)
    st_time = time.time()
    device = resolve_device(device)
    phase_seconds: dict[str, float] = {}
    task = _canon_task(task_type)
    is_classification = task != "regression"
    cfg_hp = {
        "learning_rate": 1e-5,
        "max_steps": 100,
        "validate_every_n_steps": 1,
        "optimizer": "schedule_free_adamw",
        "adaptive_rate": 0.2,
        "adaptive_offset": 5,
        "min_patience": 50,
        "max_patience": 100,
        **(finetuning_config or {}),
    }

    # ---- validation split (unless provided)
    rng = np.random.RandomState(random_seed)
    if X_val is None and y_val is None:
        X_train, X_val, image_train, image_val, y_train, y_val = create_val_data(
            X=X_train, image=image_train, y=y_train, rng=rng, is_classification=is_classification,
        )
    y_val = np.asarray(y_val, dtype=np.float32)
    scorer = get_scorer(validation_metric)

    # ---- model, optimizer, step and the episode stream
    trainer = make_episode_trainer(
        path_to_base_model=path_to_base_model, mixer_type=mixer_type, mgm_heads=mgm_heads,
        cap_heads=cap_heads, features_per_group=features_per_group, X_train=X_train,
        image_train=image_train, y_train=y_train, task=task, device=device,
        random_seed=random_seed, learning_rate=cfg_hp["learning_rate"],
        optimizer=cfg_hp["optimizer"], warmup_steps=cfg_hp.get("warmup_steps"),
        freeze_input=freeze_input, compute_dtype=compute_dtype,
        phase_seconds=phase_seconds,
    )
    cfg, loaded = trainer.cfg, trainer.loaded

    # exact resume (params + optimizer state + step), as the JAX package's
    state_path = Path(str(save_path_to_fine_tuned_model) + ".state.npz")
    start_step = 0
    if resume and state_path.exists():
        restore_train_state(state_path, trainer.state)
        start_step = trainer.state.step
        logger.info("resumed fine-tuning at step %d", start_step)
    x_tr, i_tr, y_tr = trainer.data["x"], trainer.data["image"], trainer.data["y"]
    n_tr = len(y_tr)

    # ---- the validation rows on the device, once
    def dev(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=device)

    x_va, i_va = dev(X_val), dev(image_val)

    def validation_logits(p) -> np.ndarray:
        x = None if x_tr is None else torch.cat([x_tr, x_va])[None]
        img = None if i_tr is None else torch.cat([i_tr, i_va])[None]
        logits = forward(p, cfg, x, y_tr[None], img, single_eval_pos=n_tr)
        return logits[0].float().cpu().numpy()

    if is_classification:
        n_classes = int(y_tr.max()) + 1
    else:
        bardist = FullSupportBarDistribution(np.asarray(loaded.criterion_borders, np.float32))

    def score_val_logits(logits: np.ndarray) -> float:
        """Classification: softmax, cut to the classes seen in training,
        renormalized; regression: the bar distribution's mean, float32
        (`finetune.py:415-432` of the JAX package)."""
        if not is_classification:
            y_pred = bardist.mean(torch.from_numpy(logits)).numpy()
            return scorer.convert_score_to_error(scorer(y_val, y_pred))
        z = logits - logits.max(axis=-1, keepdims=True)
        y_pred = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
        y_pred = y_pred[:, :n_classes]
        y_pred = y_pred / y_pred.sum(axis=-1, keepdims=True)
        return scorer.convert_score_to_error(scorer(y_val, y_pred))

    save_path = Path(save_path_to_fine_tuned_model)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    snap_writer = AsyncSnapshotWriter(
        lambda p: save_model(save_path, p, loaded.config, ckpt_config=loaded.ckpt_config,
                             criterion_borders=loaded.criterion_borders)
    )
    state_writer = AsyncSnapshotWriter(lambda arrays: write_train_state(state_path, arrays))
    validate_inline = int(cfg_hp["validate_every_n_steps"]) == 1
    will_train = int(cfg_hp["max_steps"]) > start_step

    # ---- initial validation + snapshot (reference `finetune_mmpfn_main.py:321,352`);
    # with validation every step the JAX package validates the initial
    # state at its evaluation point, else at the params
    t_phase = time.time()
    p0 = eval_params(trainer.state) if validate_inline and will_train else trainer.state.params
    best_err = score_val_logits(validation_logits(p0))
    phase_seconds["initial_validation"] = time.time() - t_phase
    snap_writer.submit(_copy_params(trainer.state.params))
    logger.info("initial validation error: %.5f", best_err)

    es = AdaptiveES(
        adaptive_rate=cfg_hp["adaptive_rate"],
        adaptive_offset=cfg_hp["adaptive_offset"],
        min_patience=cfg_hp["min_patience"],
        max_patience=cfg_hp["max_patience"],
    )
    history: dict[str, Any] = {
        "train_loss": [],
        "grad_norm": [],
        "val_error": [],
        "best_val_error": best_err,
        "steps": 0,
        "step_seconds": [],  # per loop iteration (step + validation + snapshot)
        "skipped_steps": 0,
    }
    best_snap = None

    for step_i in range(start_step + 1, int(cfg_hp["max_steps"]) + 1):
        t_iter = time.time()
        if time.time() - st_time > time_limit:
            logger.info("time limit reached at step %d", step_i)
            break
        if state_checkpoint_every and step_i % state_checkpoint_every == 0:
            state_writer.submit(train_state_arrays(trainer.state))
        metrics = trainer.step(episode_batch_size)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        history["skipped_steps"] += int(not metrics["applied"])
        history["train_loss"].append(loss)
        history["grad_norm"].append(gn)
        history["steps"] = step_i
        if validate_inline or step_i % int(cfg_hp["validate_every_n_steps"]) == 0:
            p_eval = eval_params(trainer.state)
            err = score_val_logits(validation_logits(p_eval))
            history["val_error"].append((step_i, err))
            is_best = err < best_err
            if is_best:
                best_err = err
                history["best_val_error"] = err
                best_snap = p_eval
            if es.update(cur_round=step_i, is_best=is_best) and use_early_stopping:
                history["step_seconds"].append(time.time() - t_iter)
                logger.info("early stopping at step %d", step_i)
                break
        history["step_seconds"].append(time.time() - t_iter)

    t_phase = time.time()
    if best_snap is not None:
        snap_writer.submit(best_snap)
    write_errors = []
    for writer in (snap_writer, state_writer):
        try:
            writer.close()
        except Exception as e:  # the completed run is kept; the error is reported
            logger.error("background snapshot write failed: %r", e)
            write_errors.append(repr(e))
    if write_errors:
        history["snapshot_write_errors"] = write_errors
    phase_seconds["final_snapshot_flush"] = time.time() - t_phase
    history["wall_s"] = time.time() - st_time
    history["phase_seconds"] = phase_seconds
    return history
