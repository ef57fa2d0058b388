"""Fine-tuning: ``fine_tune_mmpfn`` itself, one call a run, on the seed's
rows with the published protocol (its own 20 % validation split, one
K-fold episode a step, schedule-free AdamW, validation after every step).

The call is the timed path. Its model init, its initial validation and its
first ``checked_steps`` iterations are set-up; the window is the
iterations after them, from the start of the first one's step to the start
of the first step at or past ``--seconds``, on the benchmark's clock. The
call's ``time_limit`` ends its loop soon after: ``call_setup_s`` covers its
set-up, and with ``--trace 1`` ``traced_call_s`` covers the traced slices
that follow the window. No train state is written
(``state_checkpoint_every=0``); the call's snapshots go under ``$TMPDIR``.

The benchmark watches the call and changes nothing in it: the trainer the
call builds (its ``make_episode_trainer`` is wrapped for the call) has its
``step`` watched, which records each step's start, the losses of the
checked steps, the first step's gradient (read back from the optimizer's
second moment) and the parameters' change over the checked steps; the
``forward`` that its validation calls is watched until the window opens,
for the last checked validation's logits. The reference follows those
checked steps."""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import make, trace
from portbench.reference import train as ref

B2 = 0.999  # the second-moment decay of the program's schedule-free AdamW


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
        self.random_seed = int(seed) % 2**32
        self.slices: list[trace.Slice] = []

    def setup(self) -> None:
        """The data, the weights and the model file; the import of the
        program and its kernel library (built on a checkout's first run)."""
        t = time.perf_counter()
        from multimodalpfn_tpu_torch.train import finetune  # noqa: F401

        if self.device.type == "cuda":
            from multimodalpfn_tpu_torch.ops import kernels

            kernels.library()
        t = trace.phase("import and kernel library", t)
        self.X, self.img, self.y = make.pad_ufes_like(self.seed, self.config["data"])
        self.weights = make.make_weights(self.arch, self.seed, self.device)
        self.tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
        make.write_npz(self.tmp / "model.npz", self.weights, self.arch, self.seed)
        trace.phase("weights and data", t)

    def window(self, seconds: float, traced: bool = False) -> dict:
        from multimodalpfn_tpu_torch.train import finetune

        tr, mix = self.traffic, self.arch["mixer"]
        watch = Watch(self, seconds, tr["trace_slices"] if traced else 0)
        limit = seconds + tr["call_setup_s"] + (tr["traced_call_s"] if traced else 0)
        make_trainer, forward = finetune.make_episode_trainer, finetune.forward

        def watched_trainer(**kw):
            trainer = make_trainer(**kw)
            watch.attach(trainer)
            return trainer

        finetune.make_episode_trainer = watched_trainer
        finetune.forward = watch.watch_forward(forward)
        t = time.perf_counter()
        try:
            history = finetune.fine_tune_mmpfn(
                mixer_type=mix["mixer_type"], mgm_heads=mix["mgm_heads"], cap_heads=mix["cap_heads"],
                features_per_group=self.arch["features_per_group"],
                save_path_to_fine_tuned_model=str(self.tmp / "fine_tuned.ckpt"),
                path_to_base_model=str(self.tmp / "model.npz"), time_limit=math.ceil(limit),
                finetuning_config={"learning_rate": tr["learning_rate"], "max_steps": tr["max_steps"]},
                validation_metric=self.config["validation_metric"], task_type=self.config["task"],
                device=self.device, X_train=self.X, image_train=self.img, y_train=self.y,
                random_seed=self.random_seed, logger_level=30, freeze_input=tr["freeze_input"],
                state_checkpoint_every=0)
        finally:
            finetune.make_episode_trainer, finetune.forward = make_trainer, forward
            watch.finish()
        self.watch, self.slices = watch, watch.slices
        opened, closed, n = watch.window()
        print(f"portbench: the call {time.perf_counter() - t:.3f} s, its loop {history['steps']} "
              f"steps; the window {closed - opened:.3f} s, {n} iterations", file=sys.stderr, flush=True)
        last = self.traffic["checked_steps"] + n
        bad = sum(not np.isfinite(v) for v in history["train_loss"][:last])
        bad += sum(not np.isfinite(e) for s, e in history["val_error"] if s <= last)
        return {"metrics": {"finetune_iter_ms": 1e3 * (closed - opened) / n}, "attempted": n,
                "failed": bad + history["skipped_steps"], "wall_s": closed - opened,
                "iterations": n, "opened": opened}

    def traced(self) -> dict:
        """The next slice traced in the call, after the window."""
        if not self.slices:
            raise RuntimeError("no traced slice left: the call ended before its slices were traced")
        return self.slices.pop(0).trace

    def release(self) -> None:
        self.watch.trainer = self.watch.run_step = None
        shutil.rmtree(self.tmp)

    # -- the reference ---------------------------------------------------------------
    def reference_data(self) -> dict:
        """The fine-tune's train and validation rows as the reference splits them."""
        if not hasattr(self, "data"):
            self.data = dict(zip(("train", "val"), ref.val_split(self.X, self.img, self.y,
                                                                 self.random_seed)))
        return self.data

    def check(self) -> dict:
        self.reference_data()
        want = ref.fine_tune_steps(self.weights, self.arch, self.data, seed=self.random_seed,
                                   lr=self.traffic["learning_rate"],
                                   n_steps=self.traffic["checked_steps"], device=self.device)
        w = self.watch
        got = {"losses": w.losses, "first_grad": w.first_grad, "change": w.change,
               "val_logits": w.val_logits}
        return compare(got, want, self.data["val"][2])

    def shapes(self) -> dict:
        data = self.reference_data()
        n_tr = len(data["train"][2])
        test = n_tr // 10
        return {"features": self.X.shape[1], "image_tokens": self.config["data"]["image_tokens"],
                "episode_train": n_tr - test, "episode_test": test, "val_train": n_tr,
                "val_test": len(data["val"][2])}


class Watch:
    """What the benchmark reads of one ``fine_tune_mmpfn`` call, from the
    start of each step of the trainer the call builds."""

    def __init__(self, cell: Cell, seconds: float, n_slices: int):
        self.cell, self.seconds, self.n_slices = cell, seconds, n_slices
        self.checked = cell.traffic["checked_steps"]
        self.steps = 0  # steps begun
        self.starts: list[float] = []  # perf_counter at each step's start
        self.opened = self.closed = None
        self.n = 0
        self.losses: list[float] = []
        self.slices: list[trace.Slice] = []
        self.slice = None
        self.trainer = None

    def attach(self, trainer) -> None:
        self.trainer, self.run_step = trainer, trainer.step
        trainer.step = self.step

    def watch_forward(self, forward):
        """``forward`` keeping its last output, until the window opens."""
        self.forward = forward

        def watched(*a, **kw):
            self.logits = forward(*a, **kw)
            return self.logits

        return watched

    def step(self, n_episodes: int = 1) -> dict:
        now = time.perf_counter()
        self.starts.append(now)
        self.steps += 1
        if self.steps == 1:
            self.start = {k: p.detach().clone() for k, p in self.params().items()}
        elif self.steps == self.checked + 1:
            self.open(now)
        elif self.closed is None and self.opened is not None and now - self.opened >= self.seconds:
            self.closed, self.n = now, self.steps - 1 - self.checked
        if self.closed is not None and self.n_slices:
            self.trace_step()
        metrics = self.run_step(n_episodes)
        if self.steps <= self.checked:
            self.read_checked(metrics)
        return metrics

    def params(self) -> dict:
        from multimodalpfn_tpu_torch.models.params import flatten_params

        return flatten_params(self.trainer.state.params)

    def read_checked(self, metrics: dict) -> None:
        opt = self.trainer.state.optimizer
        self.losses.append(float(metrics["loss"]))
        if self.steps == 1:  # |g| of each leaf from ν = (1 − b2)·g² after one step
            self.first_grad = {k: float(torch.sqrt(opt.state[p]["nu"].double().sum() / (1 - B2)))
                               for k, p in self.params().items() if p in opt.state}
        if self.steps == self.checked:
            self.change = {k: float((p.detach().double() - self.start[k].double()).norm())
                           for k, p in self.params().items() if p in opt.state}
            del self.start

    def open(self, now: float) -> None:
        """The window opens: the checked validations are over."""
        from multimodalpfn_tpu_torch.train import finetune

        finetune.forward = self.forward
        self.val_logits = self.logits[0].float().cpu().numpy().astype(np.float64)
        del self.logits
        self.opened = now

    def trace_step(self) -> None:
        """Past the window: ``n_slices`` slices of ``traced_iterations``
        iterations each, back to back."""
        if self.slice is not None:
            self.slice.end_unit()
            if self.slice.units == self.cell.traffic["traced_iterations"]:
                self.slice.stop()
                self.slices.append(self.slice)
                self.slice = None
        if self.slice is None and len(self.slices) < self.n_slices:
            self.slice = trace.Slice(self.cell.device)
        if self.slice is not None:
            self.slice.begin_unit()

    def finish(self) -> None:
        """After the call: a slice the loop's end cut short is dropped."""
        if self.slice is not None:
            self.slice.stop()
            self.slice = None

    def window(self) -> tuple[float, float, int]:
        """The window's start and end, and the iterations it holds; where
        the call's loop ended first, it ends at the last step's start."""
        if self.opened is None or len(self.starts) < self.checked + 2:
            raise RuntimeError(f"the call's loop ended after {self.steps} steps, before the window "
                               f"held an iteration (call_setup_s too short?)")
        if self.closed is None:
            return self.opened, self.starts[-1], len(self.starts) - 1 - self.checked
        return self.opened, self.closed, self.n


def leaf_gaps(got: dict, want: dict, keys) -> list[float]:
    """Each leaf's gap between the program's and the reference's norm,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    keys = list(keys)
    median = float(np.median([want[k] for k in keys]))
    return [abs(got[k] - want[k]) / max(want[k], median) for k in keys]


def compare(got: dict, want: dict, y_val: np.ndarray) -> dict:
    """The numbers that decide ``correct``: the worst step's relative loss
    gap, the worst leaf's first-gradient gap, the median leaf's change gap
    over the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone), and the validation's
    largest probability gap.

    The change is compared at the median leaf, not the worst: in the deeper
    layers the item attention's weights are uniform across the train rows
    (random weights), so the reference's gradient of their query and key
    weights is nought to float32 rounding, while bf16 rounding gives the
    program a gradient there that Adam's normalisation turns into a full
    step; the worst leaf's change gap (`layers/attn_item/w_qkv`) reads
    0.08-0.11 on sound runs and 0.09 on the control."""
    losses = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"], strict=True)]
    grad = want["first_grad"]
    median = float(np.median(list(grad.values())))
    moved = [k for k, g in grad.items() if g >= 1e-3 * median]
    n_classes = int(np.max(y_val)) + 1

    def probs(z):
        z = z[:, :n_classes] - z[:, :n_classes].max(axis=1, keepdims=True)
        return np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)

    val = float(np.abs(probs(got["val_logits"]) - probs(want["val_logits"])).max())
    return {"loss_gap": max(losses), "grad_gap": max(leaf_gaps(got["first_grad"], grad, grad)),
            "change_gap": float(np.median(leaf_gaps(got["change"], want["change"], moved))),
            "val_gap": val}
