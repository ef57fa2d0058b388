"""A batched fine-tune sweep: one ``fine_tune_batched_cells`` call a run,
the grid cells of the traffic file (MGM+CAP, ``mgm_heads`` each, one shared
``cap_heads``) × its seeds, every run's mixer padded to the largest head
count, on the seed's rows (too-z/MultiModalPFN ``run.py``'s grid as one
sweep on one card).

A run's seeds are the traffic file's offsets added to ``--seed`` (below
2**31), so every benchmark seed draws fresh runs. The call is the timed
path and is timed as `finetune.Cell` times ``fine_tune_mmpfn``: its model
init, its initial validation and its first ``checked_steps`` sweep steps
are set-up; the window is the sweep steps after them (each every run's
step and validation), from the start of the first to the start of the
first at or past ``--seconds``, on the benchmark's clock; the call's
``time_limit`` ends its loop soon after. With ``--trace 1`` the slices
follow the window.

The benchmark draws each run's fresh mixer itself: in `init_run_mixer`'s
place it gives the program `run_mixer`, `make.make_weights`' draw at the
head counts the program asks for from the seed it passes, which the program
then pads and trains; the reference draws the same from the run's own seed
and head count, so a run given another run's mixer, or the wrong head count,
reads apart. Beyond that it watches the call and changes nothing in it:
each run's first ``checked_steps`` steps (the first gradient from the
optimizer's second moment, the parameters' change), the validation logits
after them, and each sweep step's start (`_any_rank`, the loop's check of
its time limit, which begins every step outside the program's spans: a
span's ``record_function`` must not outlive the profiler it began under, so
a slice starts and stops there). Each run is checked against the
reference's fine-tune of that run with its own unpadded mixer
(`reference/sweep.py`); a number is the worst run's."""

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
from portbench.drivers import finetune
from portbench.reference import sweep as ref


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
        base = int(seed) % (2**31 - max(traffic["seeds"]))
        self.run_seeds = [base + s for s in traffic["seeds"]]
        self.cells = [{"mgm_heads": h, "cap_heads": traffic["cap_heads"], "seeds": self.run_seeds}
                      for h in traffic["mgm_heads"]]
        self.runs = [(c["mgm_heads"], s) for c in self.cells for s in c["seeds"]]  # the sweep's order
        self.slices: list[trace.Slice] = []

    def setup(self) -> None:
        t = time.perf_counter()
        from multimodalpfn_tpu_torch.train import finetune_batch  # noqa: F401

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
        from multimodalpfn_tpu_torch.train import finetune_batch as fb

        tr = self.traffic
        watch = SweepWatch(self, seconds, tr["trace_slices"] if traced else 0)
        limit = seconds + tr["call_setup_s"] + (tr["traced_call_s"] if traced else 0)
        names = ("init_run_mixer", "make_train_step", "forward_train_test", "_any_rank")
        saved = {n: getattr(fb, n) for n in names}
        for n in names:
            setattr(fb, n, getattr(watch, "watch_" + n)(saved[n]))
        t = time.perf_counter()
        try:
            out = fb.fine_tune_batched_cells(
                cells=self.cells, mixer_type=self.arch["mixer"]["mixer_type"],
                features_per_group=self.arch["features_per_group"],
                path_to_base_model=str(self.tmp / "model.npz"), task_type=self.config["task"],
                X=self.X, image=self.img, y=self.y,
                finetuning_config={"learning_rate": tr["learning_rate"], "max_steps": tr["max_steps"],
                                   "validate_every_n_steps": 1},
                validation_metric=self.config["validation_metric"], freeze_input=tr["freeze_input"],
                time_limit=math.ceil(limit), device=self.device)
        finally:
            for n in names:
                setattr(fb, n, saved[n])
            watch.finish()
        self.watch, self.slices = watch, watch.slices
        history = out["history"]
        opened, closed, n = watch.window()
        print(f"portbench: the call {time.perf_counter() - t:.3f} s, its loop "
              f"{len(history['train_loss'])} sweep steps; the window {closed - opened:.3f} s, {n} "
              f"sweep steps", file=sys.stderr, flush=True)
        last = tr["checked_steps"] + n
        watch.losses = [[float(v) for v in step] for step in history["train_loss"][:tr["checked_steps"]]]
        bad = sum(not np.isfinite(v) for step in history["train_loss"][:last] for v in step)
        bad += sum(not np.isfinite(e) for s, errs in history["val_error"] if s <= last for e in errs)
        return {"metrics": {"finetune_iter_ms": 1e3 * (closed - opened) / n}, "attempted": n,
                "failed": bad + sum(history["skipped_steps"]), "wall_s": closed - opened,
                "iterations": n, "opened": opened}

    def traced(self) -> dict:
        if not self.slices:
            raise RuntimeError("no traced slice left: the call ended before its slices were traced")
        return self.slices.pop(0).trace

    def release(self) -> None:
        shutil.rmtree(self.tmp)

    # -- the reference ---------------------------------------------------------------
    def run_arch(self, mgm_heads: int, cap_heads: int) -> dict:
        return {**self.arch, "mixer": {**self.arch["mixer"], "mgm_heads": mgm_heads, "cap_heads": cap_heads}}

    def run_mixer(self, seed: int, mgm_heads: int, cap_heads: int) -> dict[str, torch.Tensor]:
        """A run's fresh mixer, flat and float32 on the cell's device: the
        mixer leaves of `make.make_weights` at the run's head counts from the
        run's seed (the draw `controls.py` reads its controls on)."""
        weights = make.make_weights(self.run_arch(mgm_heads, cap_heads), seed, self.device)
        return {k: v for k, v in weights.items() if k.startswith("mixer/")}

    def run_weights(self, r: int) -> tuple[dict, dict]:
        """Run ``r``'s weights (the base's, with the run's own mixer) and
        architecture (its head count)."""
        heads, s = self.runs[r]
        arch = self.run_arch(heads, self.traffic["cap_heads"])
        weights = {k: v for k, v in self.weights.items() if not k.startswith("mixer/")}
        weights.update(self.run_mixer(s, heads, self.traffic["cap_heads"]))
        return weights, arch

    def check(self) -> dict:
        worst: dict[str, float] = {}
        for r, (_, s) in enumerate(self.runs):
            weights, arch = self.run_weights(r)
            data = ref.run_data(self.X, self.img, self.y, s)
            want = ref.fine_tune_steps(weights, arch, data, seed=s, lr=self.traffic["learning_rate"],
                                       n_steps=self.traffic["checked_steps"], device=self.device)
            w = self.watch
            got = {"losses": [step[r] for step in w.losses], "first_grad": w.first_grad[r],
                   "change": w.change[r], "val_logits": w.val_logits[r]}
            for k, v in finetune.compare(got, want, data["val"][2]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def shapes(self) -> dict:
        n = len(self.y)
        n_val = len(ref.run_split(n, self.run_seeds[0])[1])
        n_tr = n - n_val
        test = n_tr // 10
        return {"features": self.X.shape[1], "image_tokens": self.config["data"]["image_tokens"],
                "episode_train": n_tr - test, "episode_test": test, "val_train": n_tr,
                "val_test": n_val, "mgm_heads": [h for h, _ in self.runs]}


class SweepWatch(finetune.Watch):
    """What the benchmark reads of one ``fine_tune_batched_cells`` call,
    through the four functions of `train/finetune_batch.py` it calls by
    name."""

    def __init__(self, cell: Cell, seconds: float, n_slices: int):
        super().__init__(cell, seconds, n_slices)
        self.n_runs = len(cell.runs)
        self.steps_taken = 0  # runs' steps begun
        self.val_calls = 0
        self.start: dict[int, dict] = {}
        self.first_grad: dict[int, dict] = {}
        self.change: dict[int, dict] = {}
        self.val_logits: dict[int, np.ndarray] = {}

    def watch_init_run_mixer(self, init):
        """The program's per-run draw replaced by the benchmark's."""

        def drawn(seed, mixer_cfg, emsize, device):
            mixer: dict[str, dict] = {}
            for name, v in self.cell.run_mixer(seed, mixer_cfg.mgm_heads, mixer_cfg.cap_heads).items():
                _, group, leaf = name.split("/")
                mixer.setdefault(group, {})[leaf] = v.to(device)
            return mixer

        return drawn

    def watch_make_train_step(self, make_step):
        def made(*a, **kw):
            step = make_step(*a, **kw)

            def watched(state, batch, generator):
                i, r = divmod(self.steps_taken, self.n_runs)
                self.steps_taken += 1
                if i == 0:
                    self.start[r] = {k: p.detach().clone() for k, p in self.flat(state).items()}
                state, metrics = step(state, batch, generator)
                if i == 0:
                    opt = state.optimizer
                    self.first_grad[r] = {
                        k: float(torch.sqrt(opt.state[p]["nu"].double().sum() / (1 - finetune.B2)))
                        for k, p in self.flat(state).items() if p in opt.state}
                if i == self.checked - 1:
                    opt = state.optimizer
                    self.change[r] = {k: float((p.detach().double() - self.start[r][k].double()).norm())
                                      for k, p in self.flat(state).items() if p in opt.state}
                    del self.start[r]
                return state, metrics

            return watched

        return made

    @staticmethod
    def flat(state) -> dict:
        from multimodalpfn_tpu_torch.models.params import flatten_params

        return flatten_params(state.params)

    def watch_forward_train_test(self, forward):
        """The validation's forward: the logits after the checked steps."""

        def watched(*a, **kw):
            out = forward(*a, **kw)
            i, r = divmod(self.val_calls, self.n_runs)
            self.val_calls += 1
            if i == self.checked:
                self.val_logits[r] = out[0].float().cpu().numpy().astype(np.float64)
            return out

        return watched

    def watch__any_rank(self, any_rank):
        """The loop's time-limit check: a step starts where it passes."""

        def watched(flag, mesh, device):
            stop = any_rank(flag, mesh, device)
            if not stop:
                self.sweep_step()
            return stop

        return watched

    def sweep_step(self) -> None:
        now = time.perf_counter()
        self.starts.append(now)
        self.steps += 1
        if self.steps == self.checked + 1:
            self.opened = now
        elif self.closed is None and self.opened is not None and now - self.opened >= self.seconds:
            self.closed, self.n = now, self.steps - 1 - self.checked
        if self.closed is not None and self.n_slices:
            self.trace_step()
