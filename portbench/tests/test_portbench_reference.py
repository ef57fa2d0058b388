"""The reference against the port on the CPU at a small size, a run of
each cell with the timed path broken underneath (each fault the cell can
have must turn ``correct`` false), and the control: the reference in the
precision below the configuration's must read past a limit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import bench, control
from portbench.tests.conftest import SEED, run_small, small

CELLS = ["clf-fitpre-460", "clf-cache-stream", "clf-finetune"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(benchmark, cell):
    """On the CPU the port runs its plain float32 versions: the two agree to
    float32 rounding, far inside every limit."""
    out = run_small(benchmark, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, (name, c)


def _roll_first_answer(monkeypatch):
    from multimodalpfn_tpu_torch.estimator.classifier import MMPFNClassifier

    finalize = MMPFNClassifier._finalize_predict

    def altered(self, handle):
        p = finalize(self, handle)
        p[0] = np.roll(p[0], 1)
        return p

    monkeypatch.setattr(MMPFNClassifier, "_finalize_predict", altered)


def _half_the_members(monkeypatch):
    from multimodalpfn_tpu_torch.estimator import inference

    for cls in (inference.InferenceEngine, inference.InferenceEngineCacheKV):
        finalize = cls.finalize_outputs

        def half(self, handle, finalize=finalize):
            out = finalize(self, handle)
            return out[: len(out) // 2]

        monkeypatch.setattr(cls, "finalize_outputs", half)


def _state_unchanged(monkeypatch):
    from multimodalpfn_tpu_torch.train import step

    monkeypatch.setattr(step.ScheduleFreeAdamW, "_update", lambda self, params, grads, lr: None)


def _half_the_batch(monkeypatch):
    from multimodalpfn_tpu_torch.train import finetune

    get = finetune.get_loss_fn

    def half(task, borders=None):
        fn = get(task, borders)
        return lambda logits, y: fn(logits[:, : y.shape[1] // 2], y[:, : y.shape[1] // 2])

    monkeypatch.setattr(finetune, "get_loss_fn", half)


def _altered_validation(monkeypatch):
    """The validation's logits altered where `fine_tune_mmpfn` makes them."""
    from multimodalpfn_tpu_torch.train import finetune

    fwd = finetune.forward

    def altered(*a, **kw):
        out = fwd(*a, **kw).clone()
        out[:, 0] = torch.roll(out[:, 0], max(1, out.shape[-1] // 10), dims=-1)
        return out

    monkeypatch.setattr(finetune, "forward", altered)


SERVED_FAULTS = {"altered": _roll_first_answer, "half": _half_the_members}
TRAIN_FAULTS = {"unchanged": _state_unchanged, "half": _half_the_batch, "altered": _altered_validation}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS[:2] for f in SERVED_FAULTS]
                         + [(c, f) for c in CELLS[2:] for f in TRAIN_FAULTS])
def test_a_broken_program_is_not_correct(benchmark, monkeypatch, cell, fault):
    (SERVED_FAULTS if cell in CELLS[:2] else TRAIN_FAULTS)[fault](monkeypatch)
    out = run_small(benchmark, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["clf-fitpre-460", "clf-finetune"])
def test_the_control_reads_past_a_limit(benchmark, cell):
    """The reference in float8 in the program's place: at least one number
    past the cell's limit (the served cells share one control)."""
    config, traffic = small(benchmark, cell, layers=3, rows=200)
    limits = bench.load_json(bench.HERE / "limits" / f"{cell}.json")
    cpu = torch.device("cpu")
    if traffic["driver"] == "finetune":
        readings = control.finetune_readings(config, traffic, SEED, cpu)["fp8"]
    else:
        readings = control.serving_readings(config, SEED, cpu)["fp8"]
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)
