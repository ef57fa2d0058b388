"""The cells ``petfinder-fitpre-2930`` (PetFinder served with preprocessing
off) and ``clf-sweep4`` (a batched fine-tune sweep): their readers on
small synthetic traces, both cells end to end at a small size on the CPU,
each fault they can have turning ``correct`` false, and their controls
reading past a limit. The readers the earlier cells use give the numbers
they gave before these cells came, to the bit."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import bench, controls, span_device, trace
from portbench.tests.conftest import ROOT, SEED, small
from portbench.tests.test_portbench_process import _modules_after
from portbench.tests.test_portbench_reference import SERVED_FAULTS, _state_unchanged
from portbench.tests.test_portbench_readers import chrome, ev, read, record
from portbench.work.attention import item_attention_forward
from portbench.work.forward import iteration_flops, request_flops
from portbench.work.peaks import BF16_FLOPS, bound_s

PETFINDER = bench.load_json(ROOT / "portbench/configs/mmpfn-clf-petfinder-mgmcap32x24.json")["architecture"]
MIXER = "mmpfn.forward.mixer"


def correlated(tmp_path, mixer_spans: bool = True) -> dict:
    """Two requests of 100 us: a mixer span at 10-20 launches two kernels
    (correlation ids 1, 2: 4 and 6 us on the card), the layers launch one
    after it (id 3: 30 us); the second request's mixer kernels take 5 and
    7 us."""
    events = []
    for i, u in enumerate((0, 100)):
        events += [ev("user_annotation", trace.UNIT, u, 100), ev("user_annotation", trace.REQUEST, u, 90)]
        if mixer_spans:
            events.append(ev("user_annotation", MIXER, u + 10, 10))
        for c, (t, dur) in enumerate(((u + 12, 4 + i), (u + 15, 6 + i), (u + 40, 30)), start=1):
            corr = 10 * i + c
            events.append({**ev("cuda_runtime", "cudaLaunchKernel", t, 1), "args": {"correlation": corr}})
            events.append({**ev("kernel", f"k{c}", t + 5, dur), "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace.parse(path)
    out["span_device_us"] = span_device.span_device_us(path, (MIXER,))
    out.update(launch_counts={}, units=2, rows=[2930, 2930])
    return out


def petfinder_record(tr) -> dict:
    shapes = {"members": [19] * 4, "image_tokens": 2, "train_rows": 11722, "cached": False}
    return {"config": {"architecture": PETFINDER}, "traffic": {}, "shapes": shapes,
            "window": {"wall_s": 2.0, "rows": [2930, 2930]}, "trace": tr}


def test_span_device_time(tmp_path):
    tr = correlated(tmp_path)
    assert [d for _, _, d in tr["span_device_us"][MIXER]] == [10.0, 12.0]
    assert span_device.per_unit_ms(tr, MIXER) == [0.010, 0.012]
    assert read("mixer_ms.petfinder", petfinder_record(tr)) == pytest.approx(0.011)


def test_mixer_ms_reads_nothing_without_the_span(tmp_path):
    assert read("mixer_ms.petfinder", petfinder_record(correlated(tmp_path, mixer_spans=False))) is None
    tr = correlated(tmp_path)
    tr["device"] = []
    assert read("mixer_ms.petfinder", petfinder_record(tr)) is None


def test_petfinder_mfu_and_roofline(tmp_path):
    rec = petfinder_record(chrome(tmp_path))
    rec["trace"]["rows"] = [2930, 2930]
    flops = 2 * request_flops(PETFINDER, rec["shapes"], 2930)
    assert read("mfu.petfinder", rec) == pytest.approx(100.0 * flops / 2.0 / BF16_FLOPS)
    # 35 token columns: ten groups of two features, CAP's 24 tokens, the target
    work = 2 * 4 * PETFINDER["nlayers"] * bound_s(*item_attention_forward(PETFINDER, 19, 11722, 2930))
    assert read("item_attn_fwd_roofline.petfinder", rec) == pytest.approx(100.0 * work / 50e-6)
    rec["trace"]["device"] = []
    assert read("mfu.petfinder", rec) is None


def test_sweep_mfu(tmp_path):
    rec = record(chrome(tmp_path), iterations=10)
    heads = [16, 16, 32, 32]
    rec["shapes"] = {"features": 21, "image_tokens": 1, "episode_train": 1655, "episode_test": 183,
                     "val_train": 1838, "val_test": 460, "mgm_heads": heads}
    arch = rec["config"]["architecture"]
    step = sum(iteration_flops({**arch, "mixer": {**arch["mixer"], "mgm_heads": h}}, rec["shapes"])
               for h in heads)
    assert read("mfu.sweep", rec) == pytest.approx(100.0 * 10 * step / BF16_FLOPS)
    # the 32-head runs need more: the reading is not four times a 16-head run's
    assert step > 4 * iteration_flops(arch, rec["shapes"])


@pytest.mark.parametrize("name,value", [
    ("mfu.serve", 1.1488093999886755), ("mfu.stream", 1.1488093999886755),
    ("item_attn_fwd_roofline.serve", 28252.28721206876)])
def test_earlier_readers_unchanged(tmp_path, name, value):
    assert read(name, record(chrome(tmp_path))) == value


def test_earlier_train_mfu_unchanged(tmp_path):
    rec = record(chrome(tmp_path))
    rec["shapes"] = {"features": 21, "image_tokens": 1, "episode_train": 1655, "episode_test": 183,
                     "val_train": 1838, "val_test": 460}
    assert read("mfu.train", rec) == 0.7308583057989889


def run_small(benchmark: dict, cell: str, trace: bool = False) -> dict:
    """`conftest.run_small`, with the sweep's loop cut at a step count in
    place of its time limit, which a busy CPU would reach before the window
    opens (three checked steps, a window of at least one, two traced), and
    its grid cells at 2 and 4 MGM heads."""
    import time

    config, traffic = small(benchmark, cell)
    if traffic["driver"] == "sweep":
        traffic.update(max_steps=9, call_setup_s=600, traced_call_s=0, mgm_heads=[2, 4])
    return bench.run(benchmark, cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                     config=config, traffic=traffic)


@pytest.mark.parametrize("cell", ["petfinder-fitpre-2930", "clf-sweep4"])
def test_a_new_cell_runs_and_agrees(benchmark, cell):
    out = run_small(benchmark, cell, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(bench.load_json(bench.HERE / "limits" / f"{cell}.json"))
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, (name, c)


def _half_the_sweep_batch(monkeypatch):
    from multimodalpfn_tpu_torch.train import finetune_batch

    get = finetune_batch.get_loss_fn

    def half(task, borders=None):
        fn = get(task, borders)
        return lambda logits, y: fn(logits[:, : y.shape[1] // 2], y[:, : y.shape[1] // 2])

    monkeypatch.setattr(finetune_batch, "get_loss_fn", half)


def _altered_sweep_validation(monkeypatch):
    from multimodalpfn_tpu_torch.train import finetune_batch

    fwd = finetune_batch.forward_train_test

    def altered(*a, **kw):
        out = fwd(*a, **kw).clone()
        out[:, 0] = torch.roll(out[:, 0], max(1, out.shape[-1] // 10), dims=-1)
        return out

    monkeypatch.setattr(finetune_batch, "forward_train_test", altered)


def _one_mixer_a_head_count(monkeypatch):
    """Every run of a grid cell trains its first run's mixer."""
    from multimodalpfn_tpu_torch.train import finetune_batch

    pad, first = finetune_batch.pad_mixer_params, {}

    def padded(mixer, cfg_pad):
        return pad(first.setdefault(mixer["mgm"]["w1"].shape[0], mixer), cfg_pad)

    monkeypatch.setattr(finetune_batch, "pad_mixer_params", padded)


SWEEP_FAULTS = {"unchanged": _state_unchanged, "half": _half_the_sweep_batch,
                "altered": _altered_sweep_validation, "one_mixer": _one_mixer_a_head_count}


@pytest.mark.parametrize("cell,fault", [("petfinder-fitpre-2930", f) for f in SERVED_FAULTS]
                         + [("clf-sweep4", f) for f in SWEEP_FAULTS])
def test_a_broken_program_is_not_correct(benchmark, monkeypatch, cell, fault):
    (SERVED_FAULTS if cell.startswith("petfinder") else SWEEP_FAULTS)[fault](monkeypatch)
    out = run_small(benchmark, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["petfinder-fitpre-2930", "clf-sweep4"])
def test_the_control_reads_past_a_limit(benchmark, cell):
    config, traffic = small(benchmark, cell, layers=2, rows=200)
    if traffic["driver"] == "sweep":
        traffic.update(mgm_heads=[2, 4])
    limits = bench.load_json(bench.HERE / "limits" / f"{cell}.json")
    readings = controls.READINGS[traffic["driver"]](config, traffic, SEED, torch.device("cpu"))
    assert any(readings["fp8"][k] > limits[k] for k in limits), (readings, limits)
    assert all(np.isfinite(v) for r in readings.values() for v in r.values())


def test_the_new_reference_loads_nothing_of_the_port():
    loaded = _modules_after("import portbench.reference.petfinder, portbench.reference.sweep\n"
                            "import portbench.make_petfinder, portbench.controls, portbench.span_device\n")
    assert not loaded & {"jax", "multimodalpfn_tpu", "multimodalpfn_tpu_torch"}
