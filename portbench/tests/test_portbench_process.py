"""What a run's process may load, and how it ends without a card: the
harness and its drivers load no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``multimodalpfn_tpu`` (compared whole: the port's
``multimodalpfn_tpu_torch`` is not one of them), the reference loads
nothing of the port, and ``run.py`` without a CUDA device exits with an
error and prints no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


def _modules_after(code: str) -> set[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    loaded = _modules_after(
        "from pathlib import Path\nfrom portbench import bench\n"
        "for p in sorted((bench.HERE / 'drivers').glob('*.py')): bench.load_module(p)\n"
        "for p in sorted((bench.HERE / 'metrics').glob('*.py')): bench.load_module(p)\n"
        "import multimodalpfn_tpu_torch\n"
        "from multimodalpfn_tpu_torch.train import finetune\n"
        "found = bench.forbidden_modules()\nassert not found, found\n")
    assert "multimodalpfn_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "multimodalpfn_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _modules_after(
        "import portbench.reference.model, portbench.reference.serve, portbench.reference.train\n"
        "import portbench.reference.episodes, portbench.make, portbench.control\n")
    assert not loaded & {"jax", "multimodalpfn_tpu", "multimodalpfn_tpu_torch"}


def test_a_run_loads_no_jax():
    """A whole traced run of a cell at a small size, in its own process."""
    loaded = _modules_after(
        "from portbench import bench\nfrom portbench.tests.conftest import run_small\n"
        "out = run_small(bench.load_json(bench.ROOT / 'BENCHMARK.json'), 'clf-fitpre-460', trace=True)\n"
        "assert out['correct'], out\n")
    assert "multimodalpfn_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "multimodalpfn_tpu"}


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "clf-fitpre-460",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["clf-fitpre-460", "clf-cache-stream", "clf-finetune"])
def test_a_cell_runs_on_the_card(card, cell):
    """A whole run of the cell at its own size, short window, on the card."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "7",
                          "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
