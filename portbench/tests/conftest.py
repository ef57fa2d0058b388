"""Shared fixtures of the benchmark's CPU tests: the benchmark file, and a
cell's configuration and traffic cut to a size a CPU test run holds (one
layer, 120 rows, short traced slices)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be


@pytest.fixture(scope="session")
def benchmark() -> dict:
    return bench.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small(benchmark: dict, cell: str, layers: int = 1, rows: int = 120) -> tuple[dict, dict]:
    """The cell's configuration and traffic at a CPU test's size."""
    wl = bench.entry(benchmark["workloads"], cell, "workload")
    config = bench.load_json(ROOT / bench.entry(benchmark["configs"], wl["config"], "config")["file"])
    traffic = bench.load_json(bench.HERE / "traffic" / f"{wl['traffic']}.json")
    config["architecture"]["nlayers"] = layers
    config["data"]["rows"] = rows
    traffic.update({k: 1 for k in ("warm_requests", "traced_requests", "traced_batches",
                                   "traced_iterations") if k in traffic})
    if "max_rows" in traffic:
        traffic.update(min_rows=20, max_rows=150, batch=2)
    if "call_setup_s" in traffic:
        traffic.update(call_setup_s=10, traced_call_s=10)
    return config, traffic


def run_small(benchmark: dict, cell: str, trace: bool = False, **kw) -> dict:
    import time

    import torch

    config, traffic = small(benchmark, cell, **kw)
    return bench.run(benchmark, cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                     config=config, traffic=traffic)
