"""Tracing / profiling: the port of the JAX package's
`multimodalpfn_tpu/utils/profiling.py`.

Phase timers that wait for the card before they read the clock, a
`torch.profiler` trace context that writes a Chrome trace (Perfetto,
chrome://tracing), the FLOPs of a call counted by
`torch.utils.flop_counter`, and the bytes each CUDA device holds.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)


@dataclass
class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name.

    Kernels run asynchronously to the host: with ``sync=True`` each phase
    ends with ``torch.cuda.synchronize(device)`` when ``device`` is a CUDA
    device (``None``: the current CUDA device, where there is one), so a
    phase's time bounds the completion of the work it queued.
    """

    sync: bool = True
    device: str | torch.device | None = None
    totals: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def _synchronize(self) -> None:
        if self.device is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        elif torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict[str, Any]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1e3, 2),
            }
            for name in sorted(self.totals)
        }

    def log(self, level: int = logging.INFO) -> None:
        logger.log(level, "phase timings: %s", json.dumps(self.report()))


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/mmpfn_trace"):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where there is a card) and write its Chrome trace to
    ``<log_dir>/trace.json``. Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(out / "trace.json"))


def compiled_cost(fn, *args, **kwargs) -> dict[str, float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted by
    `torch.utils.flop_counter.FlopCounterMode` over the aten operators it
    runs; ``bytes_accessed`` is -1 (no count), as the JAX function returns
    where its backend has none. There is no compiler to ask: the call runs.
    A kernel launched through `ops/kernels.py` is invisible to the counter,
    so the count is of the plain path (CPU tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0}


def live_device_memory() -> dict[str, int]:
    """Bytes held by PyTorch's allocator on each visible CUDA device
    (``torch.cuda.memory_allocated``); ``{}`` without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i)) for i in range(torch.cuda.device_count())}
