"""The traced slice of a run: `torch.profiler` over a stated number of
requests or iterations, its Chrome trace written under ``$TMPDIR`` and read
back into the few event kinds the per-layer readers use, and the interval
arithmetic they share.

Times are microseconds on the profiler's clock, which holds the host's
events and the device's alike.
"""

from __future__ import annotations

import heapq
import json
import os
import sys
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


def phase(name: str, since: float) -> float:
    """Print a set-up phase's seconds to standard error; returns the time now."""
    now = time.perf_counter()
    print(f"portbench: set-up {name} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


class ShortTrace(RuntimeError):
    """The trace holds fewer launches of a kernel than the program counted."""


def parse(path: Path) -> dict:
    """The events of a Chrome trace the readers use: ``device`` (kernels,
    copies and sets on the card), ``launches`` (the host's kernel launch
    calls), ``spans`` (the benchmark's own spans around each request or
    iteration) and ``host`` (the host's operators), each a list of dicts
    with ``name``, ``ts`` and ``dur``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {"device": [], "launches": [], "spans": [], "host": []}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        rec = {"name": name, "ts": float(ev["ts"]), "dur": float(ev.get("dur", 0.0))}
        if cat in DEVICE_CATS:
            out["device"].append(rec)
        elif cat in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in name:
            out["launches"].append(rec)
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            out["spans"].append(rec)
        elif cat in ("cpu_op", "user_annotation"):
            out["host"].append(rec)
    for v in out.values():
        v.sort(key=lambda r: r["ts"])
    return out


class Slice:
    """A traced slice that the caller opens, cuts into units and closes:
    the profiler starts at construction, `begin_unit` opens a unit's span
    (closing the one before), and `stop` closes the last and the profiler
    and reads the trace back, as ``trace``, with the program's launch
    counts over the slice."""

    def __init__(self, device):
        import torch

        from multimodalpfn_tpu_torch.ops import kernels

        self.device, self.units, self._span = device, 0, None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        self._before = dict(kernels.LAUNCHES)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def end_unit(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            self.units += 1

    def begin_unit(self) -> None:
        import torch

        self.end_unit()
        self._span = torch.profiler.record_function(UNIT)
        self._span.__enter__()

    def stop(self) -> None:
        """Closes the last unit and the profiler, and reads the trace back
        at once (written under ``$TMPDIR``, deleted once read)."""
        import torch

        from multimodalpfn_tpu_torch.ops import kernels

        self.end_unit()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        launches = {k: kernels.LAUNCHES[k] - self._before[k] for k in self._before}
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json", dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            print(f"portbench: trace {os.path.getsize(path)} bytes", file=sys.stderr, flush=True)
            self.trace = parse(Path(path))
        finally:
            os.unlink(path)
        del self._prof
        self.trace.update(launch_counts=launches, units=self.units)


def capture(step, n: int, device) -> dict:
    """Profile ``n`` calls of ``step(i)``, each a unit (the span `UNIT`);
    returns the parsed trace."""
    traced = Slice(device)
    for i in range(n):
        traced.begin_unit()
        step(i)
    traced.stop()
    return traced.trace


UNIT = SPAN_PREFIX + "unit"  # a traced request or iteration
REQUEST = SPAN_PREFIX + "request"  # from a request's start until its dispatch returns


def spans(trace: dict, name: str) -> list[dict]:
    return [s for s in trace["spans"] if s["name"] == name]


def window_of(trace: dict) -> tuple[float, float]:
    """From the first unit's start to the last unit's end."""
    units = spans(trace, UNIT)
    return units[0]["ts"], max(s["ts"] + s["dur"] for s in units)


def busy_intervals(trace: dict, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the device's operations, clipped to [lo, hi], as
    disjoint sorted intervals."""
    merged: list[list[float]] = []
    for ev in trace["device"]:
        a, b = max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(trace: dict) -> float:
    lo, hi = window_of(trace)
    return sum(b - a for a, b in busy_intervals(trace, lo, hi))


def matching(trace: dict, patterns: list[str]) -> list[dict]:
    """The device's kernels whose names hold one of ``patterns``."""
    return [ev for ev in trace["device"] if any(p in ev["name"] for p in patterns)]


def kernel_us(trace: dict, spec: dict) -> float:
    """Device time of one program kernel's launches, from a reader's data
    (``patterns``, the kernel id ``kernel`` and ``per_launch``, the device
    kernels each wrapper call starts). Raises `ShortTrace` where the trace
    holds fewer than the program counted, and ValueError where it holds
    more (another kernel matched)."""
    evs = matching(trace, spec["patterns"])
    want = trace["launch_counts"].get(spec["kernel"], 0) * spec["per_launch"]
    if len(evs) < want:
        raise ShortTrace(f"{spec['kernel']}: {len(evs)} kernels in the trace, {want} launched")
    if len(evs) > want:
        raise ValueError(f"{spec['kernel']}: {len(evs)} kernels match {spec['patterns']}, "
                         f"{want} launched")
    us = sum(ev["dur"] for ev in evs)
    if us <= 0:
        raise ShortTrace(f"{spec['kernel']}: {len(evs)} kernels in the trace and no time "
                         f"({sum(ev['dur'] <= 0 for ev in trace['device'])} of "
                         f"{len(trace['device'])} device operations have none)")
    return us


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the innermost host operator under each gap's middle
    (the benchmark's span where the host ran no operator), seconds."""
    by_name: dict[str, float] = {}
    for ev in trace["device"]:
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    lo, hi = window_of(trace)
    busy = busy_intervals(trace, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted(trace["host"] + trace["spans"], key=lambda h: h["ts"])
    # a sweep over the gaps' middles: the host operators open there, the
    # shortest of them the innermost
    by_end: list[tuple[float, int]] = []
    by_dur: list[tuple[float, int]] = []
    open_ = set()
    j = 0
    labels: dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while j < len(host) and host[j]["ts"] <= mid:
            heapq.heappush(by_end, (host[j]["ts"] + host[j]["dur"], j))
            heapq.heappush(by_dur, (host[j]["dur"], j))
            open_.add(j)
            j += 1
        while by_end and by_end[0][0] < mid:
            open_.discard(heapq.heappop(by_end)[1])
        while by_dur and by_dur[0][1] not in open_:
            heapq.heappop(by_dur)
        label = host[by_dur[0][1]]["name"] if by_dur else "(no host operator)"
        labels[label] = labels.get(label, 0.0) + (b - a)

    def top_of(d):
        return [[k[:120], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_name), "idle_gaps": top_of(labels)}
