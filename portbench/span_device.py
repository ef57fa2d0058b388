"""The device time of the program's spans: for each occurrence of a named
``mmpfn.*`` span in a traced slice, the device time of the kernels, copies
and sets that the host launched inside it, matched to their launch by the
profiler's correlation id. A program without the span gives nothing.

`capture` traces as `trace.capture` does and adds, under
``span_device_us``, ``{name: [(ts, dur, device_us), ...]}`` (the span's
start and length on the host, the device time it launched; microseconds).
"""

from __future__ import annotations

import json
from pathlib import Path

from portbench import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MIXER = "mmpfn.forward.mixer"  # the program's span around its mixer


def span_device_us(path: Path, names: tuple[str, ...]) -> dict[str, list[tuple[float, float, float]]]:
    """Each span named in ``names`` in the Chrome trace at ``path``, with the
    device time of the operations launched inside it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launched: dict[int, float] = {}  # correlation id -> the launch's start on the host
    device: dict[int, float] = {}  # correlation id -> the operations' device time
    found: dict[str, list[tuple[float, float]]] = {n: [] for n in names}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS and corr is not None:
            device[corr] = device.get(corr, 0.0) + float(ev.get("dur", 0.0))
        elif cat in LAUNCH_CATS and corr is not None:
            launched[corr] = float(ev["ts"])
        elif cat == "user_annotation" and name in found:
            found[name].append((float(ev["ts"]), float(ev.get("dur", 0.0))))
    starts = sorted((t, device.get(c, 0.0)) for c, t in launched.items())
    out = {}
    for name, spans in found.items():
        out[name] = [(a, d, sum(us for t, us in starts if a <= t <= a + d)) for a, d in sorted(spans)]
    return out


class Slice(trace.Slice):
    """`trace.Slice` that also reads the device time of the spans ``names``
    from the trace file it writes."""

    def __init__(self, device, names: tuple[str, ...]):
        super().__init__(device)
        self.names = names

    def stop(self) -> None:
        export, found = self._prof.export_chrome_trace, {}

        def exported(path: str) -> None:  # `trace.Slice.stop` writes the file through it
            export(path)
            found.update(span_device_us(Path(path), self.names))

        self._prof.export_chrome_trace = exported
        super().stop()
        self.trace["span_device_us"] = found


def capture(step, n: int, device, names: tuple[str, ...]) -> dict:
    """`trace.capture` with the device time of the spans ``names``."""
    traced = Slice(device, names)
    for i in range(n):
        traced.begin_unit()
        step(i)
    traced.stop()
    return traced.trace


def per_unit_ms(tr: dict, name: str) -> list[float]:
    """The device time launched inside the span ``name``, summed over each
    traced unit, ms; empty where the trace holds no such span."""
    spans = (tr.get("span_device_us") or {}).get(name) or []
    if not spans:
        return []
    return [sum(us for a, d, us in spans if u["ts"] <= a and a + d <= u["ts"] + u["dur"]) / 1e3
            for u in trace.spans(tr, trace.UNIT)]
