"""One run of one cell: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by its name in ``BENCHMARK.json``:

- a configuration is the JSON file its entry names (``file``);
- a traffic mix is ``portbench/traffic/<traffic>.json``, whose ``driver``
  names the generator that reads it, ``portbench/drivers/<driver>.py``;
- a cell's limits on the numbers that decide ``correct`` are
  ``portbench/limits/<cell>.json`` (a number without one is printed, not
  compared);
- a per-layer metric is read by ``portbench/metrics/<metric>.py``.

A run makes its weights and data from the seed, sets up the program (its
set-up time is ``setup_s``), measures for the given seconds, reads the peak
of device memory, traces a bounded slice with ``--trace 1``, frees the
program, checks what the window produced against the plain reference, and
prints one JSON line last. It measures the PyTorch and CUDA port
(``multimodalpfn_tpu_torch``) and nothing else.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from portbench import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalpfn_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of `FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def entry(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def device_facts(device, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def run(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, config: dict | None = None, traffic: dict | None = None) -> dict:
    """The result of one run; ``config`` and ``traffic`` replace the
    files the cell names (the CPU tests run cells at a small size)."""
    import torch

    wl = entry(bench["workloads"], cell, "workload")
    if config is None:
        config = load_json(ROOT / entry(bench["configs"], wl["config"], "config")["file"])
    if traffic is None:
        traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell}.json")
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    job = driver.Cell(config, traffic, seed, device)
    job.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    opened = time.perf_counter()
    win = job.window(seconds, trace)
    setup_s = win.get("opened", opened) - t_start  # a driver whose call also sets up opens it later
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    layer_values, traced = read_per_layer(bench, cell, job, config, traffic, win) if trace else ({}, None)
    job.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with _no_tf32():
        numbers = job.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    for k in sorted(set(numbers) - set(limits)):  # a number with no upper reading (PERF.md §2)
        print(f"portbench: {k} {numbers[k]!r} (not compared)", file=sys.stderr)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and win["failed"] == 0

    facts = device_facts(device, peak)
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **win["metrics"]}
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if m["name"] in layer_values:
                metrics[m["name"]] = {"value": layer_values[m["name"]], "unit": m["unit"]}
        if traced is not None and traced["spans"]:
            lo, hi = tr.window_of(traced)
            facts["busy_s"] = tr.busy_us(traced) / 1e6
            facts["window_s"] = (hi - lo) / 1e6
    out = {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": facts}
    if trace and traced is not None and traced["spans"] and traced["device"]:
        out["breakdown"] = tr.breakdown(traced)
    out["checks"] = checks
    return out


def read_per_layer(bench: dict, cell: str, job, config: dict, traffic: dict, win: dict,
                   attempts: int = 3) -> tuple[dict, dict]:
    """The cell's per-layer metrics from a traced slice, traced again where
    the profiler dropped a kernel (a short trace is never read), and the
    trace they were read from."""
    readers = [(m["name"], load_module(HERE / "metrics" / f"{m['name']}.py"))
               for m in bench["per_layer"] if applies(m, cell)]
    for attempt in range(attempts):
        traced = job.traced()
        record = {"config": config, "traffic": traffic, "shapes": job.shapes(), "window": win,
                  "trace": traced}
        try:
            values = {name: reader.read(record) for name, reader in readers}
        except tr.ShortTrace as e:
            print(f"portbench: short trace ({e}), tracing again", file=sys.stderr)
            if attempt == attempts - 1:
                raise
            continue
        return {k: v for k, v in values.items() if v is not None}, traced


class _no_tf32:
    """The reference's float32 products in float32: TF32 off inside."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = entry(bench["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"portbench: {torch.cuda.get_device_name(device)}, power limit {power_limit()}",
          file=sys.stderr, flush=True)
    tr.phase("interpreter, torch and the card", t_start)
    out = run(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"
