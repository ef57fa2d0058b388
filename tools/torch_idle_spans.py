#!/usr/bin/env python3
"""Where the card idles, by the port's own spans: a traced run of each of
`portbench/`'s cells (``portbench.bench.run``, as ``--trace 1`` makes it),
with the run's breakdown and the same breakdown over the program's spans
alone, where each idle gap goes to the innermost ``mmpfn.*`` span open on
the host at the gap's middle (else to the benchmark's span).

    python3 tools/torch_idle_spans.py [--seed N] [--seconds S] [--cells a,b] [--out chiprun_out/idle_spans.json]

Runs on a card. The profiler slows the host, so a traced slice's idle
over-reads the untraced runs'.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "mmpfn."
BENCHMARK_LABELS = ("portbench.", "(no host operator)")


def program_breakdown(traced: dict) -> dict:
    """`trace.breakdown` with the program's spans as the only host events."""
    from portbench import trace

    return trace.breakdown({**traced, "host": [h for h in traced["host"] if h["name"].startswith(PREFIX)]})


def traced_run(bench, declared: dict, cell: str, seed: int, seconds: float, device) -> tuple[dict, dict]:
    """``bench.run`` with a trace, and the slice its metrics were read from."""
    kept, real = [], bench.read_per_layer

    def keep(*args, **kwargs):
        values, traced = real(*args, **kwargs)
        kept.append(traced)
        return values, traced

    bench.read_per_layer = keep
    try:
        out = bench.run(declared, cell, seed, seconds, True, device, time.perf_counter())
    finally:
        bench.read_per_layer = real
    return out, kept[-1]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4400000123)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--cells", default="clf-fitpre-460,clf-cache-stream,clf-finetune")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "idle_spans.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    declared = bench.load_json(ROOT / "BENCHMARK.json")
    result = {"device": torch.cuda.get_device_name(device)}
    for cell in args.cells.split(","):
        out, traced = traced_run(bench, declared, cell, args.seed, args.seconds, device)
        torch.cuda.empty_cache()
        facts = out["device"]
        idle = facts["window_s"] - facts["busy_s"]
        gaps = out["breakdown"]["idle_gaps"]
        by_span = program_breakdown(traced)
        result[cell] = {"correct": out["correct"], "metrics": out["metrics"], "device": facts,
                        "breakdown": out["breakdown"], "by_program_span": by_span,
                        "sync_spans": sum(h["name"].startswith(PREFIX + "sync.") for h in traced["host"])}
        print(f"{cell}: correct {out['correct']}, window {facts['window_s']:.4f} s, busy "
              f"{facts['busy_s']:.4f}, idle {idle:.4f}, {traced['units']} units", flush=True)
        print(f"  metrics {json.dumps({k: v['value'] for k, v in out['metrics'].items()})}", flush=True)
        print(f"  sync spans in the slice {result[cell]['sync_spans']}", flush=True)
        outside = sum(s for k, s in gaps if k.startswith(BENCHMARK_LABELS))
        print(f"  idle under a benchmark label in the breakdown {outside:.5f} s ({outside / idle:.3f})", flush=True)
        for k, s in gaps:
            print(f"  breakdown {s:.5f} s ({s / idle:.3f}) {k}", flush=True)
        for k, s in by_span["idle_gaps"]:
            print(f"  by span {s:.5f} s ({s / idle:.3f}) {k}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
