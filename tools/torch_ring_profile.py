#!/usr/bin/env python3
"""Profile the port's ring attention on the card against the whole K/V:
`ring_attention` with ``use_flash`` (K4 a block and ring step, K11 in the
ring's backward) forward and backward, and K4 + K11 on the whole K/V, on
`chip_smoke.py` phase 25a's bf16 case (q, k, v (30, 6, 1654, 32): the
flash fine-tune's train block), over NCCL with one rank a card.

Run from the repository root on a machine with NVIDIA GPUs and ``nvcc``:

    python3 tools/torch_ring_profile.py [--iters 10] [--top 14]

Prints the card's name and power limit, then for the ring and for the whole
K/V the host-clock time a call (after three warm calls, ended by a
synchronize) and the device kernels that took the most time in
``torch.profiler`` over ``--iters`` calls (ms a call, launches a call).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def profile_rank(rank: int, world: int, iters: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import RING_DIMS
    from multimodalpfn_tpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from multimodalpfn_tpu_torch.parallel.mesh import make_mesh
    from multimodalpfn_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh()
    B, h, S, d = RING_DIMS
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn((B, h, S, d), generator=gen).cuda() for _ in range(4))
    q, k, v = (t.bfloat16().requires_grad_(True) for t in (q, k, v))
    q3, k3, v3, g3 = (t.detach().reshape(B * h, S, d).contiguous() for t in (q, k, v, g))

    def ring():
        for t in (q, k, v):
            t.grad = None
        ring_attention(q, k, v, mesh=mesh, use_flash=True).backward(g)

    @torch.no_grad()
    def whole():
        o, lse = flash_attention(q3, k3, v3)
        flash_attention_bwd(q3, k3, v3, o, lse, g3)

    out = {"ranks": world}
    for name, fn in (("ring", ring), ("whole", whole)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / iters / 1e3, e.count / iters, e.key)
                       for e in prof.key_averages() if e.device_time_total > 0), reverse=True)[:top]
        out[name] = {"host_ms": host_ms, "rows": rows}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing was run", file=sys.stderr)
        return 2
    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.parallel.launch import run_ranks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kernels.build()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        out = run_ranks(profile_rank, torch.cuda.device_count(), args.iters, args.top, workdir=work,
                        device="cuda", threads=None)[0]
    for name in ("ring", "whole"):
        r = out[name]
        print(f"{name} (a ring of {out['ranks']}): {r['host_ms']:.3f} ms a call (host clock)", flush=True)
        for ms, n, key in r["rows"]:
            print(f"  {ms:8.4f} ms  x{n:<4g} {key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
