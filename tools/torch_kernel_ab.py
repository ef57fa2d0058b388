#!/usr/bin/env python3
"""Time and fingerprint kernels of one copy of the PyTorch/CUDA port on the
card with `chip_smoke.py`'s cases, so that two trees (a commit and its
parent) can be compared in one call.

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``:

    python3 tools/torch_kernel_ab.py [--package-root DIR] [--only K1,K5,K6a,K6b]
                                     [--tile] [--iters 10] [--out FILE]

``--package-root`` names the directory that holds the ``multimodalpfn_tpu_torch``
package to measure (default: this checkout), for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists; its
kernels are built into its own ``build/kernels``. The cases, bounds and
digests are this checkout's `chip_smoke.py`. ``--only`` names the kernels:
forward ids run phase 2's cases (`chip_smoke.phase_kernels`, every case
whose id starts with one of them: K1 at the ``fit_preprocessors`` shape, at
48 tokens and at the fine-tune episode, K5 at the KV-cache prime shape and
at 48 tokens, K6a at 48 tokens, K6b at the merged prime and predict shapes,
each beside ``torch.matmul`` on its QKV and out projections; K2a and K2b
at the ``fit_preprocessors`` shape and at the fine-tune episode, K2a's
projection and attention apart, each beside ``torch.matmul`` on its
projection or out-product; K3 at
the ``fit_preprocessors``, KV-cache prime and predict and fine-tune episode
shapes beside ``torch.matmul`` on its two products, K4 at the KV-cache
prime and predict shapes and at the flash fine-tune's three blocks),
backward ids (K7, K7s, K8, K9, K10, K11) phase 8's at the fine-tune
shape (`chip_smoke.phase_bwd_kernels`: for K7, K7s, K8 and K10 each launch
of the sequence by profiler name beside ``torch.matmul`` on operands of its
shapes and its bytes bound, K7's and K7s' per-row attention launches also
beside SDPA and its backward; K8 and K10 also their row pass's further
cases, `K8_CASES` and `K10_CASES`); each in float32 and bf16 beside its plain version and
bound, and each must pass `chip_smoke.py`'s error bounds. ``--tile`` adds,
where the tree has it, the bf16 product tile alone (`kernels.gemm_bf16`,
float32 out, weight gradients in chunks of `kernels.WGRAD_ROWS`) on each of
K7's, K8's and K10's products beside ``torch.matmul``. Then
`chip_smoke.f32_fingerprints` (the CUDA-core bodies' bits).

The last line is a JSON object with the card, the package root, the build
time, the results, the tile times and the fingerprints; ``--out`` writes it
to a file too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BWD_IDS = ("K7", "K7s", "K8", "K9", "K10", "K11")


def tile_alone(smoke, kernels, device, iters) -> dict:
    """Each product of K7's, K8's and K10's sequences through `kernels.gemm_bf16`
    on random bf16 operands of its shapes, beside ``torch.matmul``."""
    import torch

    tile = {}
    for kid, seq in smoke.bwd_products(smoke.FT_DIMS).items():
        mm = smoke.matmul_ms(seq, device, iters)
        for ln in seq["launches"]:
            if "M" not in ln:
                continue
            M, N, K, a_t, b_t = (ln[k] for k in ("M", "N", "K", "a_t", "b_t"))
            a = torch.randn((K, M) if a_t else (M, K), device=device).to(torch.bfloat16)
            b = torch.randn((N, K) if b_t else (K, N), device=device).to(torch.bfloat16)
            chunk = kernels.WGRAD_ROWS if a_t else 0
            ms = smoke.timed(lambda: kernels.gemm_bf16(a, b, a_t, b_t, chunk), device, iters)
            tile[f"{kid} {ln['name']}"] = {"tile_ms": ms, "matmul_ms": mm[ln["name"]]}
            print(f"  tile alone {kid} {ln['name']} {M}x{N}x{K}: {ms:.4f} ms, "
                  f"torch.matmul {mm[ln['name']]:.4f} ms", flush=True)
    return tile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=ROOT)
    ap.add_argument("--only", default="K2a,K2b,K3,K4,K7,K8,K9,K10",
                    help="comma-separated kernel ids (default: %(default)s)")
    ap.add_argument("--tile", action="store_true",
                    help="also time the bf16 product tile alone on K7's, K8's and K10's products")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    only = [k for k in args.only.split(",") if k]
    bwd = tuple(k for k in only if k in BWD_IDS)
    fwd = tuple(k for k in only if k not in BWD_IDS)

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing was run", file=sys.stderr)
        return 2
    pkg_root = args.package_root.resolve()
    sys.path.insert(0, str(pkg_root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from multimodalpfn_tpu_torch.ops import kernels

    if not kernels.CSRC.is_relative_to(pkg_root):
        print(f"the package was imported from {kernels.CSRC}, not {pkg_root}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; package {pkg_root}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    device = torch.device("cuda")
    results = {}
    if fwd:
        dims = (4, 31, 2350, 1838, 192, 6, 32, 768, 512)
        results |= smoke.phase_kernels(device, dims, args.iters, smoke.FT_DIMS, only=fwd)
    if bwd:
        results |= smoke.phase_bwd_kernels(device, smoke.FT_DIMS, args.iters, only=bwd)
    tile = {}
    if args.tile and hasattr(kernels, "gemm_bf16"):
        tile = tile_alone(smoke, kernels, device, args.iters)
    prints = smoke.f32_fingerprints(device)
    print(f"  CUDA-core outputs (sha256): {prints}", flush=True)
    line = json.dumps({"card": card, "package_root": str(pkg_root), "build_s": build_s,
                       "results": results, "tile": tile, "fingerprints": prints})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
