#!/usr/bin/env python3
"""Time and fingerprint the attention forward kernels K2a and K4 of one copy of
the PyTorch/CUDA port on the card, with `chip_smoke.py`'s phase-2 cases, so
that two trees (a commit and its parent) can be compared in one call.

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``:

    python3 tools/torch_attn_fwd.py [--package-root DIR] [--iters 10] [--out FILE]

``--package-root`` names the directory that holds the ``multimodalpfn_tpu_torch``
package to measure (default: this checkout), for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists; its
kernels are built into its own ``build/kernels``. The cases, bounds and
digests are this checkout's `chip_smoke.py`: K2a at the ``fit_preprocessors``
shape (its projection and attention apart, by profiler kernel name), K4 at
the KV-cache prime and predict shapes and at the flash fine-tune's train,
test and folded blocks, each in float32 and bf16 beside its plain version,
its bound and SDPA; then `chip_smoke.f32_fingerprints` (the CUDA-core bodies'
bits). Each case must pass `chip_smoke.py`'s error bounds.

The last line is a JSON object with the card, the package root, the build
time, the results and the fingerprints; ``--out`` writes it to a file too.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=ROOT)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

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
    dims = (4, 31, 2350, 1838, 192, 6, 32, 768, 512)
    results = smoke.phase_kernels(device, dims, args.iters, smoke.FT_DIMS, only=("K2a", "K4"))
    prints = smoke.f32_fingerprints(device)
    print(f"  CUDA-core outputs (sha256): {prints}", flush=True)
    line = json.dumps({"card": card, "package_root": str(pkg_root), "build_s": build_s,
                       "results": results, "fingerprints": prints})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
