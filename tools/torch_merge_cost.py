#!/usr/bin/env python3
"""Time merged and split member groups of the PyTorch/CUDA port on the card,
and fit the cross-width merge cost rule of
`multimodalpfn_tpu_torch/estimator/inference.py` to the timings.

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``:

    python3 tools/torch_merge_cost.py [--reps 5]

The model is the published 192×12 architecture with MGM+CAP 16/8 (random
weights from seed 0), served in bfloat16 on the kernel path. A timing is the
host clock around one warm `_group_and_run` call (member forwards and the
host sync of their logits; preprocessing excluded), the median of ``--reps``.

1. Merged against split at two points, interleaved merged, split, split,
   merged: the flagship (members of widths 39/39/22/22, 1838 train rows, 512
   test rows, 8 image tokens) and a short, near-equal one (widths 10/9, 60
   train rows, 16 test rows bucketed to 128).
2. Single groups of n members of one width at both sequence lengths; a least
   squares fit of ``T = overhead + n · flops(t) / rate`` over them gives the
   two constants, with which the rule's decision at both points is printed.

The last line is a JSON object with every timing and the fitted constants.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

POINTS = {  # name: (member widths, train rows, test rows)
    "flagship": ([39, 39, 22, 22], 1838, 512),
    "short": ([10, 9], 60, 16),
}
GRID = {  # train rows, test rows: [(members, width)]
    (1838, 512): [(1, 22), (2, 22), (4, 22), (1, 39), (2, 39), (4, 39)],
    (60, 16): [(1, 9), (2, 9), (1, 10), (2, 10)],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing was run", file=sys.stderr)
        return 2
    from types import SimpleNamespace

    import multimodalpfn_tpu_torch.estimator.inference as inf
    from multimodalpfn_tpu_torch.models.loading import load_model
    from multimodalpfn_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    device = torch.device("cuda")
    loaded = load_model("random:0", mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8,
                        device=device)
    params, cfg = loaded.params, loaded.config
    rng = np.random.default_rng(0)

    def members(widths, sep, n_test):
        X = rng.normal(size=(sep + n_test, max(widths))).astype(np.float32)
        y = rng.integers(0, 10, size=sep).astype(np.float32)
        ms = [inf._Member(config=None, X_train=X[:sep, :w], y_train=y, cat_ix=None,
                          preprocessor=SimpleNamespace(
                              transform=lambda X, w=w: SimpleNamespace(X=X[:, :w])))
              for w in widths]
        img = rng.normal(size=(sep + n_test, 1, 768)).astype(np.float32)
        return ms, X[sep:], torch.from_numpy(img[:sep]).to(device), img[sep:]

    def timed(ms, X_test, img_tr, img_te, force) -> float:
        inf._FORCE_MERGE = force
        run = lambda: inf._group_and_run(params, cfg, ms, X_test, img_tr, img_te,  # noqa: E731
                                         autocast=True, device=device)
        run(), run()  # warm: every shape seen
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    result = {"card": card, "points": {}, "grid": []}
    for name, (widths, sep, n_test) in POINTS.items():
        data = members(widths, sep, n_test)
        ms = {"merged": [], "split": []}
        for force in (True, False, False, True):
            ms["merged" if force else "split"].append(timed(*data, force))
        row = {k: float(np.mean(v)) for k, v in ms.items()} | {"widths": widths, "sep": sep,
                                                               "n_test": n_test, "runs": ms}
        result["points"][name] = row
        print(f"  {name}: widths {widths}, sep {sep}, {n_test} test rows: merged "
              f"{row['merged']:.3f} ms, split {row['split']:.3f} ms ({ms})", flush=True)

    n_img = 8
    fl, ts = [], []
    for (sep, n_test), cells in GRID.items():
        n_rows = inf._bucket_test_rows(n_test)
        for n, w in cells:
            ms_ = timed(*members([w] * n, sep, n_test), None)
            flops = n * inf._member_forward_flops(w + n_img + 1, sep, n_rows, cfg.emsize, cfg.nhid,
                                                  cfg.nlayers)
            fl.append(flops)
            ts.append(ms_)
            result["grid"].append({"members": n, "width": w, "sep": sep, "n_test": n_test,
                                   "ms": ms_, "flops": flops})
            print(f"  group of {n} x width {w}, sep {sep}: {ms_:.3f} ms, "
                  f"{flops / ms_ / 1e9:.1f} TFLOP/s", flush=True)
    slope, overhead = np.polyfit(np.asarray(fl), np.asarray(ts), 1)
    rate = 1.0 / (slope * 1e9)
    result["fit"] = {"group_overhead_ms": float(overhead), "eff_tflops": float(rate)}
    print(f"  fit: T = {overhead:.3f} ms + n*flops / {rate:.2f} TFLOP/s", flush=True)

    inf._GROUP_OVERHEAD_MS, inf._EFF_TFLOPS, inf._FORCE_MERGE = float(overhead), float(rate), None
    for name, (widths, sep, n_test) in POINTS.items():
        groups = {}
        for i, w in enumerate(widths):
            groups.setdefault((w, sep), []).append(i)
        plans = inf._plan_groups(groups, cfg, n_img, inf._bucket_test_rows(n_test))
        choice = "merge" if len(plans) == 1 else "split"
        measured = min(("merged", "split"), key=lambda k: result["points"][name][k])
        result["points"][name]["rule_with_fit"] = choice
        print(f"  {name}: the fitted rule chooses {choice}; measured faster: {measured}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
