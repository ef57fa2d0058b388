#!/usr/bin/env python3
"""The control readings of the cells whose drivers `control.py` does not
know: ``petfinder`` (PetFinder served with preprocessing off) and ``sweep``
(a batched fine-tune sweep). The same faults as there: ``fp8`` (the
reference with every product's operands in float8 e4m3, in the program's
place), ``half`` (half of the members; half of the episode's test rows in
the loss), ``altered`` (one answer, or one validation row, rolled by one
class); each compared with the float32 reference as a run compares the
program. A sweep's reading is its worst run's; each run's mixer is drawn
by `make.make_weights` at the run's head count from the run's seed.

    python3 portbench/controls.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench, make, make_petfinder  # noqa: E402
from portbench.drivers.finetune import compare  # noqa: E402
from portbench.reference import sweep, train  # noqa: E402
from portbench.reference.petfinder import PlainMembers  # noqa: E402


def petfinder_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
    est = {**config["estimator"], "random_state": seed % 2**31}
    X, img, y = make_petfinder.petfinder_like(seed, config["data"])
    tr, te = make.held_out_split(len(y), config["data"]["test_share"], seed)
    weights = make.make_weights(arch, seed, device)
    members = PlainMembers(X[tr], y[tr], est, est["categorical_features_indices"])
    args = (weights, arch, img[tr], X[te], img[te], device)
    want = members.predict_proba(*args)
    out = {"fp8": members.predict_proba(*args, precision="fp8")}
    fitted = members.fitted
    members.fitted = fitted[: len(fitted) // 2]
    out["half"] = members.predict_proba(*args)
    members.fitted = fitted
    altered = want.copy()
    altered[0] = np.roll(altered[0], 1)
    out["altered"] = altered
    return {k: {"prob_gap": float(np.abs(p - want).max())} for k, p in out.items()}


def sweep_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
    X, img, y = make.pad_ufes_like(seed, config["data"])
    base = make.make_weights(arch, seed, device)
    first = int(seed) % (2**31 - max(traffic["seeds"]))
    worst: dict[str, dict[str, float]] = {}
    for heads in traffic["mgm_heads"]:
        for s in (first + o for o in traffic["seeds"]):
            arch_r = {**arch, "mixer": {**arch["mixer"], "mgm_heads": heads}}
            weights = {k: v for k, v in base.items() if not k.startswith("mixer/")}
            weights.update({k: v for k, v in make.make_weights(arch_r, s, device).items()
                            if k.startswith("mixer/")})
            data = sweep.run_data(X, img, y, s)
            kw = dict(seed=s, lr=traffic["learning_rate"], n_steps=traffic["checked_steps"], device=device)
            want = sweep.fine_tune_steps(weights, arch_r, data, **kw)
            y_val = data["val"][2]
            out = {"fp8": compare(sweep.fine_tune_steps(weights, arch_r, data, precision="fp8", **kw),
                                  want, y_val)}
            loss_fn = train.loss_fn
            train.loss_fn = lambda logits, yy: loss_fn(logits[: len(yy) // 2], yy[: len(yy) // 2])
            try:
                out["half"] = compare(sweep.fine_tune_steps(weights, arch_r, data, **kw), want, y_val)
            finally:
                train.loss_fn = loss_fn
            altered = dict(want, val_logits=want["val_logits"].copy())
            altered["val_logits"][0] = np.roll(altered["val_logits"][0], max(1, arch["n_out"] // 10))
            out["altered"] = compare(altered, want, y_val)
            for fault, numbers in out.items():
                w = worst.setdefault(fault, {})
                for k, v in numbers.items():
                    w[k] = max(w.get(k, 0.0), v)
    return worst


READINGS = {"petfinder": petfinder_readings, "sweep": sweep_readings}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    wl = bench.entry(b["workloads"], args.workload, "workload")
    config = bench.load_json(bench.ROOT / bench.entry(b["configs"], wl["config"], "config")["file"])
    traffic = bench.load_json(bench.HERE / "traffic" / f"{wl['traffic']}.json")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t = time.perf_counter()
        r = READINGS[traffic["driver"]](config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
