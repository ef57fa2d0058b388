#!/usr/bin/env python3
"""The readings a cell's limits are set from, apart from the program's own
(which every run prints under ``checks``): the reference put in the
program's place in the precision below the configuration's (the control),
and the reference with each fault a cell can have, compared with the
float32 reference as a run compares the program.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed. The benchmark's runs never run this.

Faults: ``fp8`` (the control: every product's operands rounded to float8
e4m3); ``half`` (half of the batch left out and the mean taken over the
rest: half of the members for a served answer, half of the episode's test
rows for the loss); ``altered`` (one answer changed where it is made: one
row's probabilities, or validation logits, rolled by one class). A state
left unchanged reads 1 on ``change_gap`` by its definition and needs no run.
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

from portbench import bench, make  # noqa: E402
from portbench.drivers.finetune import compare  # noqa: E402
from portbench.reference import serve, train  # noqa: E402


def serving_readings(config: dict, seed: int, device) -> dict:
    arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
    X, img, y = make.pad_ufes_like(seed, config["data"])
    tr, te = make.held_out_split(len(y), config["data"]["test_share"], seed)
    weights = make.make_weights(arch, seed, device)
    members = serve.Members(X[tr], y[tr], {**config["estimator"], "random_state": seed % 2**31})
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


def finetune_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
    X, img, y = make.pad_ufes_like(seed, config["data"])
    rs = seed % 2**32
    data = dict(zip(("train", "val"), train.val_split(X, img, y, rs)))
    weights = make.make_weights(arch, seed, device)
    kw = dict(seed=rs, lr=traffic["learning_rate"], n_steps=traffic["checked_steps"], device=device)
    want = train.fine_tune_steps(weights, arch, data, **kw)
    y_val = data["val"][2]
    out = {"fp8": compare(train.fine_tune_steps(weights, arch, data, precision="fp8", **kw), want, y_val)}
    loss_fn = train.loss_fn
    train.loss_fn = lambda logits, yy: loss_fn(logits[: len(yy) // 2], yy[: len(yy) // 2])
    try:
        out["half"] = compare(train.fine_tune_steps(weights, arch, data, **kw), want, y_val)
    finally:
        train.loss_fn = loss_fn
    altered = dict(want, val_logits=want["val_logits"].copy())
    altered["val_logits"][0] = np.roll(altered["val_logits"][0], max(1, arch["n_out"] // 10))
    out["altered"] = compare(altered, want, y_val)
    return out


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
        if traffic["driver"] == "finetune":
            r = finetune_readings(config, traffic, seed, device)
        else:
            r = serving_readings(config, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
