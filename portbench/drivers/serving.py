"""What the served cells share: the classifier fitted on the seed's train
rows, its answers kept by request, and the check of every answer the window
produced against the reference's answer for the same held-out row."""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import make, trace
from portbench.reference.serve import Members


class ServedClassifier:
    """A `MMPFNClassifier` fitted at set-up; subclasses drive its requests."""

    fit_mode = "fit_preprocessors"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.arch = {**config["architecture"], "model_seed": make.model_seed(seed)}
        self.estimator = {**config["estimator"], "random_state": int(seed) % 2**31}
        self.answers: list[tuple[np.ndarray, np.ndarray]] = []  # (held-out rows, probabilities)
        self.latencies: list[float] = []

    def setup(self) -> None:
        t = time.perf_counter()
        X, img, y = make.pad_ufes_like(self.seed, self.config["data"])
        tr, te = make.held_out_split(len(y), self.config["data"]["test_share"], self.seed)
        self.train = (X[tr], img[tr], y[tr])
        self.test = (X[te], img[te])
        self.weights = make.make_weights(self.arch, self.seed, self.device)
        tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
        try:
            path = tmp / "model.npz"
            make.write_npz(path, self.weights, self.arch, self.seed)
            t = trace.phase("weights and data", t)
            from multimodalpfn_tpu_torch import MMPFNClassifier

            mix, est = self.arch["mixer"], self.estimator
            self.clf = MMPFNClassifier(
                model_path=str(path), mixer_type=mix["mixer_type"], mgm_heads=mix["mgm_heads"],
                cap_heads=mix["cap_heads"], features_per_group=self.arch["features_per_group"],
                n_estimators=est["n_estimators"], softmax_temperature=est["softmax_temperature"],
                fit_mode=self.fit_mode, random_state=est["random_state"], device=str(self.device),
            )
            self.clf.fit(*self.train)
        finally:
            shutil.rmtree(tmp)
        t = trace.phase("import and fit", t)
        self.warm()
        trace.phase("warm requests", t)

    def request(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        X_te, img_te = self.test
        return X_te[rows], img_te[rows]

    def malformed(self, p: np.ndarray, n: int) -> bool:
        return (p.shape != (n, self.clf.n_classes_) or not np.isfinite(p).all()
                or float(np.abs(p.sum(axis=1) - 1).max()) > 1e-6)

    def result(self, wall: float, failed: int) -> dict:
        rows = sum(len(r) for r, _ in self.answers)
        lat_ms = sorted(1e3 * t for t in self.latencies)
        prefix = self.traffic["metric_prefix"]  # the cell's own end-to-end metrics
        return {"metrics": {f"{prefix}_rows_per_s": rows / wall,
                            f"{prefix}_p95_ms": float(np.percentile(lat_ms, 95))},
                "attempted": len(self.latencies), "failed": failed, "wall_s": wall,
                "rows": [len(r) for r, _ in self.answers]}

    def traced(self) -> dict:
        n = self.traffic["traced_requests"]
        reqs = [self.request(rows) for rows in self.next_rows(n)]

        def one(i):
            with torch.profiler.record_function(trace.REQUEST):
                return self.clf.predict_proba(*reqs[i])

        out = trace.capture(one, n, self.device)
        out["rows"] = [len(X) for X, _ in reqs]
        return out

    def release(self) -> None:
        del self.clf

    def reference(self) -> Members:
        """The reference's ensemble, fitted on the train rows once."""
        if not hasattr(self, "members"):
            self.members = Members(self.train[0], self.train[2], self.estimator)
        return self.members

    def check(self) -> dict:
        p_ref = self.reference().predict_proba(self.weights, self.arch, self.train[1], *self.test,
                                               self.device)
        return {"prob_gap": max(float(np.abs(p - p_ref[rows]).max()) for rows, p in self.answers)}

    def shapes(self) -> dict:
        """The work of a request for `portbench/work/`: the members' widths
        as the reference's preprocessing makes them."""
        return {"members": self.reference().widths(), "image_tokens": self.config["data"]["image_tokens"],
                "train_rows": len(self.train[2]), "cached": self.fit_mode == "fit_with_cache"}
