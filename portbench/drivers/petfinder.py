"""MMPFN's PetFinder image+text run, served as the paper evaluates it: the
closed loop of `closed_loop.Cell` (one client, each request every held-out
row in a fresh order) on PetFinder-shaped rows (`make_petfinder.py`), the
classifier fitted once with preprocessing off, its categorical columns
given and the pretraining limits ignored (``hpo/experiment._accuracy``),
checked against the plain reference with preprocessing off
(`reference/petfinder.py`). A traced slice also reads the device time
that each request launches inside the program's ``mmpfn.forward.mixer``
spans (`span_device.py`)."""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from portbench import make, make_petfinder, span_device, trace
from portbench.drivers import closed_loop
from portbench.reference.petfinder import PlainMembers


class Cell(closed_loop.Cell):
    def setup(self) -> None:
        t = time.perf_counter()
        data, est = self.config["data"], self.estimator
        X, img, y = make_petfinder.petfinder_like(self.seed, data)
        tr, te = make.held_out_split(len(y), data["test_share"], self.seed)
        self.train = (X[tr], img[tr], y[tr])
        self.test = (X[te], img[te])
        self.weights = make.make_weights(self.arch, self.seed, self.device)
        tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
        try:
            path = tmp / "model.npz"
            make.write_npz(path, self.weights, self.arch, self.seed)
            t = trace.phase("weights and data", t)
            from multimodalpfn_tpu_torch import MMPFNClassifier
            from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

            mix = self.arch["mixer"]
            self.clf = MMPFNClassifier(
                model_path=str(path), mixer_type=mix["mixer_type"], mgm_heads=mix["mgm_heads"],
                cap_heads=mix["cap_heads"], features_per_group=self.arch["features_per_group"],
                n_estimators=est["n_estimators"], softmax_temperature=est["softmax_temperature"],
                categorical_features_indices=est["categorical_features_indices"],
                ignore_pretraining_limits=est["ignore_pretraining_limits"],
                inference_config={"FINGERPRINT_FEATURE": False,
                                  "PREPROCESS_TRANSFORMS": [PreprocessorConfig(name="none")]},
                fit_mode=self.fit_mode, random_state=est["random_state"], device=str(self.device),
            )
            self.clf.fit(*self.train)
        finally:
            shutil.rmtree(tmp)
        t = trace.phase("import and fit", t)
        self.warm()
        trace.phase("warm requests", t)

    def reference(self) -> PlainMembers:
        if not hasattr(self, "members"):
            self.members = PlainMembers(self.train[0], self.train[2], self.estimator,
                                        self.estimator["categorical_features_indices"])
        return self.members

    def traced(self) -> dict:
        n = self.traffic["traced_requests"]
        reqs = [self.request(rows) for rows in self.next_rows(n)]

        def one(i):
            with torch.profiler.record_function(trace.REQUEST):
                return self.clf.predict_proba(*reqs[i])

        out = span_device.capture(one, n, self.device, (span_device.MIXER,))
        out["rows"] = [len(X) for X, _ in reqs]
        return out
