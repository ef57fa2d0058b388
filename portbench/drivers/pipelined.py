"""One client, closed loop over ``predict_proba_many``: batches of
``batch`` requests, at most ``max_in_flight`` of them dispatched and not yet
answered, against the K/V cache primed at fit (``fit_mode`` of the traffic
file). Each request's size is drawn uniformly from ``[min_rows, max_rows]``
and its rows from the held-out rows, from the seed: distinct rows in a
fresh order while the size allows, else with replacement. A request's
latency runs from its dispatch to its probabilities on the host. Set-up
warms every bucket of 128 rows the sizes reach."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import trace
from portbench.drivers.serving import ServedClassifier

BUCKET = 128  # the program's test-row bucket: request sizes share a shape within one


class Cell(ServedClassifier):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.fit_mode = traffic["fit_mode"]
        self.sizes = np.random.default_rng([int(seed), 4])

    def next_rows(self, n: int) -> list[np.ndarray]:
        lo, hi, pool = self.traffic["min_rows"], self.traffic["max_rows"], len(self.test[1])
        out = []
        for _ in range(n):
            size = int(self.sizes.integers(lo, hi + 1))
            out.append(self.sizes.permutation(pool)[:size] if size <= pool
                       else self.sizes.integers(0, pool, size=size))
        return out

    def warm(self) -> None:
        lo, hi = (max(BUCKET, -(-self.traffic[k] // BUCKET) * BUCKET) for k in ("min_rows", "max_rows"))
        tops = range(lo, hi + 1, BUCKET)
        rng = np.random.default_rng([self.seed, 5])
        reqs = [self.request(rng.integers(0, len(self.test[1]), size=n)) for n in tops
                for _ in range(self.traffic["max_in_flight"] + 1)]  # the buffers of a full pipeline
        self.clf.predict_proba_many([r[0] for r in reqs], [r[1] for r in reqs],
                                    max_in_flight=self.traffic["max_in_flight"])

    def traced(self) -> dict:
        """``traced_batches`` batches, each a traced unit; a request's span
        covers its dispatch."""
        size = self.traffic["batch"]
        reqs = [self.request(rows) for rows in self.next_rows(self.traffic["traced_batches"] * size)]
        dispatch = self.clf._dispatch_predict

        def spanned(X, img):
            with torch.profiler.record_function(trace.REQUEST):
                return dispatch(X, img)

        def one(i):
            batch = reqs[i * size:(i + 1) * size]
            return self.clf.predict_proba_many([r[0] for r in batch], [r[1] for r in batch],
                                               max_in_flight=self.traffic["max_in_flight"])

        self.clf._dispatch_predict = spanned
        try:
            out = trace.capture(one, self.traffic["traced_batches"], self.device)
        finally:
            del self.clf._dispatch_predict
        out["rows"] = [len(X) for X, _ in reqs]
        return out

    def window(self, seconds: float, traced: bool = False) -> dict:
        clf, dispatch, finalize = self.clf, self.clf._dispatch_predict, self.clf._finalize_predict
        failed = 0

        def timed_dispatch(X, img):
            return time.perf_counter(), dispatch(X, img)

        def timed_finalize(handle):
            t, h = handle
            p = finalize(h)
            self.latencies.append(time.perf_counter() - t)
            return p

        clf._dispatch_predict, clf._finalize_predict = timed_dispatch, timed_finalize
        try:
            t0 = time.perf_counter()
            end = t0
            while end - t0 < seconds:
                batch = self.next_rows(self.traffic["batch"])
                reqs = [self.request(rows) for rows in batch]
                ps = clf.predict_proba_many([r[0] for r in reqs], [r[1] for r in reqs],
                                            max_in_flight=self.traffic["max_in_flight"])
                end = time.perf_counter()
                for rows, p in zip(batch, ps):
                    failed += self.malformed(p, len(rows))
                    self.answers.append((rows, p))
        finally:
            del clf._dispatch_predict, clf._finalize_predict
        return self.result(end - t0, failed)
