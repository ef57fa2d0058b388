"""One client, closed loop: ``predict_proba`` on the held-out rows, each
request the whole held-out set in a fresh order drawn from the seed, the
next sent when the last is answered. The classifier is fitted once at
set-up (``fit_mode`` of the traffic file)."""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers.serving import ServedClassifier


class Cell(ServedClassifier):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.fit_mode = traffic["fit_mode"]
        self.orders = np.random.default_rng([int(seed), 3])

    def next_rows(self, n: int) -> list[np.ndarray]:
        return [self.orders.permutation(len(self.test[1])) for _ in range(n)]

    def warm(self) -> None:
        for rows in self.next_rows(self.traffic["warm_requests"]):
            self.clf.predict_proba(*self.request(rows))

    def window(self, seconds: float, traced: bool = False) -> dict:
        failed = 0
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            (rows,) = self.next_rows(1)
            X, img = self.request(rows)
            t = time.perf_counter()
            p = self.clf.predict_proba(X, img)
            end = time.perf_counter()
            self.latencies.append(end - t)
            failed += self.malformed(p, len(rows))
            self.answers.append((rows, p))
        return self.result(end - t0, failed)
