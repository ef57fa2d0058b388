"""Serving: fit once with the KV cache, then answer a request stream with
pipelined predicts; the port of the JAX package's
`examples/serving_pipelined_requests.py`.

`fit_mode="fit_with_cache"` is the reference's CacheKV serving engine
(`mmpfn/models/mmpfn/inference.py:354-513`), which serves requests strictly
sequentially. Here `predict_proba_many` overlaps the host-side work of
request N+1 (member transforms, embedding upload) with the card's work on
request N; its answers are bit-identical to sequential `predict_proba`
calls."""

from __future__ import annotations

import numpy as np

from multimodalpfn_tpu_torch import MMPFNClassifier
from multimodalpfn_tpu_torch.datasets.synthetic import toy_multimodal_classification


def main(model_path: str = "random:0", device: str = "cuda") -> dict:  # or the published / fine-tuned ckpt
    X, emb, y = toy_multimodal_classification(n=300, n_classes=3, emb_dim=768, seed=0)
    ntr = 200

    clf = MMPFNClassifier(
        model_path=model_path,
        mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8,
        fit_mode="fit_with_cache",  # prime per-member KV caches at fit time
        device=device,
    )
    clf.fit(X[:ntr], emb[:ntr], y[:ntr])

    # a stream of prediction requests (e.g. from a request queue)
    requests = [(X[ntr + i : ntr + i + 25], emb[ntr + i : ntr + i + 25]) for i in range(0, 100, 25)]

    probas = clf.predict_proba_many(
        [x for x, _ in requests],
        [e for _, e in requests],
        max_in_flight=2,  # bounds device buffers held by in-flight requests
    )
    for i, p in enumerate(probas):
        print(f"request {i}: {p.shape[0]} rows, mean max-proba {p.max(axis=1).mean():.3f}")

    # the regressor twin is MMPFNRegressor.predict_many(...); both are exactly
    # equal to the sequential loop
    sequential = [clf.predict_proba(x, e) for x, e in requests]
    equal = all(np.array_equal(a, b) for a, b in zip(probas, sequential))
    print("pipelined == sequential:", equal)
    return {
        "mean_max_proba": [float(p.max(axis=1).mean()) for p in probas],
        "pipelined_equals_sequential": equal,
        "probas": probas,
        "sequential": sequential,
    }


if __name__ == "__main__":
    main()
