"""Regression with TabPFNRegressor (cf. reference
`models/mmpfn/examples/tabpfn_for_regression.py`); the port of the JAX
package's example.

The card's machine has no scikit-learn, so the data is not scikit-learn's
diabetes set but a synthetic set of its shape (442 rows, 10 numeric
features) from `datasets/synthetic.py`; the split is the port's copy of
``train_test_split(test_size=0.33, random_state=42)`` (`train/data.py`) and
the scores its copies of ``mean_squared_error`` and ``r2_score``
(`train/metrics.py`)."""

from __future__ import annotations

from multimodalpfn_tpu_torch import TabPFNRegressor
from multimodalpfn_tpu_torch.datasets.synthetic import toy_regression
from multimodalpfn_tpu_torch.train.data import train_test_split_indices
from multimodalpfn_tpu_torch.train.metrics import mean_squared_error, r2_score


def main(model_path: str = "auto", device: str = "cuda") -> dict:
    X, y = toy_regression(n=442, n_features=10, nan_share=0.0, seed=0)
    tr, te = train_test_split_indices(len(y), test_size=0.33, random_state=42)

    reg = TabPFNRegressor(model_path=model_path, device=device)
    reg.fit(X[tr], y[tr])
    pred = reg.predict(X[te])
    out = {"mse": mean_squared_error(y[te], pred), "r2": r2_score(y[te], pred)}
    print("MSE:", out["mse"])
    print("R2:", out["r2"])

    full = reg.predict(X[te], output_type="main")
    print("median head:", full["median"][:5])
    out["median_head"] = [float(v) for v in full["median"][:5]]
    return out


if __name__ == "__main__":
    main()
