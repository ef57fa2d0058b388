"""Binary classification with TabPFNClassifier (cf. reference
`models/mmpfn/examples/tabpfn_for_binary_classification.py`); the port of the
JAX package's example.

The card's machine has no scikit-learn, so the data is not scikit-learn's
breast-cancer set but a synthetic set of its shape (569 rows, 30 numeric
features, 2 classes) from `datasets/synthetic.py`; the split is the port's
copy of ``train_test_split(test_size=0.33, random_state=42)``
(`train/data.py`) and the scores its copies of ``roc_auc_score`` and
``accuracy_score`` (`train/metrics.py`)."""

from __future__ import annotations

from multimodalpfn_tpu_torch import TabPFNClassifier
from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
from multimodalpfn_tpu_torch.train.data import train_test_split_indices
from multimodalpfn_tpu_torch.train.metrics import accuracy, roc_auc


def main(model_path: str = "auto", device: str = "cuda") -> dict:
    X, y = toy_classification(n=569, n_features=30, n_classes=2, n_categorical=0, nan_share=0.0, seed=0)
    tr, te = train_test_split_indices(len(y), test_size=0.33, random_state=42)

    clf = TabPFNClassifier(model_path=model_path, device=device)
    clf.fit(X[tr], y[tr])
    proba = clf.predict_proba(X[te])
    out = {"roc_auc": roc_auc(y[te], proba[:, 1]), "accuracy": accuracy(y[te], proba)}
    print("ROC AUC:", out["roc_auc"])
    print("Accuracy:", out["accuracy"])
    return out


if __name__ == "__main__":
    main()
